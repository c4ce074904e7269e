"""BENCHMARK.json against the benchmark's rules, and discovery by name: each
cell's configuration and traffic, each metric's reader.

The rules hold for every family of darknet detectors the harness reads, so
a new configuration comes as files and entries alone:

- its configuration, ``portbench/configs/<config>.json``, and its entry in
  ``configs``;
- its reference module, ``portbench/references/<module>.py``, which the
  configuration names by ``reference``;
- its cell, an entry in ``workloads``;
- its metrics' reader files, ``portbench/metrics/<metric>.py``, with their
  entries;
- its cell's name appended to the ``workloads`` lists of the metrics it
  reports.

Each rule (``rule_*``) is a function of a document and the root of its
checkout, not of this module's globals: ``test_portbench_addition.py`` holds
a copy of the document, extended as such an addition would extend it, to
the same rules. A configuration with a region head is one of the port's zoo
networks at the configuration's own size; one with yolo heads is not, and
its own tests hold it to its published layers.
"""

import json
import re
from pathlib import Path

import pytest

from portbench import loops, manifest, netcfg, traffic

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
HARNESS = "portbench"
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
LINE = re.compile(r"[^\n\t]{1,200}")
PAGE_LAYERS = ("engine", "model step", "kernels", "glue", "device")
# what a configuration's control may name: the port's tiers, and int4, the
# control below int8
TIER_NAMES = ("fp32", "int16", "w8a16", "int8", "int4")


def harness(doc: dict, root: Path) -> manifest.Manifest:
    """The document as a run reads it, from ``root/BENCHMARK.json``."""
    m = manifest.Manifest(root / "BENCHMARK.json")
    assert m.doc == doc
    return m


def names(doc: dict):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in doc[group]:
            yield e["name"]
    for w in doc["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in doc["configs"]:
        yield from c["reduced"]


def rule_top_level(doc: dict, root: Path):
    assert set(doc) == KEYS
    assert 1 <= len(doc["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in doc["command"])
    assert not any(w.startswith("/") or ".." in w for w in doc["command"])
    for p in doc["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch") and (root / p).is_dir()
    assert 1 <= doc["run_seconds"] <= 51 and isinstance(doc["run_seconds"],
                                                        int)
    assert len(json.dumps(doc)) <= 64 * 1024


def rule_name(name: str):
    assert manifest.NAME.fullmatch(name), name


def rule_unique_names(doc: dict):
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in doc[group]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(metrics) == len(set(metrics))


def rule_metric(doc: dict, root: Path, metric: dict):
    m = harness(doc, root)
    assert manifest.UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = metric.get("workloads", list(m.cells))
    assert cells and set(cells) <= set(m.cells)
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["layer"] in PAGE_LAYERS
        moved = next(e for e in doc["end_to_end"]
                     if e["name"] == metric["moves"])
        assert set(cells) <= set(moved.get("workloads", m.cells))
    # discovery: the metric's reader is found by its name
    assert callable(manifest.reader(metric["name"], root / HARNESS))


def rule_every_cell_reports(doc: dict, root: Path):
    """Each cell reports ``setup_s``, another end-to-end metric and a
    per-layer one."""
    m = harness(doc, root)
    for cell in m.cells.values():
        e2e = {e["name"] for e in m.metrics(cell, traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        assert m.metrics(cell, traced=True), cell["name"]


def rule_cell(doc: dict, root: Path, cell: dict):
    """The cell finds its configuration, whose network has detection heads
    the harness reads and whose reference module and control exist, and
    its traffic mix."""
    m = harness(doc, root)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and LINE.fullmatch(cell["why"])
    entry = m.configs[cell["config"]]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith(f"{HARNESS}/configs/")
    config = m.config(cell)
    assert config["name"] == cell["config"]
    assert netcfg.heads(netcfg.layers_of(config))
    ref = config["reference"]
    assert ref.isidentifier(), ref
    assert (root / HARNESS / "references" / f"{ref}.py").is_file(), ref
    assert config["control"] in TIER_NAMES, config["control"]
    mix = traffic.load(cell["traffic"], root=root / HARNESS)
    assert isinstance(mix, traffic.Traffic) and mix.name == cell["traffic"]
    assert mix.pool_frames % mix.batch == 0


def rule_configs(doc: dict):
    """Each configuration is used by a cell, has a file of its own and is
    unreduced."""
    used = {w["config"] for w in doc["workloads"]}
    assert used == {c["name"] for c in doc["configs"]}
    files = [c["file"] for c in doc["configs"]]
    assert len(files) == len(set(files))
    for c in doc["configs"]:
        assert c["reduced"] == [] and LINE.fullmatch(c["source"])


def in_zoo(config: dict) -> bool:
    """Whether a network of the port's zoo, built at the configuration's
    own size, has its layers' output shapes, layer for layer."""
    from yolotpu_torch.models import zoo
    net = config["net"]
    mine = [(l.out_h, l.out_w, l.out_c) for l in netcfg.layers_of(config)]
    return any(mine == [(l.out_h, l.out_w, l.out_c)
                        for l in zoo.build(name, width=int(net["width"]),
                                           height=int(net["height"])).layers]
               for name in zoo.MODELS)


def rule_region_configs_are_zoo_networks(doc: dict, root: Path):
    """Each configuration with a region head is a network of the port's
    zoo at its own size, so the port's engine serves it as it is; those
    with yolo heads are not held to the zoo."""
    m = harness(doc, root)
    for name in m.configs:
        config = m.config({"config": name})
        if netcfg.heads(netcfg.layers_of(config))[0].kind == "region":
            assert in_zoo(config), f"{name}: in no zoo network"


def test_top_level_keys_and_command():
    rule_top_level(DOC, ROOT)


@pytest.mark.parametrize("name", sorted(set(names(DOC))))
def test_names_use_allowed_characters(name):
    rule_name(name)


def test_names_are_unique():
    rule_unique_names(DOC)


@pytest.mark.parametrize("metric", DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    rule_metric(DOC, ROOT, metric)


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    rule_every_cell_reports(DOC, ROOT)


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_config_and_traffic(cell):
    rule_cell(DOC, ROOT, cell)


def test_configs_each_used_and_unreduced():
    rule_configs(DOC)


def test_the_config_is_the_ports_yolov2():
    """Every configuration with a region head is a network of the port's
    yolov2 family, as its zoo builds it at the configuration's size: the
    same layers and shapes, so the port's engine and its plan apply."""
    rule_region_configs_are_zoo_networks(DOC, ROOT)


def test_reader_falls_back_to_the_metric_family():
    assert manifest.reader("h2d_ms.offline").__module__ == \
        "portbench.metrics.h2d_ms"
    with pytest.raises(FileNotFoundError):
        manifest.reader("no_such_metric.offline")


def test_traffic_files_load():
    for path in (ROOT / "portbench" / "traffic").glob("*.json"):
        mix = traffic.load(path.stem)
        assert callable(loops.load(mix.loop).window) and mix.choices >= 1
        assert mix.cpus is None or mix.cpus >= 1


def test_loops_found_by_name():
    """A mix's arrival process is the file its ``loop`` names; its further
    keys are the loop's parameters."""
    assert loops.load("closed").__name__ == "portbench.loops.closed"
    mix = traffic.load("tiny-camera-open",
                       root=ROOT / "portbench" / "tests" / "data")
    assert mix.loop == "open" and mix.params == {"rate_per_s": 20.0}
    assert mix.raw and mix.cpus is None
    with pytest.raises(FileNotFoundError):
        loops.load("no_such_loop")
