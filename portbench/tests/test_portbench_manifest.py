"""BENCHMARK.json against the benchmark's rules, and discovery by name: each
cell's configuration and traffic, each metric's reader."""

import json
import re
from pathlib import Path

import pytest

from portbench import loops, manifest, netcfg, traffic

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
M = manifest.Manifest(ROOT / "BENCHMARK.json")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
LINE = re.compile(r"[^\n\t]{1,200}")
PAGE_LAYERS = ("engine", "model step", "kernels", "glue", "device")


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in DOC[group]:
            yield e["name"]
    for w in DOC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in DOC["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_command():
    assert set(DOC) == KEYS
    assert 1 <= len(DOC["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in DOC["command"])
    assert not any(w.startswith("/") or ".." in w for w in DOC["command"])
    for p in DOC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"],
                                                        int)
    assert len(json.dumps(DOC)) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_use_allowed_characters(name):
    assert manifest.NAME.fullmatch(name), name


def test_names_are_unique():
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in DOC[group]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert manifest.UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = metric.get("workloads", list(M.cells))
    assert cells and set(cells) <= set(M.cells)
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["layer"] in PAGE_LAYERS
        moved = next(m for m in DOC["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(cells) <= set(moved.get("workloads", M.cells))
    # discovery: the metric's reader is found by its name
    assert callable(manifest.reader(metric["name"]))


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for cell in M.cells.values():
        e2e = {m["name"] for m in M.metrics(cell, traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert M.metrics(cell, traced=True)


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_config_and_traffic(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and LINE.fullmatch(cell["why"])
    entry = M.configs[cell["config"]]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("portbench/configs/")
    config = M.config(cell)
    assert config["name"] == cell["config"]
    layers = netcfg.layers_of(config)
    assert netcfg.region(layers).kind == "region"
    mix = M.traffic(cell)
    assert isinstance(mix, traffic.Traffic) and mix.name == cell["traffic"]
    assert mix.pool_frames % mix.batch == 0


def test_configs_each_used_and_unreduced():
    used = {w["config"] for w in DOC["workloads"]}
    assert used == set(M.configs)
    files = [c["file"] for c in DOC["configs"]]
    assert len(files) == len(set(files))
    for c in DOC["configs"]:
        assert c["reduced"] == [] and LINE.fullmatch(c["source"])


def test_the_config_is_the_ports_yolov2():
    """The configurations' network is darknet's yolov2 at 416, as the
    port's zoo describes it: the same layers and shapes, so the card's
    engine plan applies."""
    from yolotpu_torch.models import zoo
    spec = zoo.build("yolov2")
    for name in M.configs:
        layers = netcfg.layers_of(M.config({"config": name}))
        assert len(layers) == len(spec.layers)
        for mine, theirs in zip(layers, spec.layers):
            assert (mine.out_h, mine.out_w, mine.out_c) == (
                theirs.out_h, theirs.out_w, theirs.out_c)


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
