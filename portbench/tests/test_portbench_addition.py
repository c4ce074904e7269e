"""A new configuration rehearsed as data, as the pull request that adds one
makes it: in a copy of the checkout, its configuration file, a stand-in
reference module, one cell on ``offline-b128``, and the cell appended to
the ``workloads`` lists of the metrics the offline cells report. Every rule
of ``test_portbench_manifest.py`` holds on the extended document, whether
the network's heads are yolo heads or a region; each rule refuses the
addition it is there to refuse."""

import copy
import json
import shutil
from pathlib import Path

import pytest

import test_portbench_manifest as rules
from portbench import netcfg

DATA = Path(__file__).resolve().parent / "data"
CONFIGS = rules.ROOT / rules.HARNESS / "configs"
# the cell whose metrics a new offline cell reports too
OFFLINE = "yolov2-416-int16.offline-b128"
STAND_IN = "stand_in"
STAND_IN_SOURCE = '''"""A stand-in for a configuration's plain reference."""


class Reference:
    def __init__(self, config, weights, calib, tier, device):
        raise NotImplementedError
'''


def configuration(name: str) -> dict:
    """The configuration file of a rehearsed addition: yolov2-416-int16's
    settings with the named network's layers and size, or the tiny yolo
    fixture's, each under its family's paper."""
    base = json.loads((CONFIGS / "yolov2-416-int16.json").read_text())
    yolov3 = "https://arxiv.org/abs/1804.02767"
    if name == "tiny-v3-64-int16":
        config = json.loads((DATA / "configs" / f"{name}.json").read_text())
        config["source"] = yolov3
    elif name == "yolov3-416-int16":
        net = json.loads((DATA / "nets" / "yolov3-416.json").read_text())
        config = dict(base, source=yolov3, net=net["net"],
                      layers=net["layers"])
    elif name == "yolov2-608-int16":
        config = dict(base, net=dict(base["net"], width=608, height=608))
    elif name == "yolov2-tiny-416-int16":
        from yolotpu_torch.models import zoo
        config = dict(base, layers=[
            dict(opts, type=kind)
            for kind, opts in zoo.MODELS["yolov2-tiny"]["layers"]])
    elif name == "yolov2-narrow-416-int16":
        # yolov2 with its first 1x1 conv cut from 64 filters to 32: a
        # region network that no zoo network is
        layers = copy.deepcopy(base["layers"])
        assert layers[5]["filters"] == "64" and layers[5]["size"] == "1"
        layers[5]["filters"] = "32"
        config = dict(base, layers=layers)
    else:
        raise KeyError(name)
    return dict(config, name=name, reference=STAND_IN, control="int8")


def add(root: Path, doc: dict, config: dict) -> str:
    """Extend the checkout at ``root`` and its document by the
    configuration and its cell on ``offline-b128``; the cell's name."""
    name = config["name"]
    path = f"{rules.HARNESS}/configs/{name}.json"
    (root / path).write_text(json.dumps(config, indent=1))
    (root / rules.HARNESS / "references" / f"{config['reference']}.py"
     ).write_text(STAND_IN_SOURCE)
    doc["configs"].append({"name": name, "source": config["source"],
                           "file": path, "reduced": [],
                           "why": f"{name}, added as data"})
    cell = f"{name}.offline-b128"
    doc["workloads"].append({"name": cell, "config": name,
                             "traffic": "offline-b128", "chips": 1,
                             "why": "offline batches of 128 frames"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if OFFLINE in m.get("workloads", ()):
            m["workloads"].append(cell)
    write(root, doc)
    return cell


def write(root: Path, doc: dict):
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1) + "\n")


def every_rule(doc: dict, root: Path):
    rules.rule_top_level(doc, root)
    for name in rules.names(doc):
        rules.rule_name(name)
    rules.rule_unique_names(doc)
    for metric in doc["end_to_end"] + doc["per_layer"]:
        rules.rule_metric(doc, root, metric)
    rules.rule_every_cell_reports(doc, root)
    for cell in doc["workloads"]:
        rules.rule_cell(doc, root, cell)
    rules.rule_configs(doc)
    rules.rule_region_configs_are_zoo_networks(doc, root)


@pytest.fixture
def checkout(tmp_path):
    """A copy of the checkout's benchmark, without its tests."""
    shutil.copytree(rules.ROOT / rules.HARNESS, tmp_path / rules.HARNESS,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    write(tmp_path, rules.DOC)
    return tmp_path


def test_the_checkout_copy_passes_every_rule(checkout):
    every_rule(copy.deepcopy(rules.DOC), checkout)


@pytest.mark.parametrize("name", ("tiny-v3-64-int16", "yolov3-416-int16",
                                  "yolov2-608-int16",
                                  "yolov2-tiny-416-int16"))
def test_an_addition_passes_every_rule(checkout, name):
    """Yolo heads (two at 64x64, YOLOv3's three at 416x416) or another
    region network of the zoo, or yolov2 at another size: the addition
    passes as data, and its cell reports what the offline cells report."""
    doc = copy.deepcopy(rules.DOC)
    config = configuration(name)
    cell = add(checkout, doc, config)
    every_rule(doc, checkout)
    kinds = {h.kind for h in netcfg.heads(netcfg.layers_of(config))}
    assert kinds == ({"region"} if name.startswith("yolov2") else {"yolo"})
    m = rules.harness(doc, checkout)
    for traced in (False, True):
        assert m.metrics(m.cell(cell), traced) == m.metrics(m.cell(OFFLINE),
                                                            traced)


def test_a_region_network_in_no_zoo_fails(checkout):
    doc = copy.deepcopy(rules.DOC)
    cell = add(checkout, doc, configuration("yolov2-narrow-416-int16"))
    rules.rule_cell(doc, checkout, rules.harness(doc, checkout).cell(cell))
    with pytest.raises(AssertionError, match="yolov2-narrow-416-int16"):
        rules.rule_region_configs_are_zoo_networks(doc, checkout)


def test_a_missing_reference_module_fails(checkout):
    doc = copy.deepcopy(rules.DOC)
    cell = add(checkout, doc, configuration("tiny-v3-64-int16"))
    (checkout / rules.HARNESS / "references" / f"{STAND_IN}.py").unlink()
    for other in rules.DOC["workloads"]:
        rules.rule_cell(doc, checkout, other)
    with pytest.raises(AssertionError, match=STAND_IN):
        rules.rule_cell(doc, checkout, rules.harness(doc, checkout).cell(cell))


def test_a_cell_left_off_fps_fails(checkout):
    doc = copy.deepcopy(rules.DOC)
    cell = add(checkout, doc, configuration("tiny-v3-64-int16"))
    fps = next(m for m in doc["end_to_end"] if m["name"] == "fps")
    fps["workloads"].remove(cell)
    write(checkout, doc)
    with pytest.raises(AssertionError, match=cell):
        rules.rule_every_cell_reports(doc, checkout)
