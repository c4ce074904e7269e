"""The CPU rehearsal: a small darknet cfg at 64x64 through the same
set-up, window loop and comparison as a run on the card (the port's plain
versions stand in for its kernels here); the reference against the port's
own heads; the check failing the control and the faults a cell can have."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import system, traffic
from portbench.cell import run_cell
from portbench.control import control_numbers
from portbench.netcfg import heads, layers_of
from portbench.references.darknet_int import (IntNet, decode, detections,
                                              letterbox, to_unit)
from portbench.synth import make_inputs

DATA = Path(__file__).resolve().parent / "data"
METRICS = [{"name": "fps", "unit": "frames/s"},
           {"name": "latency_p50_ms", "unit": "ms"},
           {"name": "setup_s", "unit": "s"}]
TIERS = ("int16", "int8")
MIXES = ("tiny-offline", "tiny-camera")


def config(tier: str) -> dict:
    return json.loads((DATA / "configs" / f"tiny-64-{tier}.json").read_text())


def mix(name: str) -> traffic.Traffic:
    return traffic.load(name, root=DATA)


# any seeds: the head is fitted to the configuration's detections a frame
SEEDS = (1, 3, 7)


def run(tier, mix_name, seed=SEEDS[0], trace=False, build=system.build):
    return run_cell(config(tier), mix(mix_name), METRICS, seed, 3.0, trace,
                    "cpu", time.perf_counter(), build=build)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("mix_name", MIXES)
def test_rehearsal_is_correct(tier, mix_name):
    result, checks = run(tier, mix_name)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in METRICS}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert checks == {"unmatched": {"value": 0, "limit": 1}}


def test_open_loop_rehearsal_is_correct():
    """Seeded Poisson arrivals through the same window and check: the
    latencies run from each request's arrival."""
    result, checks = run("int16", "tiny-camera-open")
    assert result["correct"] is True and result["failed"] == 0
    assert 1 <= result["attempted"] <= 3.0 * 20 * 2
    assert checks["unmatched"]["value"] == 0


@pytest.mark.parametrize("raw", (False, True))
def test_inputs_hold_the_fitted_detections(raw):
    """The head is fitted so that the pool's first frames hold the
    configuration's detections a frame, whatever the seed."""
    cfg = config("int16")
    layers = layers_of(cfg)
    shape = (8, 48, 64, 3) if raw else (8, 64, 64, 3)
    e, w = cfg["engine"], cfg["weights"]
    for seed in (2, 2**31 + 5):
        inputs = make_inputs(layers, w, e, shape, raw, seed,
                             torch.device("cpu"))
        net = IntNet(layers, inputs.weights, inputs.calib, "int16",
                     torch.device("cpu"))
        x = torch.from_numpy(inputs.pool[:w["fit_frames"]])
        head = net.head_of(letterbox(x, 64, 64) if raw else to_unit(x))
        boxes, obj, probs = (t.numpy() for t in decode(head, heads(layers)[0]))
        n = [len(detections(boxes[f], obj[f], probs[f], e["thresh"],
                            e["nms"], e["topk"])[1])
             for f in range(len(boxes))]
        assert abs(np.mean(n) - w["detections_per_frame"]) <= 1.5, n


def test_traced_rehearsal_reads_no_device():
    result, _ = run("int16", "tiny-offline", trace=True)
    assert result["correct"] is True
    assert "busy_s" in result["device"] and "breakdown" not in result


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("raw", (False, True))
def test_reference_head_equals_the_ports(tier, raw):
    """The reference's integer walk, from the fp32 weights, the calibration
    image and the frames alone, gives the port's head bit for bit."""
    cfg = config(tier)
    layers = layers_of(cfg)
    shape = (3, 48, 64, 3) if raw else (3, 64, 64, 3)
    inputs = make_inputs(layers, cfg["weights"], cfg["engine"], shape, raw,
                         SEEDS[1], torch.device("cpu"))
    engine = system.build(cfg, inputs.weights, inputs.calib, "cpu")
    x = torch.from_numpy(inputs.pool)
    port = engine._forward(x, letterbox=raw)["head"].double().numpy()
    net = IntNet(layers, inputs.weights, inputs.calib, tier,
                 torch.device("cpu"))
    frames = letterbox(x, 64, 64) if raw else to_unit(x)
    mine = net.head_of(frames).numpy()
    assert np.array_equal(port, mine)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("mix_name", MIXES)
def test_control_is_not_correct(tier, mix_name):
    """The reference in the tier below, put in the system's place, fails
    the check on every seed."""
    cfg = config(tier)
    limits = cfg["check"]["limits"]
    for seed in SEEDS:
        n = control_numbers(cfg, mix(mix_name), seed, "cpu")
        assert n["detections"] > 0
        assert any(n[k] > lim for k, lim in limits.items()), n


class Broken:
    """The engine with its timed path broken underneath: its tables
    altered where they are produced."""

    def __init__(self, engine, fault):
        self.engine, self.fault = engine, fault

    def _broken(self, tables):
        boxes, scores, classes, valid = (t.copy() for t in tables)
        if self.fault == "half_the_batch":
            valid[len(valid) // 2:] = False
        elif self.fault == "one_box":
            f, k = np.argwhere(valid)[0]
            boxes[f, k, 0] += 0.01
        elif self.fault == "one_class":
            f, k = np.argwhere(valid)[0]
            classes[f, k] = (classes[f, k] + 1) % 80
        elif self.fault == "one_score":
            f, k = np.argwhere(valid)[0]
            scores[f, k] += 0.01
        return boxes, scores, classes, valid

    def predict_batch_detections(self, frames):
        return self._broken(self.engine.predict_batch_detections(frames))

    def predict_batch_raw_frames(self, frames):
        return self._broken(self.engine.predict_batch_raw_frames(frames))


@pytest.mark.parametrize("fault,mix_name", [
    ("half_the_batch", "tiny-offline"), ("one_box", "tiny-offline"),
    ("one_class", "tiny-offline"), ("one_score", "tiny-offline"),
    ("one_box", "tiny-camera"), ("one_class", "tiny-camera"),
    ("one_score", "tiny-camera")])
def test_a_broken_path_is_not_correct(fault, mix_name):
    def build(*args):
        return Broken(system.build(*args), fault)
    result, checks = run("int16", mix_name, build=build)
    assert result["correct"] is False, checks
