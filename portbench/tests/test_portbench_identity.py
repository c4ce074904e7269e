"""Same seed, same inputs: the seeded inputs, the reference's detections
and the work counts of the yolov2 configurations, pinned as SHA-256
digests and values worked out before the harness took networks with
several heads. A change to the harness that moves one bit of them changes
what every yolov2 cell reads."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import netcfg, synth, work
from portbench.references import load as load_reference

ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data" / "configs"
SHAPES = {"net": (8, 64, 64, 3), "raw": (8, 48, 64, 3)}

# (tier, seed, frames) -> digests of the weights, the calibration image,
# the pool, and the reference's detections of the pool's 8 frames
PINNED = {
    ("int16", 0, "net"): (
        "78f1f6749565546a2c529dc3edbcbc2402c74cf5d7e59714e380bad98f92b152",
        "1aa2f183441fb776eeed71e86bd0449395cde4e53dd3baa28bd156ada35c04a4",
        "73be99deafa9e1144d8a9a6276beaba41b380325ab299495306131b41d58bc99",
        "9cbb34e4edb7bf02f39d11bbadd89c009ab563b39feaec27c4f3f65bfccdd0e2"),
    ("int16", 0, "raw"): (
        "4f13b89f33a4d153300e36bcdd1cf6df67e2dd401746e571e178df2f8452e8eb",
        "1aa2f183441fb776eeed71e86bd0449395cde4e53dd3baa28bd156ada35c04a4",
        "6b8bfc394e107a52259d656f2a266a388ef2969c09d2246ca310480661758866",
        "1124ac3ed449702312a77e36aa25b34590d4bee46df77b5bfc7f8aebe9fdd5a8"),
    ("int16", 1, "net"): (
        "812677e53e41083d377472bc6468ca913884ad0d4b8a6ff5514d18ebbb0e6fb7",
        "fe8a774afe3107a3fc51e7d3a708906bf775a98d390fa48adc1756bbd53db32a",
        "6d9e949b91eab3f5a7c7007f1b8ebfb79f0ef84f9261df252270ae72e404f685",
        "a1e26efb4a27bae79781eaee95b8bc0ddc1cc2cbaf7a653bde404cd93ce5b564"),
    ("int16", 1, "raw"): (
        "c6ee7c3acf497eca09d6b8e5f66303f50fdf5923270a92bb6bfa9a2e43bd8fa0",
        "fe8a774afe3107a3fc51e7d3a708906bf775a98d390fa48adc1756bbd53db32a",
        "b5fe46a314294d20588431fd23fdb99b2fe7a2b762cc3464fbb9e8ec902decf6",
        "3af50cc4c7ce653aa1a6962367aed1a43a0b13a8492f3a499346d4527a0b418b"),
    ("int8", 0, "net"): (
        "78f1f6749565546a2c529dc3edbcbc2402c74cf5d7e59714e380bad98f92b152",
        "1aa2f183441fb776eeed71e86bd0449395cde4e53dd3baa28bd156ada35c04a4",
        "73be99deafa9e1144d8a9a6276beaba41b380325ab299495306131b41d58bc99",
        "27bd68b126d6cad3f294561f07062391ba919462cd08bdfa91306e569f2f23b7"),
    ("int8", 0, "raw"): (
        "4f13b89f33a4d153300e36bcdd1cf6df67e2dd401746e571e178df2f8452e8eb",
        "1aa2f183441fb776eeed71e86bd0449395cde4e53dd3baa28bd156ada35c04a4",
        "6b8bfc394e107a52259d656f2a266a388ef2969c09d2246ca310480661758866",
        "8269d9f9361753667850bf036b654510bf6da8e69a634534e37ed99d1b6e2886"),
    ("int8", 1, "net"): (
        "812677e53e41083d377472bc6468ca913884ad0d4b8a6ff5514d18ebbb0e6fb7",
        "fe8a774afe3107a3fc51e7d3a708906bf775a98d390fa48adc1756bbd53db32a",
        "6d9e949b91eab3f5a7c7007f1b8ebfb79f0ef84f9261df252270ae72e404f685",
        "2a2905496b4d8bd3e3dd5b3fc0f08fd9152943960d7dee00ed83367a9b694406"),
    ("int8", 1, "raw"): (
        "c6ee7c3acf497eca09d6b8e5f66303f50fdf5923270a92bb6bfa9a2e43bd8fa0",
        "fe8a774afe3107a3fc51e7d3a708906bf775a98d390fa48adc1756bbd53db32a",
        "b5fe46a314294d20588431fd23fdb99b2fe7a2b762cc3464fbb9e8ec902decf6",
        "bac27080f41ef6dc4e815c5424b4883dc9e97752ecf52731c3ec18f4d62ab4ab"),
}


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("tier,seed,frames", sorted(PINNED))
def test_inputs_and_detections_are_the_pinned_ones(tier, seed, frames):
    cfg = json.loads((DATA / f"tiny-64-{tier}.json").read_text())
    layers = netcfg.layers_of(cfg)
    raw = frames == "raw"
    cpu = torch.device("cpu")
    inputs = synth.make_inputs(layers, cfg["weights"], cfg["engine"],
                               SHAPES[frames], raw, seed, cpu)
    ref = load_reference(cfg["reference"])(cfg, inputs.weights, inputs.calib,
                                           tier, cpu)
    dets = ref.detect(inputs.pool[:8], raw)
    got = (digest(*[a for i in sorted(inputs.weights)
                    for a in inputs.weights[i]]),
           digest(inputs.calib), digest(inputs.pool),
           digest(*[a for d in dets for a in d]))
    assert got == PINNED[tier, seed, frames]


@pytest.mark.parametrize("name", ("yolov2-416-int16", "yolov2-416-int8"))
def test_yolov2_416_work_is_the_pinned_one(name):
    layers = netcfg.layers_of(json.loads(
        (ROOT / "configs" / f"{name}.json").read_text()))
    assert work.frame_ops(layers) == 29464168448.0
    assert work.conv_bound_seconds(layers, "int16") == 6.42844714864284e-05
    assert work.conv_bound_seconds(layers, "int8") == 2.4780079924762243e-05
    assert work.conv_bound_seconds(layers, "w8a16") == 3.640769602057424e-05
