"""The seeded inputs of a network with several heads: ``make_inputs`` fits
each yolo head's conv to its roles on the calibration image, and the
objectness of all heads by one shift to the configuration's detections a
frame, over the heads' candidates together (the float64 detector)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.darknet_float import (decode_heads, detections, float_forward,
                                     letterbox, to_unit)
from portbench.netcfg import heads, layers_of
from portbench.synth import HEAD_ROLES, head_roles, make_inputs

CFG = json.loads((Path(__file__).resolve().parent / "data" / "configs"
                  / "tiny-v3-64-int16.json").read_text())
GRID = 1 / 1024


@pytest.mark.parametrize("raw", (False, True))
@pytest.mark.parametrize("seed", (11, 2**31 + 3))
def test_every_head_is_fitted_and_the_count_reached(seed, raw):
    layers = layers_of(CFG)
    hs = heads(layers)
    assert len(hs) == 2
    w, e = CFG["weights"], CFG["engine"]
    shape = (8, 48, 64, 3) if raw else (8, 64, 64, 3)
    inputs = make_inputs(layers, w, e, shape, raw, seed, torch.device("cpu"))

    # the roles' spread and mean on the calibration image, the objectness
    # rows' mean moved by one shift on the grid, the same in both heads
    x = torch.from_numpy(inputs.calib).permute(1, 2, 0)[None]
    acts = float_forward(layers, inputs.weights, x, every=True)
    obj = HEAD_ROLES.index("obj")
    shift = None
    for h in hs:
        z = acts[h.idx - 1].reshape(-1, h.out_c).numpy()
        roles = head_roles(h)
        std = np.array([w["head_std"][HEAD_ROLES[r]] for r in roles])
        mean = np.array([w["head_mean"].get(HEAD_ROLES[r], 0.0)
                         for r in roles])
        assert np.all(np.abs(np.log2(z.std(axis=0) / std)) <= 1 / 128 + 1e-9)
        off = z.mean(axis=0) - mean
        if shift is None:
            shift = np.round(off[roles == obj][0] / GRID) * GRID
        off[roles == obj] -= shift
        assert np.all(np.abs(off) <= GRID / 2 + 1e-9), off

    # the count over both heads' candidates: reached at the fitted shift,
    # and not one grid step below it
    frames = torch.from_numpy(inputs.pool[:w["fit_frames"]])
    x = letterbox(frames, 64, 64) if raw else to_unit(frames)
    feats = float_forward(layers, inputs.weights, x,
                          keep={h.idx - 2 for h in hs})
    zs = []
    for h in hs:
        wt, b = inputs.weights[h.idx - 1]
        zs.append((feats[h.idx - 2] @ torch.from_numpy(
            wt.reshape(wt.shape[0], -1)).to(torch.float64).T,
            b.astype(np.float64), head_roles(h) == obj))

    def count(step: float) -> float:
        outs = [z + torch.from_numpy(b + step * o) for z, b, o in zs]
        boxes, objs, probs = (t.numpy() for t in decode_heads(outs, hs))
        return float(np.mean([
            len(detections(boxes[f], objs[f], probs[f], e["thresh"],
                           e["nms"], e["topk"])[1])
            for f in range(len(boxes))]))

    assert count(0.0) >= w["detections_per_frame"]
    assert count(-GRID) < w["detections_per_frame"]
