"""The shapes the benchmark reads from darknet's sections beyond yolov2's
(``[shortcut]``, ``[upsample]``, ``[yolo]``, several heads), and the float64
darknet's forward and decode of them, against their definitions."""

import copy
import json
import math
from pathlib import Path

import pytest
import torch

from portbench import darknet_float, netcfg, work

DATA = Path(__file__).resolve().parent / "data"
YOLOV3 = json.loads((DATA / "nets" / "yolov3-416.json").read_text())
TINY_V3 = json.loads((DATA / "configs" / "tiny-v3-64-int16.json").read_text())


def test_yolov3_416_shapes_heads_and_work():
    """darknet's yolov3.cfg at 416: 107 layers, 75 convs (five 3x3/s2),
    23 shortcuts, 2 upsamples, 4 routes; heads at 82, 94 and 106;
    65.86 GFLOP and 10,647 candidates a frame."""
    layers = netcfg.layers_of(YOLOV3)
    kinds = [l.kind for l in layers]
    assert len(layers) == 107
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "conv": 75, "shortcut": 23, "upsample": 2, "route": 4, "yolo": 3}
    strided = [(l.idx, l.out_h) for l in netcfg.convs(layers) if l.stride == 2]
    assert strided == [(1, 208), (5, 104), (12, 52), (37, 26), (62, 13)]
    assert [l.srcs for l in layers if l.kind == "route"] == [
        (79,), (85, 61), (91,), (97, 36)]
    assert [(l.idx, l.out_h, l.out_w, l.out_c) for l in layers
            if l.kind == "upsample"] == [(85, 26, 26, 256), (97, 52, 52, 128)]
    hs = netcfg.heads(layers)
    assert [(h.idx, (h.out_h, h.out_w, h.out_c)) for h in hs] == [
        (82, (13, 13, 255)), (94, (26, 26, 255)), (106, (52, 52, 255))]
    assert [h.anchors for h in hs] == [(116, 90, 156, 198, 373, 326),
                                       (30, 61, 62, 45, 59, 119),
                                       (10, 13, 16, 30, 33, 23)]
    assert all(h.num == 3 and h.classes == 80 and h.net == (416, 416)
               for h in hs)
    assert work.frame_ops(layers) == 65_864_075_264
    outs = [torch.zeros(1, h.out_h, h.out_w, h.out_c, dtype=torch.float64)
            for h in hs]
    boxes, obj, probs = darknet_float.decode_heads(outs, hs)
    assert boxes.shape == (1, 10_647, 4) and obj.shape == (1, 10_647)
    assert probs.shape == (1, 10_647, 80)
    for p in ("int16", "int8"):
        assert work.conv_bound_seconds(layers, p) > 0
    # every head's conv writes 16 bits in the int8 tier
    assert work.conv_bound_seconds(layers, "int8") > sum(
        max(work.conv_ops(l) / work.tier_peak_ops("int8"),
            work.conv_bytes(l, "int8") / work.PEAK_BYTES)
        for l in netcfg.convs(layers))


def _edited(section: int, **keys) -> dict:
    cfg = copy.deepcopy(TINY_V3)
    cfg["layers"][section].update(keys)
    return cfg


@pytest.mark.parametrize("cfg,match", [
    (_edited(4, activation="leaky"), "linear shortcut"),
    (_edited(8, **{"from": "-4"}), "unequal shapes"),
    (_edited(13, scale="2"), "whole stride"),
    (_edited(13, stride="-2"), "whole stride"),
    (_edited(10, scale_x_y="1.05"), "scale_x_y"),
    (_edited(10, new_coords="1"), "new_coords"),
    (_edited(10, activation="logistic"), "activation"),
    (_edited(9, filters="254"), "254"),
], ids=["shortcut_leaky", "shortcut_shapes", "upsample_scale",
        "upsample_negative", "scale_x_y", "new_coords", "yolo_activation",
        "head_channels"])
def test_sections_the_benchmark_cannot_read_raise(cfg, match):
    with pytest.raises(ValueError, match=match):
        netcfg.layers_of(cfg)


@pytest.mark.parametrize("cfg,match", [
    (_edited(11, layers="-2"), "feeds the head alone"),
    (_edited(11, type="convolutional", filters="64", size="1",
             activation="leaky"), "feeds the head alone"),
], ids=["route_reads_head_conv", "layer_reads_head"])
def test_a_head_conv_read_elsewhere_raises(cfg, match):
    layers = netcfg.layers_of(cfg)
    with pytest.raises(ValueError, match=match):
        netcfg.heads(layers)


def test_region_stays_the_one_head():
    cfg = copy.deepcopy(TINY_V3)
    cfg["layers"][10] = {"type": "region", "anchors": "1,1,2,2,3,3",
                         "classes": "80", "coords": "4", "num": "3",
                         "softmax": "1"}
    with pytest.raises(ValueError, match="one region layer"):
        netcfg.heads(netcfg.layers_of(cfg))


def _small_net() -> tuple[list, dict]:
    """net 3x4x2: two linear 1x1 convs, a shortcut of the first, an
    upsample by 2."""
    cfg = {"net": {"height": 3, "width": 4, "channels": 2}, "layers": [
        {"type": "convolutional", "filters": "2", "size": "1",
         "activation": "linear"},
        {"type": "convolutional", "filters": "2", "size": "1",
         "activation": "linear"},
        {"type": "shortcut", "from": "-2", "activation": "linear"},
        {"type": "upsample", "stride": "2"}]}
    gen = torch.Generator().manual_seed(4)
    weights = {i: (torch.randn(2, 2, 1, 1, generator=gen).numpy(),
                   torch.randn(2, generator=gen).numpy()) for i in (0, 1)}
    return netcfg.layers_of(cfg), weights


def test_shortcut_and_upsample_against_their_definitions():
    layers, weights = _small_net()
    assert [(l.out_h, l.out_w, l.out_c) for l in layers] == [
        (3, 4, 2), (3, 4, 2), (3, 4, 2), (6, 8, 2)]
    x = torch.rand(2, 3, 4, 2, generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64)
    acts = darknet_float.float_forward(layers, weights, x, every=True)
    a, b, s, u = (acts[i] for i in range(4))
    for n in range(2):
        for i in range(3):
            for j in range(4):
                for k in range(2):
                    assert s[n, i, j, k] == b[n, i, j, k] + a[n, i, j, k]
        for i in range(6):
            for j in range(8):
                for k in range(2):
                    assert u[n, i, j, k] == s[n, i // 2, j // 2, k]
    # without ``every``: the shortcut's source is kept, and ``keep``
    kept = darknet_float.float_forward(layers, weights, x, keep={2})
    assert sorted(kept) == [0, 2] and torch.equal(kept[2], s)


def _sig(v: float) -> float:
    return 1.0 / (1.0 + math.exp(-v))


def test_yolo_decode_at_entries_against_darknets_formulas():
    """darknet's get_yolo_box and get_yolo_detections, scalar by scalar:
    x = (col + s(tx)) / lw, y = (row + s(ty)) / lh, w = e^tw * anchor_w /
    net_w, h = e^th * anchor_h / net_h, objectness s(to), class s(tc)."""
    cfg = {"net": {"height": 16, "width": 24, "channels": 3}, "layers": [
        {"type": "convolutional", "filters": "16", "size": "1",
         "stride": "4", "activation": "linear"},
        {"type": "yolo", "mask": "1,2", "anchors": "4,5, 8,12, 14,10",
         "classes": "3", "num": "3"}]}
    yolo = netcfg.heads(netcfg.layers_of(cfg))[0]
    assert (yolo.out_h, yolo.out_w, yolo.num, yolo.anchors, yolo.net) == (
        4, 6, 2, (8, 12, 14, 10), (16, 24))
    head = torch.randn(2, 4, 6, 16, generator=torch.Generator().manual_seed(6),
                       dtype=torch.float64)
    boxes, obj, probs = darknet_float.decode(head, yolo)
    assert boxes.shape == (2, 48, 4) and probs.shape == (2, 48, 3)
    anchors = [(8.0, 12.0), (14.0, 10.0)]
    for f, row, col, a in [(0, 0, 0, 0), (0, 3, 5, 1), (1, 2, 1, 0),
                           (1, 1, 4, 1)]:
        t = head[f, row, col, 8 * a:8 * a + 8].tolist()
        n = (row * 6 + col) * 2 + a
        want = [(col + _sig(t[0])) / 6, (row + _sig(t[1])) / 4,
                math.exp(t[2]) * anchors[a][0] / 24,
                math.exp(t[3]) * anchors[a][1] / 16]
        assert boxes[f, n].tolist() == pytest.approx(want, rel=1e-14)
        assert float(obj[f, n]) == pytest.approx(_sig(t[4]), rel=1e-14)
        assert probs[f, n].tolist() == pytest.approx(
            [_sig(v) for v in t[5:]], rel=1e-14)


def test_heads_concatenate_in_layer_order():
    layers = netcfg.layers_of(TINY_V3)
    hs = netcfg.heads(layers)
    assert [(h.idx, h.out_h, h.anchors) for h in hs] == [
        (10, 16, (16, 24, 30, 22, 40, 48)), (17, 32, (4, 5, 8, 12, 14, 10))]
    gen = torch.Generator().manual_seed(7)
    outs = [torch.randn(2, h.out_h, h.out_w, h.out_c, generator=gen,
                        dtype=torch.float64) for h in hs]
    got = darknet_float.decode_heads(outs, hs)
    first = 16 * 16 * 3
    for part, (lo, hi) in zip(hs, [(0, first), (first, first + 32 * 32 * 3)]):
        want = darknet_float.decode(outs[hs.index(part)], part)
        for g, w in zip(got, want):
            assert torch.equal(g[:, lo:hi], w)
    assert got[0].shape[1] == first + 32 * 32 * 3
