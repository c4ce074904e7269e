"""The yardstick's arithmetic: yolov2's operations at 416x416 against a
table written out by hand, the bytes and the tier's peaks."""

import json
from pathlib import Path

import pytest

from portbench import netcfg, work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LAYERS = netcfg.layers_of(json.loads(
    (CONFIGS / "yolov2-416-int16.json").read_text()))

# yolov2 at 416x416: (output side, input channels, filters, kernel) of its
# 23 convs, from darknet's cfg/yolov2.cfg
YOLOV2_416 = [
    (416, 3, 32, 3), (208, 32, 64, 3), (104, 64, 128, 3), (104, 128, 64, 1),
    (104, 64, 128, 3), (52, 128, 256, 3), (52, 256, 128, 1),
    (52, 128, 256, 3), (26, 256, 512, 3), (26, 512, 256, 1),
    (26, 256, 512, 3), (26, 512, 256, 1), (26, 256, 512, 3),
    (13, 512, 1024, 3), (13, 1024, 512, 1), (13, 512, 1024, 3),
    (13, 1024, 512, 1), (13, 512, 1024, 3), (13, 1024, 1024, 3),
    (13, 1024, 1024, 3), (26, 512, 64, 1), (13, 1280, 1024, 3),
    (13, 1024, 425, 1)]


def test_yolov2_416_operations_match_the_table():
    by_hand = sum(2 * s * s * c * n * k * k for s, c, n, k in YOLOV2_416)
    assert by_hand == 29_464_168_448
    assert work.frame_ops(LAYERS) == by_hand
    assert round(work.frame_ops(LAYERS) / 1e9, 2) == 29.46
    got = [(l.out_h, l.c, l.out_c, l.size) for l in netcfg.convs(LAYERS)]
    assert got == YOLOV2_416


def test_tier_peaks():
    assert work.tier_peak_ops("int16") == pytest.approx(1979e12 / 4)
    assert work.tier_peak_ops("int8") == pytest.approx(1979e12)


def test_conv_bytes_and_bound():
    first = netcfg.convs(LAYERS)[0]
    assert work.conv_bytes(first, "int16") == 2 * (416 * 416 * 3
                                                   + 416 * 416 * 32
                                                   + 9 * 3 * 32)
    assert work.conv_bytes(first, "int8") == work.conv_bytes(first,
                                                             "int16") / 2
    head = netcfg.convs(LAYERS)[-1]
    assert work.conv_bytes(head, "int8", head=True) == (
        13 * 13 * 1024 + 2 * 13 * 13 * 425 + 1024 * 425)
    b16 = work.conv_bound_seconds(LAYERS, "int16")
    b8 = work.conv_bound_seconds(LAYERS, "int8")
    # the 3x3 convs after the first are bound by operations, the first and
    # the 1x1s by bytes: the bound lies above the operations' alone
    ops_only = work.frame_ops(LAYERS) / (1979e12 / 4)
    assert ops_only < b16 < 1.2 * ops_only
    assert (work.conv_bytes(first, "int16") / 3.35e12
            > work.conv_ops(first) / (1979e12 / 4))
    assert b8 < b16 / 2
