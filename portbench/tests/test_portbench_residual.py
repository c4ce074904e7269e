"""The residual layers' bytes (``work.residual_bytes``) and their bound
(``work.residual_bound_seconds``): YOLOv3 at 416 pinned, none in yolov2,
and the tiny yolo fixture counted by hand."""

import json
from pathlib import Path

import pytest

from portbench import netcfg, work

HERE = Path(__file__).resolve().parent
CONFIGS = HERE.parent / "configs"


def layers(path: Path) -> list[netcfg.Layer]:
    return netcfg.layers_of(json.loads(path.read_text()))


YOLOV3 = layers(HERE / "data" / "nets" / "yolov3-416.json")

# tiny-v3-64's residual layers, from its cfg by hand: (kind, h, w, c,
# out_h, out_w); its 3x3/s2 convs halve 64 to 32 and 32 to 16
TINY_V3 = [("shortcut", 32, 32, 32, 32, 32), ("shortcut", 16, 16, 64, 16, 16),
           ("upsample", 16, 16, 32, 32, 32)]


def test_yolov3_416_is_pinned():
    shortcuts = [l for l in YOLOV3 if l.kind == "shortcut"]
    upsamples = [l for l in YOLOV3 if l.kind == "upsample"]
    assert (len(shortcuts), len(upsamples)) == (23, 2)
    assert work.residual_bytes(shortcuts, "int16") == 87_220_224
    assert work.residual_bytes(upsamples, "int16") == 1_297_920
    assert work.residual_bytes(YOLOV3, "int16") == 88_518_144
    assert work.residual_bytes(YOLOV3, "w8a16") == 88_518_144
    assert work.residual_bytes(YOLOV3, "int8") == 44_259_072
    bound = work.residual_bound_seconds(YOLOV3, "int16")
    assert bound == 88_518_144 / 3.35e12
    assert round(bound * 1e6) == 26
    # 18% of the convs' bound of 146 us a frame
    assert round(work.conv_bound_seconds(YOLOV3, "int16") * 1e6) == 146
    assert round(100 * bound / work.conv_bound_seconds(YOLOV3, "int16")) \
        == 18


@pytest.mark.parametrize("name", ("yolov2-416-int16", "yolov2-416-int8"))
@pytest.mark.parametrize("tier", ("int16", "w8a16", "int8"))
def test_yolov2_has_none(name, tier):
    got = layers(CONFIGS / f"{name}.json")
    assert work.residual_bytes(got, tier) == 0
    assert work.residual_bound_seconds(got, tier) == 0.0


def test_tiny_v3_by_hand():
    got = layers(HERE / "data" / "configs" / "tiny-v3-64-int16.json")
    assert [(l.kind, l.h, l.w, l.c, l.out_h, l.out_w) for l in got
            if l.kind in ("shortcut", "upsample")] == TINY_V3
    # a shortcut reads two inputs and writes one output of its shape; an
    # upsample reads its input and writes its output, each of c channels
    elements = (3 * 32 * 32 * 32 + 3 * 16 * 16 * 64
                + 16 * 16 * 32 + 32 * 32 * 32)
    assert elements == 188_416
    assert work.residual_bytes(got, "int16") == 2 * elements
    assert work.residual_bytes(got, "int8") == elements
    assert work.residual_bound_seconds(got, "int8") == elements / 3.35e12
