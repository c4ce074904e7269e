"""The port's own host layer (yolotpu_torch's cfg, graph, models.zoo,
weights, golden, quant, image, postprocess, names, runtime.drawing, the plan
parser of models.engine_plan and the helpers of runtime.engine) against the
modules of the JAX package it mirrors, on seeded inputs.

Each side builds its objects with its own modules; the results must be equal
field by field, array by array (fp32 host math bit for bit: both sides run
the same numpy code).
"""

import dataclasses

import numpy as np
import pytest

from yolotpu import golden as jgolden
from yolotpu import image as jimage
from yolotpu import names as jnames
from yolotpu import postprocess as jpost
from yolotpu import weights as jweights
from yolotpu.graph import NetworkSpec as JNetworkSpec
from yolotpu.models import engine_plan as jplan
from yolotpu.models import zoo as jzoo
from yolotpu.runtime import drawing as jdrawing
from yolotpu.runtime import engine as jengine
from yolotpu_torch import golden, image, names, postprocess, weights
from yolotpu_torch.graph import NetworkSpec
from yolotpu_torch.models import engine_plan, zoo
from yolotpu_torch.runtime import drawing
from yolotpu_torch.runtime import engine

MODELS = [("yolov2", 64), ("yolov2-voc", 96), ("yolov2-tiny", 64)]
SMALL = "examples/small.png"


def _layers(spec):
    return [(type(l).__name__, dataclasses.asdict(l)) for l in spec.layers]


def _assert_spec_equal(got, want):
    assert _layers(got) == _layers(want)
    assert dataclasses.asdict(got.net) == dataclasses.asdict(want.net)
    assert [l.idx for l in got.conv_layers()] == [l.idx for l in want.conv_layers()]
    assert dataclasses.asdict(got.region) == dataclasses.asdict(want.region)


def _assert_layers_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for idx in want:
        for g, w in zip(got[idx], want[idx]):
            assert g.dtype == w.dtype and np.array_equal(g, w), idx


@pytest.mark.parametrize("model,size", MODELS)
def test_zoo_specs_equal(model, size):
    _assert_spec_equal(zoo.build(model, width=size, height=size),
                       jzoo.build(model, width=size, height=size))


def test_cfg_walk_equals(tmp_path):
    # a darknet cfg file through both parsers: the whole spec and the
    # unused-option report
    cfg = jzoo.to_cfg("yolov2-tiny").replace("[net]\n", "[net]\nmomentum=0.9\n")
    path = tmp_path / "tiny.cfg"
    path.write_text(cfg)
    _assert_spec_equal(NetworkSpec.from_cfg(str(path), quiet=True),
                       JNetworkSpec.from_cfg(str(path), quiet=True))


@pytest.mark.parametrize("model,size", MODELS)
def test_synthetic_store_equal(model, size):
    got = weights.WeightStore.synthetic(zoo.build(model, width=size, height=size), 3)
    want = jweights.WeightStore.synthetic(jzoo.build(model, width=size, height=size), 3)
    _assert_layers_equal(got.fp32, want.fp32)


def _qtables(store, attr):
    q = getattr(store, attr)
    return [[np.asarray(e).tolist() for e in v]
            for v in (q.weight_q, q.bias_q, q.act_q)]


@pytest.mark.parametrize("precision,wattr,qattr", [
    ("int16", "int16", "qtables"), ("int8", "int8", "qtables8"),
    ("w8a16", "w8a16", "qtables_w8")])
def test_load_or_synthesize_equal(precision, wattr, qattr):
    got = engine.load_or_synthesize(zoo.build("yolov2", width=64, height=64),
                                    None, precision, synthetic=True, seed=0)
    want = jengine.load_or_synthesize(jzoo.build("yolov2", width=64, height=64),
                                      None, precision, synthetic=True, seed=0)
    assert _qtables(got, qattr) == _qtables(want, qattr)
    _assert_layers_equal(getattr(got, wattr), getattr(want, wattr))
    _assert_layers_equal(got.int16, want.int16)


@pytest.mark.parametrize("reorg", [False, True])
def test_artifact_loaders_equal(tmp_path, reorg):
    """Artifacts written by yolotpu (fp32 and int16, plain and tile-
    reorganized, with the odd-count padding) read back alike."""
    jspec = jzoo.build("yolov2-tiny", width=64, height=64)
    spec = zoo.build("yolov2-tiny", width=64, height=64)
    src = jengine.load_or_synthesize(jspec, None, "int16", synthetic=True, seed=1)
    src.save_fp32(str(tmp_path), reorg=reorg)
    src.save_int16(str(tmp_path), reorg=reorg)
    suffix = "_reorg" if reorg else ""
    wf = str(tmp_path / f"weights{suffix}.bin")
    wi = str(tmp_path / ("weights_reorg_int16.bin" if reorg else "weight_int16.bin"))
    for load, args in (("load_fp32", (wf, str(tmp_path / "bias.bin"))),
                       ("load_int16", (wi, str(tmp_path / "bias_int16.bin"),
                                       str(tmp_path)))):
        got = getattr(weights.WeightStore, load)(spec, *args, reorg=reorg)
        want = getattr(jweights.WeightStore, load)(jspec, *args, reorg=reorg)
        attr = "fp32" if load == "load_fp32" else "int16"
        _assert_layers_equal(getattr(got, attr), getattr(want, attr))
    got = engine.load_or_synthesize(spec, str(tmp_path), "int16")
    want = jengine.load_or_synthesize(jspec, str(tmp_path), "int16")
    _assert_layers_equal(got.int16, want.int16)
    assert _qtables(got, "qtables") == _qtables(want, "qtables")


def test_golden_fp32_forward_equal():
    spec = zoo.build("yolov2", width=64, height=64)
    jspec = jzoo.build("yolov2", width=64, height=64)
    store = weights.WeightStore.synthetic(spec, seed=0)
    img = np.random.default_rng(4).random((3, 64, 64)).astype(np.float32)
    got = golden.GoldenNet(spec).forward_fp32(img, store.fp32, keep_all=True)
    want = jgolden.GoldenNet(jspec).forward_fp32(img, store.fp32, keep_all=True)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("hw", [(150, 200), (200, 150), (416, 416), (7, 3)])
def test_letterbox_equal(hw):
    im = np.random.default_rng(hw[0]).random((3, *hw)).astype(np.float32)
    np.testing.assert_array_equal(image.letterbox_image(im, 96, 64),
                                  jimage.letterbox_image(im, 96, 64))


def test_image_io_equal(tmp_path):
    im = image.load_image(SMALL)
    np.testing.assert_array_equal(im, jimage.load_image(SMALL))
    image.save_image(im, str(tmp_path / "a.png"))
    jimage.save_image(im, str(tmp_path / "b.png"))
    np.testing.assert_array_equal(image.load_image(str(tmp_path / "a.png")),
                                  jimage.load_image(str(tmp_path / "b.png")))


@pytest.mark.parametrize("model", ["yolov2", "yolov2-voc"])
def test_region_postprocess_equal(model):
    """forward_region, get_region_detections, do_nms_sort and the drawing on
    one seeded head, through each side's own modules."""
    region = zoo.build(model, width=96, height=96).region
    jregion = jzoo.build(model, width=96, height=96).region
    oc = region.num * (region.coords + region.classes + 1)
    rng = np.random.default_rng(11)
    raw = rng.standard_normal(oc * region.h * region.w).astype(np.float32)
    act = postprocess.forward_region(raw, region)
    np.testing.assert_array_equal(act, jpost.forward_region(raw, jregion))
    kw = dict(im_w=200, im_h=150, net_w=96, net_h=96, thresh=0.05)
    got = postprocess.get_region_detections(act, region, **kw)
    want = jpost.get_region_detections(act, jregion, **kw)
    assert len(got) == len(want) > 10

    def same(g, w):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.bbox == b.bbox and a.objectness == b.objectness
            np.testing.assert_array_equal(a.prob, b.prob)

    same(got, want)
    got = postprocess.do_nms_sort(got, region.classes, 0.45)
    want = jpost.do_nms_sort(want, jregion.classes, 0.45)
    same(got, want)
    im = np.random.default_rng(12).random((3, 150, 200)).astype(np.float32)
    label = names.names_for(region.classes)

    def inside(dets):   # boxes wholly off the image do not draw, on either side
        return [d for d in dets if 0 <= d.bbox[0] - d.bbox[2] / 2
                and d.bbox[0] + d.bbox[2] / 2 <= 1
                and 0 <= d.bbox[1] - d.bbox[3] / 2
                and d.bbox[1] + d.bbox[3] / 2 <= 1]

    assert len(inside(got)) > 0
    np.testing.assert_array_equal(
        drawing.draw_detections(im, inside(got), label, 0.05),
        jdrawing.draw_detections(im, inside(want), label, 0.05))


@pytest.mark.parametrize("plan", [
    "", "0:entry_sdmm,2:sd_pool", " 4 : conv3p2 ,, 6:xla", "0:entry9",
    "3:", "x:mm"])
def test_plan_overrides_equal(plan, monkeypatch):
    monkeypatch.setenv("YOLO2_Q16_PLAN", plan)
    try:
        want = jplan.plan_overrides()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            engine_plan.plan_overrides()
        assert str(got.value) == str(e)
        return
    assert engine_plan.plan_overrides() == want
    assert engine_plan.ALL_KINDS == jplan.ALL_KINDS


@pytest.mark.parametrize("model,size", MODELS)
def test_next_is_pool22_equal(model, size):
    spec = zoo.build(model, width=size, height=size)
    jspec = jzoo.build(model, width=size, height=size)
    assert ([engine_plan.next_is_pool22(spec, l.idx) for l in spec.layers]
            == [jplan.next_is_pool22(jspec, l.idx) for l in jspec.layers])


@pytest.mark.parametrize("classes", [80, 20, 7])
def test_names_equal(classes):
    assert names.names_for(classes) == jnames.names_for(classes)


def test_region_dump_equal(tmp_path, monkeypatch):
    vals = np.random.default_rng(2).standard_normal(50).astype(np.float32)
    monkeypatch.delenv("YOLO2_NO_DUMP", raising=False)
    for mod, name in ((engine, "a.txt"), (jengine, "b.txt")):
        monkeypatch.setenv("YOLO2_DUMP_REGION", str(tmp_path / name))
        mod.maybe_dump_region(vals, raw=False)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
