"""The port engine's debug surface and golden backend against yolotpu's
Engine, on the CPU, on the same seeded inputs:

- ``predict_layers`` of the device backend (the kernels' plain versions on
  the CPU) per tier against yolotpu's golden backend: every layer, bit for
  bit in the integer tiers (under a plan that fuses convs with their pools
  too), within the fp32 tests' tolerance in fp32; int16 also against
  yolotpu's XLA debug build (``compute="int32"``);
- ``dump_layers``: the same files, byte for byte;
- the golden backend's ``predict`` and ``detect`` (int32 and exact modes);
- ``compute``: "exact" runs on the golden backend only (the CLIs route it
  there), the TPU's "f32" modes raise.
"""

import functools

import numpy as np
import pytest

from yolotpu import quant as jquant
from yolotpu import weights as jweights
from yolotpu.models import zoo as jzoo
from yolotpu.runtime import engine as jengine
from yolotpu_torch import quant as quant_
from yolotpu_torch import weights
from yolotpu_torch.cli import detect
from yolotpu_torch.models import zoo
from yolotpu_torch.runtime import engine

SIZE = 64
TIERS = ("int16", "int8", "w8a16", "fp32")


@functools.cache
def _stores():
    """Synthetic weights from seed 0 quantized for every integer tier, as
    load_or_synthesize quantizes each (one calibration image from seed 0),
    on both sides: (spec, store, jspec, jstore)."""
    out = []
    for zoo_, wts, quant in ((zoo, weights, quant_), (jzoo, jweights, jquant)):
        spec = zoo_.build("yolov2", width=SIZE, height=SIZE)
        store = wts.WeightStore.synthetic(spec, seed=0)
        calib = [np.random.default_rng(0).random((3, SIZE, SIZE)).astype(
            np.float32)]
        act_q = quant.calibrate_activations(spec, store, calib)
        quant.quantize_weights(store, act_q)
        quant.quantize_weights_w8a16(store, act_q)
        quant.quantize_weights_int8(
            store, quant.calibrate_activations_int8(spec, store, calib))
        out += [spec, store]
    return tuple(out)


def _engines(tier, **kw):
    spec, store, jspec, jstore = _stores()
    return (engine.Engine(spec, store, tier, device="cpu", **kw),
            jengine.Engine(jspec, jstore, tier, backend="golden"))


def _image(seed=0):
    return np.random.default_rng(seed).random((3, SIZE, SIZE), dtype=np.float32)


def _assert_layers(got: dict, want: dict, fp32: bool):
    assert got.keys() == want.keys() == set(range(32))
    for idx, w in want.items():
        g = got[idx]
        assert g.dtype == w.dtype and g.shape == w.shape, idx
        if fp32:
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                       rtol=0, err_msg=str(idx))
        else:
            assert np.array_equal(g, w), idx


@pytest.mark.parametrize("tier", TIERS)
def test_predict_layers_equal_yolotpu_golden(tier):
    eng, jeng = _engines(tier)
    x = _image()
    got = eng.predict_layers(x)
    _assert_layers(got, jeng.predict_layers(x), tier == "fp32")
    # dtypes are the tier's own; the region layer holds the head, which is
    # predict's
    dtypes = {a.dtype for i, a in got.items() if i < 30}
    assert dtypes == {np.dtype({"int16": "int16", "int8": "int8",
                                "w8a16": "int16", "fp32": "float32"}[tier])}
    assert got[31].dtype == np.float32
    assert got[30].dtype == (np.int16 if tier != "fp32" else np.float32)
    assert np.array_equal(got[31], eng.predict(x).head_chw)


def test_predict_layers_int16_equal_yolotpu_xla_debug_build():
    spec, store, jspec, jstore = _stores()
    x = _image(1)
    want = jengine.Engine(jspec, jstore, "int16", backend="xla",
                          compute="int32").predict_layers(x)
    got = engine.Engine(spec, store, "int16", device="cpu").predict_layers(x)
    _assert_layers(got, want, False)


def test_predict_layers_under_a_fusing_plan(monkeypatch):
    """Under P1 the convs a pool follows run fused in the head path; the
    "acts" model records each conv's own output and then its pool, as
    yolotpu's debug build does, so the layers equal the golden ones."""
    monkeypatch.setenv("YOLO2_Q16_PLAN",
                       "0:entry_sdmm,2:sd_pool,6:sd_pool,10:sd_pool")
    eng, jeng = _engines("int16")
    assert eng.model.route[2] == ("conv3_pool", "acc")
    x = _image(2)
    _assert_layers(eng.predict_layers(x), jeng.predict_layers(x), False)
    assert eng._debug.route[2] == ("conv3", None) and not eng._debug.folded
    assert np.array_equal(eng.predict_layers(x)[31], eng.predict(x).head_chw)


@pytest.mark.parametrize("tier", ("int16", "int8", "w8a16"))
def test_dump_layers_files_byte_identical(tier, tmp_path):
    eng, jeng = _engines(tier)
    x = _image(3)
    eng.dump_layers(x, str(tmp_path / "port"))
    jeng.dump_layers(x, str(tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"layer{i:02d}.bin" for i in range(32)]
    layers = eng.predict_layers(x)
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        a = layers[int(name[5:7])]
        assert len(got) == a.size * a.itemsize


@pytest.mark.parametrize("tier,compute", [("int16", "int32"), ("int16", "exact"),
                                          ("int8", "int32"), ("w8a16", "int32"),
                                          ("fp32", "int32")])
def test_golden_backend_equals_yolotpu(tier, compute, monkeypatch):
    """predict in every tier and mode; in the int16 tier's int32 mode also
    detect and the batched fallbacks (float and uint8 frames)."""
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    spec, store, jspec, jstore = _stores()
    eng = engine.Engine(spec, store, tier, backend="golden", compute=compute)
    jeng = jengine.Engine(jspec, jstore, tier, backend="golden",
                          compute=compute)
    assert eng.model is None and not eng.device_nms
    x = _image(4)
    assert np.array_equal(eng.predict(x).head_chw, jeng.predict(x).head_chw)
    if (tier, compute) != ("int16", "int32"):
        return
    im = np.random.default_rng(5).random((3, 48, 80), dtype=np.float32)
    dets, _ = eng.detect(im, thresh=0.05)
    jdets, _ = jeng.detect(im, thresh=0.05)
    assert [(d.bbox, d.objectness, d.prob.tolist()) for d in dets] == \
        [(d.bbox, d.objectness, d.prob.tolist()) for d in jdets]
    frames = np.random.default_rng(6).integers(0, 256, (2, SIZE, SIZE, 3),
                                               dtype=np.uint8)
    assert np.array_equal(eng.predict_batch_rgb(frames),
                          jeng.predict_batch_rgb(frames))
    boxed = frames.transpose(0, 3, 1, 2) / np.float32(255)
    assert np.array_equal(eng.predict_batch(boxed), jeng.predict_batch(boxed))


def test_exact_runs_on_the_golden_backend_and_f32_raises(capsys):
    spec, store, _, _ = _stores()
    with pytest.raises(ValueError, match="golden backend only"):
        engine.Engine(spec, store, "int16", device="cpu", compute="exact")
    for mode in ("f32", "f32_highest"):
        for backend in ("device", "golden"):
            with pytest.raises(ValueError, match="does not carry over"):
                engine.Engine(spec, store, "int16", device="cpu",
                              backend=backend, compute=mode)
    with pytest.raises(ValueError, match="backend 'xla'"):
        engine.Engine(spec, store, "int16", device="cpu", backend="xla")
    # the CLIs: xla/hls -> device, cpu/golden -> golden, exact -> golden
    assert [detect.engine_backend(b, "int32") for b in
            ("xla", "hls", "cpu", "golden")] == ["device", "device", "golden",
                                                 "golden"]
    assert detect.engine_backend("xla", "exact") == "golden"
    assert "implies the golden backend" in capsys.readouterr().err
    eng = engine.Engine(spec, store, "int16", backend="golden", compute="exact")
    with pytest.raises(ValueError, match="device backend"):
        eng.predict_batch_raw_frames(np.zeros((1, 8, 8, 3), np.uint8))
