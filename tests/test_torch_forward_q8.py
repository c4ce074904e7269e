"""The port's int8 (w8a8, head16) and w8a16 tiers (yolotpu_torch.models.yolov2,
runtime.engine, cli.detect) against the JAX package's, on the CPU, at small
sizes.

Each package builds its spec and synthetic WeightStore (seed 0, calibrated
on one seeded image, each tier quantized as load_or_synthesize does it; the
int8 tier also with per-channel weight Qs) with its own host layer. The port runs its kernels'
plain versions here. The head must be bit-equal to yolotpu's
build_forward(spec, "int8" | "w8a16", compute="int32"); boxes/obj/probs go
through fp32 exp/sigmoid/softmax and are held to atol=1e-6, rtol=1e-5, as in
test_torch_forward.py.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from yolotpu import quant as jquant
from yolotpu import weights as jweights
from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu_torch import quant as tquant
from yolotpu_torch import weights as tweights
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.models import zoo as tzoo

# port? -> the host layer (zoo, weights, quant) that builds spec and store
HOSTS = {False: (jzoo, jweights, jquant), True: (tzoo, tweights, tquant)}

CASES = [("yolov2", 64), ("yolov2-voc", 64), ("yolov2-tiny", 96)]
# tier -> (precision, Q tables attribute, JAX params, port params)
TIERS = {
    "int8": ("int8", "qtables8", jy.params_int8, ty.params_int8),
    "int8-pc": ("int8", "qtables8", jy.params_int8, ty.params_int8),
    "w8a16": ("w8a16", "qtables_w8", jy.params_w8a16, ty.params_w8a16),
}


@functools.cache
def _setup(model: str, size: int, per_channel: bool = False,
           port: bool = False):
    zoo, weights, quant = HOSTS[port]
    spec = zoo.build(model, width=size, height=size)
    store = weights.WeightStore.synthetic(spec, seed=0)
    img = np.random.default_rng(100).random((3, size, size)).astype(np.float32)
    act_q = quant.calibrate_activations(spec, store, [img])
    quant.quantize_weights(store, act_q)
    quant.quantize_weights_w8a16(store, act_q)
    quant.quantize_weights_int8(
        store, quant.calibrate_activations_int8(spec, store, [img]),
        per_channel=per_channel)
    return spec, store


def _tier(model: str, size: int, tier: str, port: bool = False):
    precision, qattr, jparams, tparams = TIERS[tier]
    spec, store = _setup(model, size, tier == "int8-pc", port)
    return spec, store, precision, getattr(store, qattr), jparams, tparams


@functools.cache
def _jax_forward(model: str, size: int, tier: str):
    spec, store, precision, qt, jparams, _ = _tier(model, size, tier)
    fwd = jax.jit(jy.build_forward(spec, precision, qt, compute="int32",
                                   outputs=("head", "boxes")))
    return functools.partial(fwd, jparams(spec, store))


def _inputs(size: int, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(size + 1)
    if dtype == "uint8":
        return rng.integers(0, 256, (1, size, size, 3)).astype(np.uint8)
    return rng.random((1, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("model,size", CASES)
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_forward_head_bitexact_vs_yolotpu(model, size, tier, dtype):
    spec, store, precision, qt, _, tparams = _tier(model, size, tier, True)
    x = _inputs(size, dtype)
    want = _jax_forward(model, size, tier)(jnp.asarray(x))
    net = ty.YoloV2Q(spec, qt, tparams(spec, store), "cpu", precision)
    got = net(torch.from_numpy(x))
    head = np.asarray(want["head"])
    np.testing.assert_array_equal(got["head"].numpy(), head)
    for k in ("boxes", "obj", "probs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-5)
    # a head that depends on the input: many distinct values
    assert len(np.unique(head)) > 100


def test_int8_head16_conv_writes_int16():
    spec, store, precision, qt, _, tparams = _tier("yolov2", 64, "int8", True)
    net = ty.YoloV2Q(spec, qt, tparams(spec, store), "cpu", precision)
    head_conv = spec.layers[spec.region.idx - 1]
    assert net.head16 == head_conv.idx
    plan = net.plan
    b = tparams(spec, store)[f"conv{head_conv.idx}"]["b"]
    assert torch.equal(getattr(net, f"b{head_conv.idx}"),
                       (b.to(torch.int64) << 8).to(torch.int32))
    assert torch.equal(getattr(net, f"s{head_conv.idx}"), torch.full(
        (head_conv.n,), plan.conv_shift_out[head_conv.idx] - 8,
        dtype=torch.int32))
    x = torch.from_numpy(_inputs(64, "uint8"))
    y = net._conv(head_conv, torch.zeros((1, 2, 2, head_conv.c),
                                          dtype=torch.int8))
    assert y.dtype == torch.int16
    # every other conv keeps int8 activations
    assert net(x)["head"].dtype == torch.float32
    assert net.kinds[head_conv.idx] == "mm"


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("model", ["yolov2", "yolov2-voc", "yolov2-tiny"])
def test_int16_plan_equals_yolotpu(model, tier):
    size = 96 if model == "yolov2-tiny" else 64
    spec, _, _, qt, _, _ = _tier(model, size, tier)
    tspec, _, _, tqt, _, _ = _tier(model, size, tier, True)
    got = dataclasses.asdict(ty.Int16Plan.build(tspec, tqt))
    want = dataclasses.asdict(jy.Int16Plan.build(spec, qt))
    assert got.keys() == want.keys()
    for field, w in want.items():
        g = got[field]
        if isinstance(w, dict):
            assert g.keys() == w.keys(), field
            for k in w:
                assert np.array_equal(g[k], w[k]), (field, k)
        else:
            assert np.array_equal(g, w), field
    if tier != "int8":   # per-channel weight Qs: vector shifts
        assert any(np.ndim(s) == 1 for s in got["conv_shift_out"].values())


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("model", ["yolov2", "yolov2-tiny"])
def test_params_from_jax_equals_params(model, tier):
    size = 96 if model == "yolov2-tiny" else 64
    spec, store, _, _, jparams, tparams = _tier(model, size, tier)
    jp = {k: {n: np.asarray(a) for n, a in v.items()}
          for k, v in jparams(spec, store).items()}
    got = ty.params_from_jax(jp)
    want = tparams(*_tier(model, size, tier, True)[:2], "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert set(got[k]) == {"w", "b"}   # cw and wp8 serve the TPU only
        assert got[k]["w"].dtype == torch.int8
        for n in ("w", "b"):
            assert got[k][n].dtype == want[k][n].dtype
            assert torch.equal(got[k][n], want[k][n]), (k, n)


@pytest.mark.parametrize("tier", ["int8", "w8a16"])
def test_engine_detect_equals_yolotpu_engine(monkeypatch, tier):
    from yolotpu.runtime.engine import Engine as JaxEngine
    from yolotpu_torch.runtime.engine import Engine
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    spec, store = _setup("yolov2", 128)
    rng = np.random.default_rng(5)
    im = rng.random((3, 150, 200)).astype(np.float32)
    want, wres = JaxEngine(spec, store, precision=tier, backend="xla",
                           compute="int32", warmup=False).detect(im, thresh=0.005)
    eng = Engine(*_setup("yolov2", 128, port=True), precision=tier,
                 device="cpu")
    got, res = eng.detect(im, thresh=0.005)
    np.testing.assert_array_equal(res.head_chw, wres.head_chw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.bbox == w.bbox and g.objectness == w.objectness
        np.testing.assert_array_equal(g.prob, w.prob)
    frames = rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    heads = eng.predict_batch_rgb(frames)
    np.testing.assert_array_equal(
        heads, eng.predict_batch(frames.transpose(0, 3, 1, 2) / np.float32(255)))
    assert heads.shape == (2, spec.layers[-1].out_c, 4, 4)


def test_engine_checks_the_store():
    from yolotpu_torch.runtime.engine import Engine
    spec = tzoo.build("yolov2-tiny", width=32, height=32)
    store = tweights.WeightStore.synthetic(spec, seed=0)
    for precision, what in (("int8", "quantize_weights_int8"),
                            ("w8a16", "quantize_weights_w8a16"),
                            ("int16", "quantized weights")):
        with pytest.raises(ValueError, match=what):
            Engine(spec, store, precision=precision, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        Engine(spec, store, precision="int4", device="cpu")


def test_cli_int8_on_cpu(tmp_path, monkeypatch, capsys):
    from pathlib import Path
    from yolotpu_torch.cli.detect import main
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    img = Path(__file__).resolve().parent.parent / "examples" / "small.png"
    out = tmp_path / "pred"
    rc = main(["--precision", "int8", "--device", "cpu", "--net-size", "64",
               "--synthetic-weights", "--output", str(out), str(img)])
    assert rc == 0
    assert (tmp_path / "pred.png").exists()
    assert "predicted in" in capsys.readouterr().out
