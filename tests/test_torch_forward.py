"""The port's int16 forward (yolotpu_torch.models.yolov2) and engine against
the JAX package's, on the CPU, at small sizes.

Each package builds its spec and synthetic WeightStore (seed 0, calibrated
on one seeded image) with its own host layer: the port's is its own copy. The port runs its kernels' plain versions here. The head
must be bit-equal to yolotpu's build_forward(spec, "int16", compute="int32")
(which the JAX suite holds equal to compute="pallas"); boxes/obj/probs go
through fp32 exp/sigmoid/softmax and are held to atol=1e-6, rtol=1e-5.
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
from yolotpu_torch.models import engine_plan
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.models import zoo

# port? -> the host layer (zoo, weights, quant) that builds spec and store
HOSTS = {False: (jzoo, jweights, jquant), True: (zoo, tweights, tquant)}

CASES = [("yolov2", 64), ("yolov2", 128), ("yolov2-voc", 64),
         ("yolov2-tiny", 96)]


@functools.cache
def _setup(model: str, size: int, port: bool = False):
    hzoo, weights, quant = HOSTS[port]
    spec = hzoo.build(model, width=size, height=size)
    store = weights.WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(100)
    img = rng.random((3, size, size)).astype(np.float32)
    quant.quantize_weights(store, quant.calibrate_activations(spec, store, [img]))
    return spec, store


@functools.cache
def _jax_forward(model: str, size: int, compute: str = "int32"):
    spec, store = _setup(model, size)
    if compute == "pallas":
        params = jy.params_q16(spec, store)
    else:
        params = jy.params_int16(spec, store)
    fwd = jax.jit(jy.build_forward(spec, "int16", store.qtables,
                                   compute=compute, outputs=("head", "boxes")))
    # params as an argument, not closed over: XLA then does not fold the
    # weights as constants, which costs seconds of compile time
    return functools.partial(fwd, params)


def _inputs(size: int, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(size)
    if dtype == "uint8":
        return rng.integers(0, 256, (1, size, size, 3)).astype(np.uint8)
    return rng.random((1, size, size, 3)).astype(np.float32)


def _assert_outputs_match(got: dict, want: dict) -> None:
    np.testing.assert_array_equal(got["head"].numpy(), np.asarray(want["head"]))
    for k in ("boxes", "obj", "probs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("model", ["yolov2", "yolov2-voc", "yolov2-tiny"])
def test_int16_plan_equals_yolotpu(model):
    size = 96 if model == "yolov2-tiny" else 64
    spec, store = _setup(model, size)
    tspec, tstore = _setup(model, size, port=True)
    got = ty.Int16Plan.build(tspec, tstore.qtables)
    want = jy.Int16Plan.build(spec, store.qtables)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("model", ["yolov2", "yolov2-tiny"])
def test_params_from_jax_equals_params_int16(model):
    size = 96 if model == "yolov2-tiny" else 64
    spec, store = _setup(model, size)
    jp = {k: {n: np.asarray(a) for n, a in v.items()}
          for k, v in jy.params_int16(spec, store).items()}
    got = ty.params_from_jax(jp)
    want = ty.params_int16(*_setup(model, size, port=True), "cpu")
    assert got.keys() == want.keys()
    for k in want:
        for n in ("w", "b"):
            assert got[k][n].dtype == want[k][n].dtype
            assert torch.equal(got[k][n], want[k][n]), (k, n)


@pytest.mark.parametrize("model,size", CASES)
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_forward_head_bitexact_vs_yolotpu(model, size, dtype):
    spec, store = _setup(model, size, port=True)
    x = _inputs(size, dtype)
    want = _jax_forward(model, size)(jnp.asarray(x))
    net = ty.YoloV2Q(spec, store.qtables, ty.params_int16(spec, store),
                     "cpu")
    got = net(torch.from_numpy(x))
    _assert_outputs_match(got, want)


def test_engine_plan_covers_the_zoo():
    for model in ("yolov2", "yolov2-voc", "yolov2-tiny"):
        spec = zoo.build(model, width=64, height=64)
        kinds = engine_plan.plan(spec)
        assert set(kinds.values()) <= {"mm", "conv3"}
        assert len(kinds) == len(spec.conv_layers())
    spec = zoo.build("yolov2")
    kinds = list(engine_plan.plan(spec).values())
    assert kinds.count("mm") == 8 and kinds.count("conv3") == 15


@pytest.mark.parametrize("bad,why", [(dict(activation="relu"), "'relu'"),
                                     (dict(groups=2), "grouped")])
def test_engine_plan_refuses_unported_convs(bad, why):
    """The integer tiers refuse what the JAX package's integer convs refuse:
    an activation other than linear or leaky, and groups (strided and
    other-sized convs run on the general conv: tests/
    test_torch_general_conv.py)."""
    l = zoo.build("yolov2", width=64, height=64).conv_layers()[1]
    with pytest.raises(NotImplementedError, match=why):
        engine_plan.select_engine(dataclasses.replace(l, **bad))


@pytest.mark.slow
def test_forward_head_bitexact_vs_yolotpu_pallas():
    spec, store = _setup("yolov2", 64, port=True)
    x = _inputs(64, "uint8")
    want = _jax_forward("yolov2", 64, "pallas")(jnp.asarray(x))
    net = ty.YoloV2Q(spec, store.qtables, ty.params_int16(spec, store),
                     "cpu")
    _assert_outputs_match(net(torch.from_numpy(x)), want)


def test_engine_detect_equals_yolotpu_engine(monkeypatch):
    from yolotpu.runtime.engine import Engine as JaxEngine
    from yolotpu_torch.runtime.engine import Engine
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    spec, store = _setup("yolov2", 128)
    rng = np.random.default_rng(5)
    im = rng.random((3, 150, 200)).astype(np.float32)
    want, wres = JaxEngine(spec, store, precision="int16", backend="xla",
                           compute="int32", warmup=False).detect(im, thresh=0.005)
    eng = Engine(*_setup("yolov2", 128, port=True), precision="int16",
                 device="cpu")
    got, res = eng.detect(im, thresh=0.005)
    np.testing.assert_array_equal(res.head_chw, wres.head_chw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.bbox == w.bbox and g.objectness == w.objectness
        np.testing.assert_array_equal(g.prob, w.prob)
    # the batched entry points give the same heads
    frames = rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    heads = eng.predict_batch_rgb(frames)
    np.testing.assert_array_equal(
        heads, eng.predict_batch(frames.transpose(0, 3, 1, 2) / np.float32(255)))
    assert heads.shape == (2, spec.layers[-1].out_c, 4, 4)
