"""The port's fp32 tier (``yolotpu_torch.ops.convops`` conv_fp32 and
activate_fp32, ``models.yolov2`` params_fp32 and the fp32 walk of
``YoloV2Q``) against the JAX package's, on the CPU, at small sizes.

Each package builds its spec and synthetic WeightStore (seed 0) with its own
host layer; the port's is its own copy, held bit-equal by test_torch_host.

Tolerances, and why they are not zero:
- activations: exp, tanh and expm1 are XLA's own polynomials in JAX and the
  C library's in PyTorch; they differ by a few ulp (2.4e-7 at most on these
  inputs), so atol 5e-7, rtol 1e-6; the piecewise-linear ones are exact;
- convs: XLA and oneDNN sum the products in other orders: atol 1e-5 and
  rtol 1e-5 against outputs of order 10;
- the forward: those differences compound over the layers; the head is
  held to 1e-4 of its largest magnitude, and the decoded tensors (through
  sigmoid, exp and softmax) to atol 1e-5, rtol 1e-4.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from yolotpu import weights as jweights
from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu.ops import convops as jconv
from yolotpu_torch import weights as tweights
from yolotpu_torch.golden import GoldenNet
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.models import zoo
from yolotpu_torch.ops import convops

ACTIVATIONS = ["linear", "leaky", "relu", "logistic", "tanh", "elu", "ramp",
               "relie", "loggy", "plse", "stair", "hardtan", "lhtan"]
CASES = [("yolov2", 64), ("yolov2", 128), ("yolov2-tiny", 96)]


@functools.cache
def _setup(model: str, size: int, port: bool = False):
    hzoo, weights = (zoo, tweights) if port else (jzoo, jweights)
    spec = hzoo.build(model, width=size, height=size)
    return spec, weights.WeightStore.synthetic(spec, seed=0)


@functools.cache
def _jax_forward(model: str, size: int):
    spec, store = _setup(model, size)
    fwd = jax.jit(jy.build_forward(spec, "fp32", outputs=("head", "boxes")))
    return functools.partial(fwd, jy.params_fp32(spec, store))


def _frame(size: int) -> np.ndarray:
    return np.random.default_rng(size).integers(
        0, 256, (1, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_activate_fp32_equals_yolotpu(activation):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    # the branch points of plse, stair, lhtan and hardtan, and signed zero
    x[:20] = [-4, 4, -5, 5, 0, 1, -1, 2, -2, 3, -3, 0.5, -0.5, 1.5, -1.5, 2.5,
              -2.5, -0.0, 7, -7]
    got = convops.activate_fp32(torch.from_numpy(x), activation).numpy()
    want = np.asarray(jconv.activate_fp32(jnp.asarray(x), activation))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=1e-6)


def test_activate_fp32_refuses_an_unknown_activation():
    with pytest.raises(NotImplementedError, match="swish"):
        convops.activate_fp32(torch.zeros(3), "swish")


@pytest.mark.parametrize("size,stride,pad,cin,cout,hw", [
    (1, 1, 0, 16, 8, 9), (3, 1, 1, 8, 16, 10), (3, 2, 1, 5, 7, 11),
    (3, 1, 0, 4, 6, 7), (5, 1, 2, 3, 4, 8)])
@pytest.mark.parametrize("activation", ["leaky", "linear", "logistic"])
def test_conv_fp32_equals_yolotpu(size, stride, pad, cin, cout, hw, activation):
    rng = np.random.default_rng(size * 100 + cin)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((size, size, cin, cout)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    got = convops.conv_fp32(*map(torch.from_numpy, (x, w, b)), stride, pad,
                            activation).numpy()
    want = np.asarray(jconv.conv_fp32(*map(jnp.asarray, (x, w, b)), stride,
                                      pad, activation))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_pad_same_darknet_equals_yolotpu():
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 5)).astype(np.float32)
    for pad, value in ((0, 0.0), (1, 0.0), (2, -1.5)):
        want, _ = jconv.pad_same_darknet(jnp.asarray(x), 3, 1, pad, value)
        got = convops.pad_same_darknet(torch.from_numpy(x), pad, value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_fp32_turns_tf32_off_for_the_call_only(monkeypatch):
    """cuDNN's default is TF32 (allow_tf32 True); conv_fp32 runs its conv
    with it off and leaves the caller's flags as they were."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.enabled))
        return conv2d(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
              torch.backends.cudnn.benchmark)
    convops.conv_fp32(torch.ones(1, 4, 4, 2), torch.ones(3, 3, 2, 3),
                      torch.zeros(3), 1, 1, "linear")
    assert seen == [(False, before[1])]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled,
            torch.backends.cudnn.benchmark) == before


def test_normalize_u8_is_the_true_division():
    """All 256 values /255 as numpy divides them (126 of them differ from a
    multiplication by the reciprocal, which CUDA uses for a scalar)."""
    x = np.arange(256, dtype=np.uint8)
    got = convops.normalize_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x.astype(np.float32) / np.float32(255))
    recip = x.astype(np.float32) * (np.float32(1) / np.float32(255))
    assert (got != recip).sum() == 126


@pytest.mark.parametrize("model,size", [("yolov2", 64), ("yolov2-tiny", 96)])
def test_params_from_jax_equals_params_fp32(model, size):
    spec, store = _setup(model, size)
    jp = {k: {n: np.asarray(a) for n, a in v.items()}
          for k, v in jy.params_fp32(spec, store).items()}
    got = ty.params_from_jax(jp)
    want = ty.params_fp32(*_setup(model, size, port=True), "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert want[k]["b"].dtype == torch.float32   # not cut to int32
        for n in ("w", "b"):
            assert got[k][n].dtype == want[k][n].dtype == torch.float32
            assert torch.equal(got[k][n], want[k][n]), (k, n)


def _assert_close(got: dict, want: dict) -> None:
    head, want_head = got["head"].numpy(), np.asarray(want["head"])
    scale = float(np.abs(want_head).max())
    np.testing.assert_allclose(head, want_head, atol=1e-4 * scale, rtol=0)
    for k in ("boxes", "obj", "probs"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("model,size", CASES)
def test_fp32_forward_equals_yolotpu(model, size):
    spec, store = _setup(model, size, port=True)
    x = _frame(size)
    want = _jax_forward(model, size)(jnp.asarray(x))
    net = ty.YoloV2Q(spec, None, ty.params_fp32(spec, store), "cpu", "fp32")
    got = net(torch.from_numpy(x))
    assert set(got) == {"head", "boxes", "obj", "probs"}
    _assert_close(got, want)


@pytest.mark.parametrize("model,size", [("yolov2", 64), ("yolov2-tiny", 96)])
def test_fp32_forward_equals_the_golden_net(model, size):
    """The head against the port's numpy fp32 forward (CHW, im2col)."""
    spec, store = _setup(model, size, port=True)
    x = _frame(size)
    net = ty.YoloV2Q(spec, None, ty.params_fp32(spec, store), "cpu", "fp32")
    got = net(torch.from_numpy(x))["head"][0].permute(2, 0, 1).numpy()
    chw = (x[0].astype(np.float32) / np.float32(255)).transpose(2, 0, 1)
    want = GoldenNet(spec).forward_fp32(chw, store.fp32)[spec.n - 1]
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_fp32_is_the_engines_default():
    from yolotpu_torch.runtime.engine import Engine
    spec, store = _setup("yolov2", 64, port=True)
    eng = Engine(spec, store, device="cpu")
    assert eng.precision == "fp32" and eng.model.plan is None
    assert not eng.model.route and not hasattr(eng.model, "p0")
    frames = _frame(64).repeat(2, axis=0)
    heads = eng.predict_batch_rgb(frames)
    assert heads.shape == (2, 425, 2, 2) and np.isfinite(heads).all()
    np.testing.assert_array_equal(
        heads, eng.predict_batch(frames.transpose(0, 3, 1, 2) / np.float32(255)))
    with pytest.raises(ValueError, match="requires Q tables"):
        ty.YoloV2Q(spec, None, eng.params, "cpu", "int16")
