"""The port's integer and region ops (yolotpu_torch.ops) against the JAX
package's (yolotpu.ops), on the same seeded numpy inputs, on the CPU.

Integer ops must be bit-equal. decode_region runs fp32 exp, sigmoid and
softmax, whose XLA and PyTorch implementations differ by a few ulps, so it
is held to atol=1e-6, rtol=1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yolotpu.models import zoo
from yolotpu.ops import convops as jconv
from yolotpu.ops import pool as jpool
from yolotpu.ops import region as jregion
from yolotpu.ops import reorg as jreorg
from yolotpu_torch.ops import convops, pool, region, reorg

SHIFTS = (-3, -1, 0, 1, 7, 30, 31, 40)


def _i32(rng, shape):
    v = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    v.flat[:4] = [-2**31, 2**31 - 1, -1, 0]       # the wrap extremes
    return v


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", SHIFTS)
def test_round_shift_wraps_like_jax(shift):
    v = _i32(np.random.default_rng(0), (4096,))
    _eq(convops.round_shift(torch.from_numpy(v), shift),
        jconv.round_shift(jnp.asarray(v), shift))


def test_sat16_and_leaky_int16():
    rng = np.random.default_rng(1)
    v = rng.integers(-70000, 70000, 8192).astype(np.int32)
    v[:6] = [-32768, -32769, 32767, 32768, -1, -10]
    _eq(convops.sat16(torch.from_numpy(v)), jconv.sat16(jnp.asarray(v)))
    s = np.clip(v, -32768, 32767)
    _eq(convops.leaky_int16(torch.from_numpy(s)),
        jconv.leaky_int16(jnp.asarray(s)))


@pytest.mark.parametrize("shift,leaky", [(7, True), (-2, False), (31, True),
                                         (0, False)])
def test_requant32_matches_pallas_epilogue(shift, leaky):
    from yolotpu.ops import pallas_q16
    rng = np.random.default_rng(2)
    acc = _i32(rng, (64, 48))
    bias = _i32(rng, (48,))
    want = pallas_q16._requant32(jnp.asarray(acc), jnp.asarray(bias), shift,
                                 leaky)
    _eq(convops.requant32(torch.from_numpy(acc), torch.from_numpy(bias),
                          shift, leaky), want)


@pytest.mark.parametrize("q", [14, 8, 0, -2])
def test_quantize_input_int16_rounds_half_away(q):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    step = np.float32(2.0 ** -q)
    # exact ties (k + 0.5) * 2^-q of both signs, and values past the clamp
    ties = (np.arange(-40, 40, dtype=np.float32) + np.float32(0.5)) * step
    big = np.array([1e9, -1e9, 40000 * step, -40000 * step], np.float32)
    x = np.concatenate([x, ties, big])
    _eq(convops.quantize_input_int16(torch.from_numpy(x), q),
        jconv.quantize_input_int16(jnp.asarray(x), q))
    _eq(convops.dequantize_int16(torch.from_numpy(x.astype(np.int16)), q),
        jconv.dequantize_int16(jnp.asarray(x.astype(np.int16)), q))


@pytest.mark.parametrize("shift", [1, 3, 0, -2])
def test_realign_int16(shift):
    rng = np.random.default_rng(4)
    x = rng.integers(-32768, 32768, (2, 5, 5, 16)).astype(np.int16)
    x.flat[:2] = [-32768, 32767]
    _eq(convops.realign_int16(torch.from_numpy(x), shift),
        jconv.realign_int16(jnp.asarray(x), shift))


@pytest.mark.parametrize("hw,size,stride,padding", [
    (16, 2, 2, 0),      # yolov2's non-overlapping pools
    (13, 2, 1, 1),      # tiny's 2x2/s1 with bottom/right padding
    (9, 3, 2, 2),
    (7, 2, 2, 1),       # odd input: padded window at the edge
])
def test_maxpool_int16(hw, size, stride, padding):
    rng = np.random.default_rng(5)
    x = rng.integers(-32768, 32768, (2, hw, hw, 8)).astype(np.int16)
    x[..., 0] = -32768                # the pad value itself must not leak
    _eq(pool.maxpool(torch.from_numpy(x), size, stride, padding),
        jpool.maxpool(jnp.asarray(x), size, stride, padding))


@pytest.mark.parametrize("hw,c,stride", [(26, 64, 2), (8, 12, 2), (6, 18, 3)])
def test_reorg(hw, c, stride):
    rng = np.random.default_rng(6)
    x = rng.integers(-32768, 32768, (2, hw, hw, c)).astype(np.int16)
    _eq(reorg.reorg(torch.from_numpy(x), stride),
        jreorg.reorg(jnp.asarray(x), stride))


@pytest.mark.parametrize("model,softmax,background", [
    ("yolov2", True, False), ("yolov2-voc", True, False),
    ("yolov2", False, False), ("yolov2", True, True), ("yolov2", False, True),
])
def test_decode_region(model, softmax, background):
    import dataclasses
    spec = zoo.build(model, width=64, height=64).region
    spec = dataclasses.replace(spec, softmax=softmax, background=background)
    oc = spec.num * (spec.coords + spec.classes + 1)
    rng = np.random.default_rng(7)
    head = (rng.standard_normal((2, spec.h, spec.w, oc)) * 4).astype(np.float32)
    got = region.decode_region(torch.from_numpy(head), spec)
    want = jregion.decode_region(jnp.asarray(head), spec)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)
