"""The plain versions of the port's two conv kernels (yolotpu_torch.ops.q16)
against the Pallas kernels they replace, run in interpret mode on the CPU:

  mm_q16_plain       == pallas_q16.matmul_q16_requant      (K1)
  conv3x3_q16_plain  == pallas_q16.conv3x3_q16_flat        (K2)
                     == pallas_q16.conv3x3_q16_requant     (K3)

bit for bit, on the same seeded int16 operands, with the Pallas side using
the weight packs of prep_matmul_weights / prep_conv_weights. The operands
are drawn so that the requantized sums span the int16 range at each case's
shift, and each case asserts that most outputs are unsaturated, so the
outputs depend on the sums; the wrap cases build sums far outside int32
that wrap to small values. The shift, leaky and weight-encoding extremes
are those of tests/test_q16_kernels.py. The kernels themselves run only on
the card: chip_smoke.py holds them to these plain versions there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yolotpu.ops import convops as jconv
from yolotpu.ops import pallas_q16 as pq16
from yolotpu.ops import pool as jpool
from yolotpu_torch.ops import pool, q16


def _span(shift, k):
    """Operand bound r such that K products of two uniform [-r, r] draws,
    requantized by shift, span about +-2^13; capped at the int16 range."""
    m = min(shift, 30) if shift > 0 else shift
    return int(min(32767, max(1, (3 * 2.0 ** (13 + m) / k ** 0.5) ** 0.5)))


def _operands(rng, xshape, wshape, shift, wmax=32767):
    r = _span(shift, int(np.prod(wshape[:-1])))
    x = rng.integers(-r, r + 1, xshape).astype(np.int16)
    x.flat[:2] = [-32768, 32767]
    w = np.minimum(rng.integers(-r, r + 1, wshape), wmax).astype(np.int16)
    w.flat[:2] = [-32768, wmax]
    bias = rng.integers(-2**14, 2**14, wshape[-1]).astype(np.int32)
    return x, w, bias


def _wrap_operands(rng, rows, taps, n, shift, nblk=2, npair=4, ns=21):
    """x (rows, C), w (taps, C, N) whose exact sums reach 2^40 but wrap to
    small values: blocks of 512 channels at -32768 or 0 (each adds a
    multiple of 2^32), pairs (v, -v) x (u, u) at +-32767 that cancel, and
    ns channels in +-_span(shift, taps*ns); channels shuffled."""
    c = nblk * 512 + 2 * npair + ns
    x = np.zeros((rows, c), np.int64)
    w = np.zeros((taps, c, n), np.int64)
    for i in range(nblk):
        x[:, i * 512:(i + 1) * 512] = np.where(rng.random((rows, 1)) < 0.5, -32768, 0)
        w[:, i * 512:(i + 1) * 512] = np.where(rng.random((taps, 1, n)) < 0.5, -32768, 0)
    p = nblk * 512
    v = rng.choice([-32767, 32767], (rows, npair))
    u = rng.choice([-32767, 32767], (taps, npair, n))
    x[:, p:p + npair], x[:, p + npair:p + 2 * npair] = v, -v
    w[:, p:p + npair], w[:, p + npair:p + 2 * npair] = u, u
    r = _span(shift, taps * ns)
    x[:, p + 2 * npair:] = rng.integers(-r, r + 1, (rows, ns))
    w[:, p + 2 * npair:] = rng.integers(-r, r + 1, (taps, ns, n))
    perm = rng.permutation(c)
    bias = rng.integers(-2**14, 2**14, n).astype(np.int32)
    return x[:, perm].astype(np.int16), w[:, perm].astype(np.int16), bias


def _unsaturated(out, leaky):
    sat = (out == 32767) | (out == -32768)
    if leaky:
        sat |= out == -3276
    return ~sat


@pytest.mark.parametrize("shape,shift,leaky,wmax", [
    ((96, 48, 40), 7, True, 32767),      # N padded on the TPU, unbalanced w
    ((128, 27, 32), 5, False, 32639),    # balanced weight split
    ((200, 128, 64), 31, True, 32767),   # shift capped at 30
    ((96, 260, 130), -3, True, 32639),   # left shift, ragged K and N
    ((64, 1030, 425), 40, False, 32767),  # K > 1024 (K steps), head N=425
    ((50, 64, 16), 0, True, 32767),
])
def test_mm_q16_plain_equals_pallas(shape, shift, leaky, wmax):
    m, k, n = shape
    x, w, bias = _operands(np.random.default_rng(1), (m, k), (k, n), shift, wmax)
    wp = pq16.prep_matmul_weights(w, bias)
    assert wp["bal"] == (wmax <= 32639)
    want = np.asarray(pq16.matmul_q16_requant(jnp.asarray(x), wp, shift, leaky,
                                              interpret=True))
    got = q16.mm_q16_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(bias), shift, leaky)
    np.testing.assert_array_equal(got.numpy(), want)
    # on CPU tensors the wrapper is the plain version
    got_w = q16.mm_q16(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(bias), shift, leaky)
    np.testing.assert_array_equal(got_w.numpy(), want)
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("shape,shift,leaky,wmax", [
    ((2, 12, 11, 32, 40), 9, True, 32767),
    ((1, 13, 13, 130, 24), 6, False, 32639),   # ragged C, odd H*W
    ((2, 8, 9, 128, 64), 31, True, 32639),
    ((1, 7, 5, 64, 70), -3, False, 32767),
    ((2, 6, 6, 16, 16), 40, True, 32639),
])
def test_conv3x3_q16_plain_equals_pallas(shape, shift, leaky, wmax):
    b, h, w_, c, n = shape
    x, w, bias = _operands(np.random.default_rng(2), (b, h, w_, c),
                           (3, 3, c, n), shift, wmax)
    # lane-aligned channel padding, as the TPU model's conv3 packs
    wp = pq16.prep_conv_weights(w, bias, cp=-(-c // 128) * 128)
    flat = pq16.conv3x3_q16_flat(jnp.asarray(x), wp, shift, leaky,
                                 interpret=True)
    assert flat is not None
    banded = pq16.conv3x3_q16_requant(jnp.asarray(x), wp, shift, leaky,
                                      interpret=True)
    got = q16.conv3x3_q16(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(bias), shift, leaky).numpy()
    np.testing.assert_array_equal(got, np.asarray(flat)[..., :n])
    np.testing.assert_array_equal(got, np.asarray(banded)[..., :n])
    assert _unsaturated(got, leaky).mean() > 0.5


@pytest.mark.parametrize("shift", [0, -3, 31])
def test_mm_q16_plain_wraps_like_pallas(shift):
    """Sums built to reach 2^40 and wrap to small values (mod 2^32), with
    weights and inputs at -32768 and +-32767."""
    x, w, bias = _wrap_operands(np.random.default_rng(4), 40, 1, 24, shift)
    w = w[0]
    wp = pq16.prep_matmul_weights(w, bias)
    want = np.asarray(pq16.matmul_q16_requant(jnp.asarray(x), wp, shift, True,
                                              interpret=True))
    got = q16.mm_q16_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(bias), shift, True).numpy()
    np.testing.assert_array_equal(got, want)
    exact = q16.mm_sum64(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert (_unsaturated(got, True) & (np.abs(exact) >= 2**31)).mean() > 0.25


@pytest.mark.parametrize("shift", [0, 31])
def test_conv3x3_q16_plain_wraps_like_pallas(shift):
    b, h, w_, n = 1, 5, 4, 16
    x, w, bias = _wrap_operands(np.random.default_rng(5), b * h * w_, 9, n, shift)
    c = x.shape[-1]
    x, w = x.reshape(b, h, w_, c), w.reshape(3, 3, c, n)
    wp = pq16.prep_conv_weights(w, bias, cp=-(-c // 128) * 128)
    flat = pq16.conv3x3_q16_flat(jnp.asarray(x), wp, shift, False,
                                 interpret=True)
    assert flat is not None
    got = q16.conv3x3_q16_plain(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(bias), shift, False).numpy()
    np.testing.assert_array_equal(got, np.asarray(flat)[..., :n])
    exact = q16.conv3x3_sum64(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert (_unsaturated(got, False) & (np.abs(exact) >= 2**31)).mean() > 0.25


@pytest.mark.parametrize("shift,act", [(7, "leaky"), (5, "linear"),
                                       (31, "leaky")])
def test_entry_conv_then_pool(shift, act):
    """The C=3 entry conv through conv3x3_q16 then the darknet 2x2/s2 pool
    == XLA's s16 conv then the pool, and == the TPU plan's fused entry (one
    4x4/s2 conv, group-max on the int32 accumulator), saturation extremes
    included.

    The fused form takes the max before the requant, which is the same only
    while acc + 2^(shift-1) does not wrap; at shift 31 full-range operands
    make it wrap, so there the fused form is not compared."""
    b, h, w_, c, n = 2, 20, 16, 3, 32
    rng = np.random.default_rng(15)
    r = _span(shift, 9 * c)
    x = rng.integers(-r, r + 1, (b, h, w_, c)).astype(np.int16)
    x[0, 0] = 32767
    x[1, -1] = -32768
    w = rng.integers(-r, r + 1, (3, 3, c, n)).astype(np.int16)
    bias = rng.integers(-2**14, 2**14, n).astype(np.int32)
    conv = q16.conv3x3_q16_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), shift, act == "leaky")
    got = pool.maxpool(conv, 2, 2, 0).numpy()
    xla = jconv.conv_int16(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                           1, 1, act, shift)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got, np.asarray(jpool.maxpool(xla, 2, 2, 0)))
    assert _unsaturated(conv.numpy(), act == "leaky").mean() > 0.5
    if shift < 31:
        fused = jconv.conv_pool_entry_sd(
            jnp.asarray(x.transpose(0, 3, 1, 2)),
            jnp.asarray(jconv.make_entry_sd_weights(w, n)), jnp.asarray(bias),
            shift, act)
        np.testing.assert_array_equal(got, np.asarray(fused))


def test_prep_weights_layouts():
    rng = np.random.default_rng(3)
    w1 = torch.from_numpy(rng.integers(-9, 9, (1, 1, 6, 5)).astype(np.int16))
    w3 = torch.from_numpy(rng.integers(-9, 9, (3, 3, 6, 5)).astype(np.int16))
    t1, t3 = q16.prep_weights(w1), q16.prep_weights(w3)
    assert t1.shape == (6, 5) and t3.shape == (3, 3, 6, 5)
    assert t1.dtype == t3.dtype == torch.int16
    assert t1.is_contiguous() and t3.is_contiguous()
    assert torch.equal(t1, w1[0, 0]) and torch.equal(t3, w3)


def test_wrappers_check_operands():
    x = torch.zeros((4, 8), dtype=torch.int16)
    w = torch.zeros((8, 3), dtype=torch.int16)
    b = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        q16.mm_q16(x.to(torch.int32), w, b, 0, False)
    with pytest.raises(ValueError):
        q16.mm_q16(x, w[:5], b, 0, False)
    with pytest.raises(ValueError):
        q16.conv3x3_q16(x.reshape(1, 2, 2, 8), torch.zeros(
            (3, 3, 4, 3), dtype=torch.int16), b, 0, False)
    with pytest.raises(ValueError):   # neither CPU nor CUDA: no silent path
        q16.mm_q16(x.to("meta"), w.to("meta"), b.to("meta"), 0, False)
    assert q16.LAUNCHES == {"mm_q16": 0, "conv3x3_q16": 0}
