"""The plain versions of the port's four 8-bit-weight conv kernels
(yolotpu_torch.ops.q8) against the Pallas kernels they replace, run in
interpret mode on the CPU, and the port's conv routes of the int8 and w8a16
tiers against the JAX package's XLA routes:

  mm_s8_plain          == pallas_matmul.matmul_int8_requant        (K4)
  mm_s8_plain, int16   == pallas_matmul.matmul_int16_out_requant   (K4)
  mm_w8a16_plain       == pallas_matmul.matmul_w8a16_requant       (K5)
  conv3x3_w8a16_plain  == pallas_q16.conv3x3_w8a16_wi              (K6)
  conv3x3_s8_plain     == pallas_q16.conv3x3_s8_wi                 (K7)
  conv3x3_int8_plain   == pallas_conv.conv3x3_int8, conv3x3_int8_im2col (K13)

bit for bit, on the same seeded operands, with scalar shifts (broadcast to a
vector on the port's side) and per-channel shift vectors, at the shapes the
JAX suite runs (tests/test_int8_perchannel.py, tests/test_w8a16.py). Each
case draws a small bias and sizes its shift to the operands so that the
requantized sums span the output range, and asserts that at least half its
outputs are unsaturated. The w8a16 wrap cases build sums outside int32 that
wrap to small values; an int8 x int8 sum cannot wrap. The kernels themselves
run only on the card: chip_smoke.py holds them to these plain versions
there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yolotpu.ops import convops as jconv
from yolotpu.ops import pallas_q16 as pq16
from yolotpu.ops.pallas_matmul import (matmul_int8_requant,
                                       matmul_int16_out_requant,
                                       matmul_w8a16_requant)
from yolotpu_torch.ops import convops, q8

TARGET = {np.int8: 2**5, np.int16: 2**13}   # output spread the shifts aim at
XMAX = {np.int8: 127, np.int16: 32767}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(rng, xshape, wshape, xdtype, out_dtype, vector):
    """Full-range x (int8 or int16) and int8 w, extremes included; a shift
    per column (vector) or one for all, fitted so the requantized sums
    spread about TARGET; a bias small against that spread."""
    k = int(np.prod(wshape[:-1]))
    n = wshape[-1]
    xm = XMAX[xdtype]
    x = rng.integers(-xm - 1, xm + 1, xshape).astype(xdtype)
    x.flat[:2] = [-xm - 1, xm]
    w = rng.integers(-128, 128, wshape).astype(np.int8)
    w.flat[:2] = [-128, 127]
    base = int(round(np.log2(k ** 0.5 * xm * 127 / 3 / TARGET[out_dtype])))
    shift = (base + rng.integers(-1, 2, n) if vector
             else np.full(n, base)).astype(np.int32)
    bias = rng.integers(-TARGET[out_dtype] // 2, TARGET[out_dtype] // 2,
                        n).astype(np.int32)
    return x, w, bias, shift


def _unsaturated(out, leaky):
    lo, hi = np.iinfo(out.dtype).min, np.iinfo(out.dtype).max
    sat = (out == lo) | (out == hi)
    if leaky:
        sat |= out == -((-lo) // 10)
    return ~sat


def _jshift(shift, vector):
    return jnp.asarray(shift) if vector else int(shift[0])


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("m,k,n,leaky", [
    (256, 128, 128, True),
    (300, 128, 256, False),   # M padded on the TPU
])
def test_mm_s8_plain_equals_pallas(m, k, n, leaky, vector):
    x, w, b, s = _operands(np.random.default_rng(0), (m, k), (k, n), np.int8,
                           np.int8, vector)
    want = np.asarray(matmul_int8_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), _jshift(s, vector),
        leaky, interpret=True))
    got = q8.mm_s8(_t(x), _t(w), _t(b), _t(s), leaky).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("m,k,n,leaky", [
    (256, 128, 128, False),
    (96, 256, 128, True),
])
def test_mm_s8_int16_out_equals_pallas(m, k, n, leaky, vector):
    """The head16 epilogue: int16 output at shift - 8 with bias << 8."""
    x, w, b, s = _operands(np.random.default_rng(1), (m, k), (k, n), np.int8,
                           np.int8, vector)
    b16, s16 = convops.head16(_t(b), _t(s))
    want = np.asarray(matmul_int16_out_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b16.numpy()),
        _jshift(s16.numpy(), vector), leaky, interpret=True))
    got = q8.mm_s8(_t(x), _t(w), b16, s16, leaky, torch.int16).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int16
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("m,leaky", [(512, True), (300, False)])
def test_mm_w8a16_plain_equals_pallas(m, leaky):
    k = n = 128
    x, w, b, s = _operands(np.random.default_rng(7), (m, k), (k, n), np.int16,
                           np.int16, True)
    cw = jconv.prep_weights_w8a16(w.reshape(1, 1, k, n))
    want = np.asarray(matmul_w8a16_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cw), jnp.asarray(b),
        jnp.asarray(s), leaky=leaky, interpret=True))
    got = q8.mm_w8a16(_t(x), _t(w), _t(b), _t(s), leaky).numpy()
    np.testing.assert_array_equal(got, want)
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("c,n,leaky,vector", [
    (32, 64, True, True),       # C pads to 128 on the TPU
    (128, 128, False, False),   # scalar shift, no pad
])
def test_conv3x3_s8_plain_equals_pallas(c, n, leaky, vector):
    x, w, b, s = _operands(np.random.default_rng(23), (2, 16, 16, c),
                           (3, 3, c, n), np.int8, np.int8, vector)
    wp = pq16.prep_conv_weights_w8(w, b, s if vector else int(s[0]))
    want = pq16.conv3x3_s8_wi(jnp.asarray(x), wp, leaky=leaky, interpret=True)
    assert want is not None
    want = np.asarray(want)[..., :n]
    got = q8.conv3x3_s8(_t(x), _t(w), _t(b), _t(s), leaky).numpy()
    np.testing.assert_array_equal(got, want)
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("shape,leaky,vector", [
    ((2, 16, 16, 32, 64), True, True),      # C pads to 128; whole image
    ((1, 13, 13, 128, 128), False, False),  # odd spatial, no pad
])
def test_conv3x3_w8a16_plain_equals_pallas(shape, leaky, vector):
    bsz, h, wd, c, n = shape
    x, w, b, s = _operands(np.random.default_rng(17), (bsz, h, wd, c),
                           (3, 3, c, n), np.int16, np.int16, vector)
    wp = pq16.prep_conv_weights_w8(w, b, s if vector else int(s[0]))
    want = pq16.conv3x3_w8a16_wi(jnp.asarray(x), wp, leaky=leaky,
                                 interpret=True)
    assert want is not None
    want = np.asarray(want)[..., :n]
    got = q8.conv3x3_w8a16(_t(x), _t(w), _t(b), _t(s), leaky).numpy()
    np.testing.assert_array_equal(got, want)
    assert _unsaturated(want, leaky).mean() > 0.5


def _wrap_operands(rng, rows, taps, n, shift, nblk=2, npair=8, ns=112):
    """x (rows, C) int16, w (taps, C, N) int8 whose exact sums leave int32
    but wrap to small values, C = nblk*1024 + 2*npair + ns in shuffled order:
    blocks of 1024 channels at -32768 or 0 in x and -128 or 0 in w (1024
    products of 2^22 add a multiple of 2^32), pairs (v, -v) x (u, u) at
    +-32767 and +-127 that cancel, and ns channels sized to the shift."""
    blk = 1024
    c = nblk * blk + 2 * npair + ns
    x = np.zeros((rows, c), np.int64)
    w = np.zeros((taps, c, n), np.int64)
    for i in range(nblk):
        x[:, i * blk:(i + 1) * blk] = np.where(rng.random((rows, 1)) < 0.5,
                                               -32768, 0)
        w[:, i * blk:(i + 1) * blk] = np.where(rng.random((taps, 1, n)) < 0.5,
                                               -128, 0)
    p = nblk * blk
    v = rng.choice([-32767, 32767], (rows, npair))
    u = rng.choice([-127, 127], (taps, npair, n))
    x[:, p:p + npair], x[:, p + npair:p + 2 * npair] = v, -v
    w[:, p:p + npair], w[:, p + npair:p + 2 * npair] = u, u
    r = int(min(32767, 3 * TARGET[np.int16] * 2.0 ** shift
                / (taps * ns) ** 0.5 / 127))
    x[:, p + 2 * npair:] = rng.integers(-r, r + 1, (rows, ns))
    w[:, p + 2 * npair:] = rng.integers(-127, 128, (taps, ns, n))
    perm = rng.permutation(c)
    bias = rng.integers(-2**12, 2**12, n).astype(np.int32)
    return x[:, perm].astype(np.int16), w[:, perm].astype(np.int8), bias


@pytest.mark.parametrize("shift", [0, 3, 9])
def test_mm_w8a16_plain_wraps_like_pallas(shift):
    n = 128
    x, w, b = _wrap_operands(np.random.default_rng(4), 40, 1, n, shift)
    w = w[0]
    s = np.full(n, shift, np.int32)
    cw = jconv.prep_weights_w8a16(w[None, None])
    want = np.asarray(matmul_w8a16_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cw), jnp.asarray(b),
        jnp.asarray(s), leaky=True, interpret=True))
    got = q8.mm_w8a16(_t(x), _t(w), _t(b), _t(s), True).numpy()
    np.testing.assert_array_equal(got, want)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert (_unsaturated(got, True) & (np.abs(exact) >= 2**31)).mean() > 0.1
    assert _unsaturated(got, True).mean() > 0.5


def test_conv3x3_w8a16_plain_wraps_like_xla():
    bsz, h, wd, n, shift = 1, 5, 4, 16, 5
    x, w, b = _wrap_operands(np.random.default_rng(5), bsz * h * wd, 9, n,
                             shift)
    c = x.shape[-1]
    x, w = x.reshape(bsz, h, wd, c), w.reshape(3, 3, c, n)
    s = np.full(n, shift, np.int32)
    want = np.asarray(jconv.conv_w8a16(
        jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(jconv.prep_weights_w8a16(w)), jnp.asarray(b), 1, 1,
        "linear", jnp.asarray(s)))
    got = q8.conv3x3_w8a16(_t(x), _t(w), _t(b), _t(s), False).numpy()
    np.testing.assert_array_equal(got, want)
    from yolotpu_torch.ops import q16
    exact = q16.conv3x3_sum64(_t(x), _t(w)).numpy()
    assert (_unsaturated(got, False) & (np.abs(exact) >= 2**31)).mean() > 0.1
    assert _unsaturated(got, False).mean() > 0.5


@pytest.mark.parametrize("case", [
    # (B, H, W, C, N, size, activation, head16, per-channel shift)
    (2, 12, 10, 3, 32, 3, "leaky", False, True),     # the C=3 entry conv
    (1, 7, 9, 64, 48, 3, "linear", False, False),
    (2, 5, 7, 96, 425, 1, "linear", True, True),     # the head: N=425, head16
    (1, 13, 13, 64, 425, 1, "linear", True, False),
    (3, 5, 5, 40, 70, 1, "leaky", False, True),      # ragged M, K, N
])
def test_conv_int8_routes_equal_xla(case):
    """The model's int8 conv routes (conv3x3_s8, mm_s8, and mm_s8 with the
    head16 epilogue) == convops.conv_int8 on XLA."""
    bsz, h, wd, c, n, size, act, h16, vector = case
    rng = np.random.default_rng(11)
    x, w, b, s = _operands(rng, (bsz, h, wd, c), (size, size, c, n), np.int8,
                           np.int8, vector)
    want = np.asarray(jconv.conv_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1, size // 2, act,
        s if vector else int(s[0]), head16=h16))
    leaky = act == "leaky"
    bt, st = _t(b), _t(s)
    if size == 1:
        kw = {}
        if h16:
            bt, st = convops.head16(bt, st)
            kw = {"out_dtype": torch.int16}
        got = q8.mm_s8(_t(x).reshape(-1, c), _t(w[0, 0]), bt, st, leaky, **kw)
        got = got.reshape(bsz, h, wd, n).numpy()
    else:
        got = q8.conv3x3_s8(_t(x), _t(w), bt, st, leaky).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == (np.int16 if h16 else np.int8)
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("case", [
    # (B, H, W, C, N, size, activation, per-channel shift)
    (2, 12, 10, 3, 32, 3, "leaky", True),       # the C=3 entry conv
    (1, 9, 7, 24, 40, 3, "linear", False),
    (2, 5, 7, 96, 425, 1, "linear", True),      # the head: N=425
    (3, 5, 5, 40, 70, 1, "leaky", True),        # ragged M, K, N
])
def test_conv_w8a16_routes_equal_xla(case):
    """The model's w8a16 conv routes (conv3x3_w8a16, mm_w8a16) ==
    convops.conv_w8a16 on XLA (the plane-stacked s8 conv)."""
    bsz, h, wd, c, n, size, act, vector = case
    rng = np.random.default_rng(13)
    x, w, b, s = _operands(rng, (bsz, h, wd, c), (size, size, c, n), np.int16,
                           np.int16, vector)
    want = np.asarray(jconv.conv_w8a16(
        jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(jconv.prep_weights_w8a16(w)), jnp.asarray(b), 1,
        size // 2, act, jnp.asarray(s) if vector else int(s[0])))
    leaky = act == "leaky"
    if size == 1:
        got = q8.mm_w8a16(_t(x).reshape(-1, c), _t(w[0, 0]), _t(b), _t(s),
                          leaky).reshape(bsz, h, wd, n).numpy()
    else:
        got = q8.conv3x3_w8a16(_t(x), _t(w), _t(b), _t(s), leaky).numpy()
    np.testing.assert_array_equal(got, want)
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("shift", [0, 3, 17])
def test_round_shift_vec_wraps_like_jax(shift):
    rng = np.random.default_rng(shift)
    v = rng.integers(-2**31, 2**31, (64, 9)).astype(np.int32)
    v[0] = [-2**31, 2**31 - 1, -1, 0, 1, -2**31, 2**31 - 1, 7, -7]
    s = (np.array([-40, -3, -1, 0, 1, 7, 30, 31, 40]) + shift).astype(np.int32)
    got = convops.round_shift_vec(_t(v), _t(s)).numpy()
    want = np.asarray(jconv.round_shift_vec(jnp.asarray(v), jnp.asarray(s)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("q", [-2, 0, 4, 7])
def test_quantize_input_int8_like_jax(q):
    rng = np.random.default_rng(q + 10)
    x = (rng.random((3, 17, 5)).astype(np.float32) * 2 - 1) * np.float32(
        2.0 ** (7 - q))
    # exact halves, the clamp edges and beyond
    x.flat[:6] = np.array([0.5, -0.5, 1.5, -2.5, 127.5, -128.5],
                          np.float32) * np.float32(2.0 ** -q)
    x.flat[6:8] = [1e9, -1e9]
    got = convops.quantize_input_int8(_t(x), q).numpy()
    want = np.asarray(jconv.quantize_input_int8(jnp.asarray(x), q))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8


def test_wrappers_check_operands():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    b = torch.zeros(3, dtype=torch.int32)
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        q8.mm_s8(x.to(torch.int16), w, b, s, False)
    with pytest.raises(TypeError):
        q8.mm_w8a16(x, w, b, s, False)
    with pytest.raises(ValueError):   # shift of the wrong shape
        q8.mm_s8(x, w, b, s[:2], False)
    with pytest.raises(ValueError):   # shift of the wrong dtype
        q8.mm_s8(x, w, b, s.to(torch.int64), False)
    with pytest.raises(ValueError):
        q8.mm_s8(x, w, b, s, False, torch.int32)
    with pytest.raises(ValueError):   # a 3x3 conv needs (3, 3, C, N) weights
        q8.conv3x3_s8(x.reshape(1, 2, 2, 8), w, b, s, False)
    with pytest.raises(ValueError):   # neither CPU nor CUDA: no silent path
        q8.conv3x3_w8a16(x.to(torch.int16).reshape(1, 2, 2, 8).to("meta"),
                         torch.zeros((3, 3, 8, 3), dtype=torch.int8,
                                     device="meta"),
                         b.to("meta"), s.to("meta"), False)
    assert q8.LAUNCHES == dict.fromkeys(q8.LAUNCHES, 0)


@pytest.mark.parametrize("shift,bound", [(12, 127), (7, 20), (0, 2), (-2, 1)])
def test_conv3x3_int8_plain_equals_pallas_conv(shift, bound):
    """K13, a scalar-shift int8 conv, at the shape of
    tests/test_int8_pallas.py: both Pallas variants == the port's
    conv3x3_int8 (conv3x3_s8 with the shift broadcast), operands sized so
    the requantized sums span the int8 range at each shift."""
    from yolotpu.ops.pallas_conv import conv3x3_int8, conv3x3_int8_im2col
    b, h, w_, c, n = 2, 16, 20, 32, 64
    rng = np.random.default_rng(13)
    x = rng.integers(-bound, bound + 1, (b, h, w_, c)).astype(np.int8)
    x.flat[:2] = [-128, 127]
    w = rng.integers(-bound, bound + 1, (3, 3, c, n)).astype(np.int8)
    w.flat[:2] = [-128, 127]
    bias = rng.integers(-16, 16, n).astype(np.int32)
    got = q8.conv3x3_int8_plain(_t(x), _t(w), _t(bias), shift, True).numpy()
    for fn in (conv3x3_int8, conv3x3_int8_im2col):
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                             shift, True, th=8, interpret=True))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        q8.conv3x3_int8(_t(x), _t(w), _t(bias), shift, True).numpy(), got)
    assert ((got != 127) & (got != -128) & (got != -12)).mean() > 0.5
    assert q8.LAUNCHES["conv3x3_int8"] == 0
