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

The tensor-core kernels' arithmetic is held here through ``tc.emulate``
(scheme Q16), which sums from the packed weight planes (``pack_q16``) and
the split
activations as the kernels do: equal to the exact sums modulo 2^32
(``acc32(mm_sum64)``) and to XLA's int32 dot and conv, at operands at
-32768, -32513 and 32767, ragged K, N=425, and K=33000, where an unchunked
middle sum would leave s32.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax
import pytest
import torch

from yolotpu.ops import convops as jconv
from yolotpu.ops import pallas_q16 as pq16
from yolotpu.ops import pool as jpool
from yolotpu_torch.ops import convops, pool, q16, tc


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
    assert q16.LAUNCHES == {"mm_q16": 0, "conv3x3_q16": 0,
                            "conv3x3_pool_q16": 0, "conv_q16": 0}


def _split_case(rng, m, k, n, values=None):
    draw = ((lambda shape: rng.choice(values, shape)) if values is not None
            else (lambda shape: rng.integers(-32768, 32768, shape)))
    return draw((m, k)).astype(np.int16), draw((k, n)).astype(np.int16)


@pytest.mark.parametrize("m,k,n,values", [
    (40, 96, 64, (-32768, -32513, 32767)),   # the byte planes' extremes
    (37, 300, 70, None),                     # K not a multiple of 32
    (20, 1024, 425, None),                   # the head's N
    (9, 27, 32, (-32768, -32513, 32767, 0, 1, -1, 255, -256)),   # entry K
])
def test_split_sum_equals_exact_and_xla(m, k, n, values):
    x, w = _split_case(np.random.default_rng(k), m, k, n, values)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tc.emulate(tx, q16.pack_q16(tw), k, n, tc.Q16)
    assert got.dtype == torch.int32
    assert torch.equal(got, q16.acc32(q16.mm_sum64(tx, tw)))
    # the int32 dot of yolotpu's convops.conv_int16 1x1 path
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_sum_requant_equals_pallas():
    x, w, bias = _operands(np.random.default_rng(6), (64, 300), (300, 70), 7)
    sums = tc.emulate(torch.from_numpy(x),
                      q16.pack_q16(torch.from_numpy(w)), 300, 70, tc.Q16)
    got = convops.requant32(sums, torch.from_numpy(bias), 7, True)
    want = pq16.matmul_q16_requant(jnp.asarray(x),
                                   pq16.prep_matmul_weights(w, bias), 7, True,
                                   interpret=True)
    np.testing.assert_array_equal(got.to(torch.int16).numpy(), np.asarray(want))


def test_split_sum_chunks_a_long_k():
    """K = 33000 at -32513 (high byte -128, low byte 255): the middle sum
    over all of K is -65280 * 33000 < -2^31, so it is cut at tc.KMAX."""
    k, n = 33000, 8
    x = np.full((3, k), -32513, np.int16)
    w = np.full((k, n), -32513, np.int16)
    assert (-128 * 255 * 2) * k < -2 ** 31 <= (-128 * 255 * 2) * tc.KMAX
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tc.emulate(tx, q16.pack_q16(tw), k, n, tc.Q16)
    assert torch.equal(got, q16.acc32(q16.mm_sum64(tx, tw)))
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the kernel cuts the same K into at least two splits
    kps = tc.split(3, n, k, 132, tc.Q16)
    assert -(-k // (kps * tc.Q16.bk)) >= 2 and kps * tc.Q16.bk <= tc.KMAX


@pytest.mark.parametrize("b,h,w_,c,n", [(2, 7, 5, 3, 40), (1, 6, 6, 40, 70)])
def test_split_sum_of_im2col_equals_conv(b, h, w_, c, n):
    rng = np.random.default_rng(c)
    x = rng.integers(-32768, 32768, (b, h, w_, c)).astype(np.int16)
    w = rng.integers(-32768, 32768, (3, 3, c, n)).astype(np.int16)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tc.emulate(q16.im2col3x3(tx), q16.pack_q16(tw), 9 * c, n,
                     tc.Q16)
    assert torch.equal(got.reshape(b, h, w_, n),
                       q16.acc32(q16.conv3x3_sum64(tx, tw)))
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.reshape(b, h, w_, n).numpy(),
                                  np.asarray(want))


def test_pack_q16_layout():
    """Byte (g, h, r, e) of plane 0 (high) or 1 (low) in block (nb, kc) is
    that byte of w[32 kc + FRAG_K[16 h + e], 64 nb + 8 g + r]; K and N are
    padded with zeros to the tile."""
    k, n = 70, 100
    w = np.random.default_rng(9).integers(-32768, 32768, (k, n)).astype(np.int16)
    planes = q16.pack_q16(torch.from_numpy(w)).numpy()
    assert planes.shape == tc.Q16.planes_shape(k, n) == (2, 4, 2, 8, 2, 8, 16)
    assert sorted(tc.FRAG_K[:16]) == list(range(16))
    assert sorted(tc.FRAG_K[16:]) == list(range(16, 32))
    wp = np.zeros((128, 128), np.int64)
    wp[:k, :n] = w
    rng = np.random.default_rng(10)
    for _ in range(300):
        nb, kc, g, h, r, e = (int(rng.integers(0, d)) for d in (2, 4, 8, 2, 8, 16))
        v = wp[32 * kc + tc.FRAG_K[16 * h + e], 64 * nb + 8 * g + r]
        assert planes[nb, kc, 0, g, h, r, e] == (v >> 8) & 255
        assert planes[nb, kc, 1, g, h, r, e] == v & 255


# (M, N, K, splits): the yolov2 416 shapes at batch 1 and 8 as the split
# sweep of chip_smoke.py timed them on the card, and K beyond one s32 sum
@pytest.mark.parametrize("m,n,k,want", [
    (169, 1024, 9216, 8),       # 13x13 3x3 at b=1: 48 tiles for 132 SMs
    (169, 512, 1024, 1),        # 13x13 1x1 at b=1: a split saves nothing
    (676, 512, 2304, 4),        # 26x26 3x3 at b=1
    (2704, 256, 1152, 1),       # 52x52 3x3 at b=1: two splits were slower
    (1352, 1024, 11520, 1),     # 13x13 at b=8: tiles enough
    (2 * 416 * 416, 32, 27, 1),
    (8 * 104 * 104, 128, 576, 1),
    (200, 72, 33000, None)])    # more than one s32 partial sum
def test_tc_split(m, n, k, want):
    kps = tc.split(m, n, k, 132, tc.Q16)
    ktiles = -(-k // tc.Q16.bk)
    splits = -(-ktiles // kps)
    assert 1 <= kps and kps * tc.Q16.bk <= tc.KMAX
    if want is None:
        assert splits >= 2
    else:
        assert splits == want


def test_planes_are_checked():
    with pytest.raises(TypeError, match="pack_q16"):
        tc.check_planes("mm_q16", None, 64, 64, torch.device("cpu"),
                        tc.Q16)
    good = q16.pack_q16(torch.zeros((64, 64), dtype=torch.int16))
    tc.check_planes("mm_q16", good, 64, 64, torch.device("cpu"), tc.Q16)
    with pytest.raises(ValueError, match="planes"):
        tc.check_planes("mm_q16", good, 128, 64, torch.device("cpu"),
                        tc.Q16)
    with pytest.raises(ValueError, match="planes"):
        tc.check_planes("mm_q16", good.view(torch.int8), 64, 64,
                        torch.device("cpu"), tc.Q16)
