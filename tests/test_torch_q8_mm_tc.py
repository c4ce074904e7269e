"""The arithmetic and the weight layout of the 8-bit tiers' tensor-core 1x1
convs (yolotpu_torch.ops.q8: mm_s8 with its int8 and int16 outputs on the S8
scheme, mm_w8a16 on the W8A16 scheme of csrc/igemm_tc.cuh) against the JAX
package, on the CPU.

The kernels run only on the card (chip_smoke.py holds them to their plain
versions there). What they compute is held here through ``tc.emulate``,
which sums from the packed weight plane (``q8.pack_s8``, ``q8.pack_w8a16``)
and the activations split as the kernels split them, with every s32 partial
sum checked: equal to the exact sums modulo 2^32, to XLA's int32 dot, and,
through the port's per-channel requant, to the Pallas kernels they replace
(``pallas_matmul.matmul_int8_requant``, ``matmul_int16_out_requant``,
``matmul_w8a16_requant``, interpret mode). Every comparison is bit-equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yolotpu.ops import convops as jconv
from yolotpu.ops.pallas_matmul import (matmul_int8_requant,
                                       matmul_int16_out_requant,
                                       matmul_w8a16_requant)
from yolotpu_torch.ops import convops, q8, q16, tc

SCHEMES = {"s8": (tc.S8, np.int8, q8.pack_s8),
           "w8a16": (tc.W8A16, np.int16, q8.pack_w8a16)}
TARGET = {np.int8: 2**5, np.int16: 2**13}   # output spread the shifts aim at
EXTREMES = {np.int8: (-128, 127), np.int16: (-32768, -32513, 32767)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _unsaturated(out, leaky):
    lo, hi = np.iinfo(out.dtype).min, np.iinfo(out.dtype).max
    sat = (out == lo) | (out == hi)
    if leaky:
        sat |= out == -((-lo) // 10)
    return ~sat


def _operands(rng, m, k, n, xdtype, vector):
    """Full-range x and int8 w, extremes included; a shift per column
    (vector) or one for all, fitted so the requantized sums spread about
    TARGET; a bias small against that spread."""
    xm = int(np.iinfo(xdtype).max)
    x = rng.integers(-xm - 1, xm + 1, (m, k)).astype(xdtype)
    x.flat[:2] = [-xm - 1, xm]
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    w.flat[:2] = [-128, 127]
    base = int(round(np.log2(k ** 0.5 * xm * 127 / 3 / TARGET[xdtype])))
    shift = (base + rng.integers(-1, 2, n) if vector
             else np.full(n, base)).astype(np.int32)
    bias = rng.integers(-TARGET[xdtype] // 2, TARGET[xdtype] // 2,
                        n).astype(np.int32)
    return x, w, bias, shift


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("k,n", [
    (128, 64),      # one K step for S8, two for W8A16
    (1024, 425),    # the head: N padded to 448
    (300, 70),      # ragged K and N
    (72, 64),       # K below one K step
])
def test_pack_mm_layout(scheme, k, n):
    """The plane of a (K, N) 1x1 weight, byte by byte: byte (g, h, r, e) of
    block (nb, kc) is w[32 kc + order[16 h + e], 64 nb + 8 g + r], order
    FRAG_K for W8A16 and 0 .. 31 for S8, zeros where K is padded to the
    scheme's K step (128 for S8, 64 for W8A16) and N to 64."""
    sch, _, pack = SCHEMES[scheme]
    w = np.random.default_rng(k + n).integers(-128, 128, (k, n)).astype(np.int8)
    planes = pack(_t(w)).numpy()
    kp, np_ = -(-k // sch.bk) * sch.bk, -(-n // 64) * 64
    assert planes.dtype == np.uint8
    assert planes.shape == sch.planes_shape(k, n) == (np_ // 64, kp // 32, 1,
                                                      8, 2, 8, 16)
    if (k, n) == (128, 64):
        assert planes.shape[1] * 32 // sch.bk == {"s8": 1, "w8a16": 2}[scheme]
    if n == 425:
        assert np_ == 448
    order = np.array(tc.FRAG_K if scheme == "w8a16" else range(32))
    wp = np.zeros((kp, np_), np.int8)
    wp[:k, :n] = w
    nb, kc, g, h, r, e = np.indices((np_ // 64, kp // 32, 8, 2, 8, 16))
    want = wp[32 * kc + order[16 * h + e], 64 * nb + 8 * g + r]
    np.testing.assert_array_equal(planes[:, :, 0], want.view(np.uint8))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("m,k,n,extremes", [
    (40, 128, 64, True),      # x and w at the ends of their types
    (333, 72, 64, True),      # K below one K step
    (37, 300, 425, False),    # ragged K, the head's N
    (20, 1024, 425, True),    # the head conv's K and N
])
def test_mm_tc_sum_equals_exact_and_xla(scheme, m, k, n, extremes):
    sch, xdtype, pack = SCHEMES[scheme]
    rng = np.random.default_rng(k + n)
    info = np.iinfo(xdtype)
    if extremes:
        x = rng.choice(EXTREMES[xdtype], (m, k)).astype(xdtype)
        w = rng.choice((-128, 127), (k, n)).astype(np.int8)
        x[0], w[:, 0] = info.min, -128   # one sum of K products at the corner
    else:
        x = rng.integers(info.min, info.max + 1, (m, k)).astype(xdtype)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    tx, tw = _t(x), _t(w)
    got = tc.emulate(tx, pack(tw), k, n, sch)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    exact = q16.mm_sum64(tx, tw)
    assert torch.equal(got, q16.acc32(exact))
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if extremes:
        assert int(exact[0, 0]) == k * int(info.min) * -128


@pytest.mark.parametrize("scheme,k,xv,wraps", [
    ("s8", 33300, -128, False),
    ("s8", 131472, -128, True),      # K >= 131,073: the exact sum leaves int32
    ("w8a16", 33300, -32513, True),  # high byte -128, low byte 255
    ("w8a16", 66600, -32513, True),  # an unchunked low-byte sum leaves s32
])
def test_mm_tc_sum_chunks_a_long_k(scheme, k, xv, wraps):
    """K beyond one split (tc.KMAX values of k), operands at their extremes:
    every s32 partial sum stays inside s32 (tc.emulate raises otherwise)
    while the exact sum may not, and the sums equal the exact ones modulo
    2^32 and XLA's; tc.split cuts that K into splits of at most tc.KMAX."""
    sch, xdtype, pack = SCHEMES[scheme]
    n = 8
    x = np.full((2, k), xv, xdtype)
    w = np.full((k, n), -128, np.int8)
    tx, tw = _t(x), _t(w)
    got = tc.emulate(tx, pack(tw), k, n, sch)
    exact = q16.mm_sum64(tx, tw)
    assert torch.equal(got, q16.acc32(exact))
    assert bool((exact.abs() >= 2.0 ** 31).all()) == wraps
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kps = tc.split(200, 72, k, 132, sch)
    assert -(-k // (kps * sch.bk)) >= 2 and kps * sch.bk <= tc.KMAX


@pytest.mark.parametrize("vector,leaky", [(True, True), (False, False),
                                          (True, False), (False, True)])
@pytest.mark.parametrize("m,k,n", [(300, 128, 256), (96, 256, 128)])
def test_mm_s8_tc_sum_requant_equals_pallas(m, k, n, vector, leaky):
    """S8's emulated sums through the port's requant == K4's int8 output,
    with a scalar and a vector shift."""
    x, w, b, s = _operands(np.random.default_rng(m + vector), m, k, n,
                           np.int8, vector)
    sums = tc.emulate(_t(x), q8.pack_s8(_t(w)), k, n, tc.S8)
    got = convops.requant32(sums, _t(b), _t(s), leaky, -128, 127).numpy()
    want = np.asarray(matmul_int8_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(s) if vector else int(s[0]), leaky, interpret=True))
    np.testing.assert_array_equal(got.astype(np.int8), want)
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("vector,leaky", [(True, True), (False, False),
                                          (True, False), (False, True)])
def test_mm_s8_tc_sum_head16_equals_pallas(vector, leaky):
    """S8's emulated sums through the head16 requant (int16 output at
    shift - 8 with bias << 8) == K4's int16 output."""
    m, k, n = 169, 256, 128
    x, w, b, s = _operands(np.random.default_rng(16 + vector), m, k, n,
                           np.int8, vector)
    b16, s16 = convops.head16(_t(b), _t(s))
    sums = tc.emulate(_t(x), q8.pack_s8(_t(w)), k, n, tc.S8)
    got = convops.requant32(sums, b16, s16, leaky, -32768, 32767).numpy()
    want = np.asarray(matmul_int16_out_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b16.numpy()),
        jnp.asarray(s16.numpy()) if vector else int(s16[0]), leaky,
        interpret=True))
    assert want.dtype == np.int16
    np.testing.assert_array_equal(got.astype(np.int16), want)
    assert _unsaturated(want, leaky).mean() > 0.5
    assert (np.abs(want) > 127).mean() > 0.5   # the 8 finer bits are in use


@pytest.mark.parametrize("vector,leaky", [(True, True), (False, False),
                                          (True, False), (False, True)])
def test_mm_w8a16_tc_sum_requant_equals_pallas(vector, leaky):
    """W8A16's emulated sums, (high << 8) + low with no cw constant, through
    the port's requant == K5."""
    m, k, n = 300, 256, 128
    x, w, b, s = _operands(np.random.default_rng(5 + vector), m, k, n,
                           np.int16, vector)
    sums = tc.emulate(_t(x), q8.pack_w8a16(_t(w)), k, n, tc.W8A16)
    got = convops.requant32(sums, _t(b), _t(s), leaky).numpy()
    cw = jconv.prep_weights_w8a16(w.reshape(1, 1, k, n))
    want = np.asarray(matmul_w8a16_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cw), jnp.asarray(b),
        jnp.asarray(s) if vector else int(s[0]), leaky=leaky, interpret=True))
    np.testing.assert_array_equal(got.astype(np.int16), want)
    assert _unsaturated(want, leaky).mean() > 0.5


def test_mm_wrappers_take_planes_on_the_cpu():
    """On the CPU both wrappers run their plain version whatever planes=
    holds, in either output type, and count no launch."""
    rng = np.random.default_rng(2)
    w = _t(rng.integers(-128, 128, (40, 24)).astype(np.int8))
    b = _t(rng.integers(-8, 8, 24).astype(np.int32))
    s = torch.full((24,), 9, dtype=torch.int32)
    junk = torch.zeros(3, dtype=torch.uint8)
    x8 = _t(rng.integers(-128, 128, (50, 40)).astype(np.int8))
    x16 = _t(rng.integers(-32768, 32768, (50, 40)).astype(np.int16))
    for out in (torch.int8, torch.int16):
        want = q8.mm_s8_plain(x8, w, b, s, True, out)
        assert want.dtype == out
        assert torch.equal(q8.mm_s8(x8, w, b, s, True, out, planes=junk), want)
        assert torch.equal(q8.mm_s8_plain(x8, w, b, s, True, out, planes=junk),
                           want)
    want = q8.mm_w8a16_plain(x16, w, b, s + 8, False)
    assert torch.equal(q8.mm_w8a16(x16, w, b, s + 8, False, planes=junk), want)
    assert q8.LAUNCHES["mm_s8"] == q8.LAUNCHES["mm_w8a16"] == 0
    assert q8.INT16_OUT_LAUNCHES["mm_s8"] == 0
