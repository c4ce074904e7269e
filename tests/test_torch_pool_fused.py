"""The plain version of the port's fused conv+pool kernel
(yolotpu_torch.ops.q16.conv3x3_pool_q16) against every TPU kernel and XLA
form it replaces, on the CPU (the Pallas kernels in interpret mode), bit for
bit, in the pool order each of them takes the max in:

  "acc"    entry_sdmm_forward (K8), convops.conv_pool_entry_sd,
           conv_pool_entry_s2d (C=3), conv_pool_sd (C=32)
  "acc_h"  entryf_forward (K9), entry8_forward (K10)
  "out"    maxpool2x2_p2 over conv3x3p2_q16_requant (K11) and
           conv3x3p2f_q16_requant (K12) on pack2(x), and the XLA conv then
           the darknet maxpool

Operands are sized so that the requantized sums span the int16 range at
each case's shift, with most outputs unsaturated; both weight encodings of
the Pallas kernels (balanced below 32640, offset above) are covered. At
shift 31 full-range operands make acc + 2^29 wrap, and there the three
orders are different functions: each case shows that its order's plain
version still equals the TPU form and differs from the other two orders.
The kernel runs only on the card, where chip_smoke.py holds it to this plain
version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yolotpu.ops import convops as jconv
from yolotpu.ops import pallas_q16 as pq16
from yolotpu.ops import pool as jpool
from yolotpu_torch.ops import q16


def _span(shift, k):
    """Operand bound r such that K products of two uniform [-r, r] draws,
    requantized by shift, span about +-2^13; capped at the int16 range."""
    m = min(shift, 30) if shift > 0 else shift
    return int(min(32767, max(1, (3 * 2.0 ** (13 + m) / k ** 0.5) ** 0.5)))


def _operands(rng, shape, shift, wmax, full=False):
    """x (B, H, W, C), w (3, 3, C, N) in +-_span (full: the whole int16
    range), the weights' largest value pinned to wmax, and a bias in
    +-2^14."""
    b, h, w_, c, n = shape
    r = 32767 if full else _span(shift, 9 * c)
    x = rng.integers(-r - full, r + 1, (b, h, w_, c)).astype(np.int16)
    x.flat[:2] = [-32768, 32767]
    w = np.minimum(rng.integers(-r - full, r + 1, (3, 3, c, n)), wmax)
    w.flat[:2] = [-32768, wmax]
    bias = rng.integers(-2**14, 2**14, n).astype(np.int32)
    return x, w.astype(np.int16), bias


def _nchw(x):
    return jnp.asarray(x.transpose(0, 3, 1, 2))


def _act(leaky):
    return "leaky" if leaky else "linear"


# the TPU forms: (x, w, bias, shift, leaky) -> the pooled (B, H/2, W/2, N)
def _entry_sdmm(x, w, b, shift, leaky):
    wp = pq16.prep_entry_sdmm_weights(
        jconv.make_entry_sd_weights(w, w.shape[-1]), b)
    return pq16.entry_sdmm_forward(_nchw(x), wp, shift, leaky, interpret=True)


def _entry_sd(x, w, b, shift, leaky):
    return jconv.conv_pool_entry_sd(
        _nchw(x), jnp.asarray(jconv.make_entry_sd_weights(w, w.shape[-1])),
        jnp.asarray(b), shift, _act(leaky))


def _entry_s2d(x, w, b, shift, leaky):
    return jconv.conv_pool_entry_s2d(
        _nchw(x), jnp.asarray(jconv.make_entry_s2d_weights(w, w.shape[-1])),
        jnp.asarray(b), shift, _act(leaky))


def _sd_pool(x, w, b, shift, leaky):
    return jconv.conv_pool_sd(
        jnp.asarray(x), jnp.asarray(jconv.make_entry_sd_weights(w, w.shape[-1])),
        jnp.asarray(b), shift, _act(leaky))


def _entryf(x, w, b, shift, leaky):
    return pq16.entryf_forward(jnp.asarray(x), pq16.prep_entryf_weights(w, b),
                               shift, leaky, interpret=True)


def _entry8(x, w, b, shift, leaky):
    return pq16.entry8_forward(jnp.asarray(x), pq16.prep_entry8_weights(w, b),
                               shift, leaky)


def _p2(x, w, b, shift, leaky):
    y = pq16.conv3x3p2_q16_requant(pq16.pack2(jnp.asarray(x)),
                                   pq16.prep_conv_weights_p2(w, b), shift,
                                   leaky, interpret=True)
    return pq16.maxpool2x2_p2(y)


def _p2f(x, w, b, shift, leaky):
    y = pq16.conv3x3p2f_q16_requant(pq16.pack2(jnp.asarray(x)),
                                    pq16.prep_conv_weights_p2(w, b), shift,
                                    leaky, interpret=True)
    assert y is not None
    return pq16.maxpool2x2_p2(y)


def _conv_then_pool(x, w, b, shift, leaky):
    conv = jconv.conv_int16(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            1, 1, _act(leaky), shift)
    return jpool.maxpool(conv, 2, 2, 0)


# name -> (TPU form, its pool order, a shape (B, H, W, C, N) it takes)
FORMS = {
    "entry_sdmm": (_entry_sdmm, "acc", (2, 8, 16, 3, 32)),
    "entry_sd": (_entry_sd, "acc", (2, 8, 16, 3, 32)),
    "entry_s2d": (_entry_s2d, "acc", (2, 8, 16, 3, 32)),
    "sd_pool": (_sd_pool, "acc", (1, 8, 6, 32, 24)),
    "entryf": (_entryf, "acc_h", (2, 8, 16, 3, 32)),
    "entry8": (_entry8, "acc_h", (1, 8, 24, 3, 32)),
    "conv3p2": (_p2, "out", (1, 8, 6, 32, 64)),
    "conv3p2f": (_p2f, "out", (1, 6, 8, 64, 128)),
    "conv_then_pool": (_conv_then_pool, "out", (2, 6, 4, 16, 24)),
}


def _plain(x, w, bias, shift, leaky, order):
    return q16.conv3x3_pool_q16_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        shift, leaky, order).numpy()


def _unsaturated(out, leaky):
    sat = (out == 32767) | (out == -32768)
    if leaky:
        sat |= out == -3276
    return ~sat


@pytest.mark.parametrize("name,shift,leaky,wmax", [
    ("entry_sdmm", 9, True, 30000), ("entry_sdmm", 6, False, 32767),
    ("entry_sd", 7, True, 32767), ("entry_s2d", 5, False, 30000),
    ("sd_pool", 7, True, 32767), ("sd_pool", -3, False, 30000),
    ("entryf", 7, True, 32639), ("entryf", 5, False, 32767),
    ("entry8", 7, True, 32639), ("entry8", 0, False, 32767),
    ("conv3p2", 9, True, 32767), ("conv3p2", 6, False, 32639),
    ("conv3p2f", 7, True, 32639), ("conv3p2f", 40, False, 32767),
    ("conv_then_pool", 7, True, 32767), ("conv_then_pool", 1, False, 32767),
])
def test_pool_order_plain_equals_tpu_form(name, shift, leaky, wmax):
    form, order, shape = FORMS[name]
    x, w, bias = _operands(np.random.default_rng(30), shape, shift, wmax)
    assert (w.max() <= 32639) == (wmax <= 32639)   # the encoding it takes
    want = np.asarray(form(x, w, bias, shift, leaky))
    got = _plain(x, w, bias, shift, leaky, order)
    np.testing.assert_array_equal(got, want)
    assert _unsaturated(got, leaky).mean() > 0.5
    # on CPU tensors the wrapper is the plain version, and launches nothing
    got_w = q16.conv3x3_pool_q16(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias), shift, leaky, order)
    np.testing.assert_array_equal(got_w.numpy(), want)
    assert q16.LAUNCHES["conv3x3_pool_q16"] == 0


@pytest.mark.parametrize("name", sorted(FORMS))
def test_pool_orders_differ_where_the_sum_wraps(name):
    """Full-range operands at shift 31: acc + 2^29 wraps, the three orders
    give three different results, and the TPU form's is its order's."""
    form, order, shape = FORMS[name]
    leaky = name.startswith("entry")
    x, w, bias = _operands(np.random.default_rng(31), shape, 31, 32767,
                           full=True)
    want = np.asarray(form(x, w, bias, 31, leaky))
    got = {o: _plain(x, w, bias, 31, leaky, o) for o in q16.POOL_ORDERS}
    np.testing.assert_array_equal(got[order], want)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        oa, ob = q16.POOL_ORDERS[a], q16.POOL_ORDERS[b]
        assert (got[oa] != got[ob]).any(), (oa, ob)
    assert _unsaturated(want, leaky).mean() > 0.5


@pytest.mark.parametrize("fn", [pq16.conv3x3p2_q16_requant,
                                pq16.conv3x3p2f_q16_requant])
@pytest.mark.parametrize("shift,leaky", [(8, True), (31, False)])
def test_p2_conv_with_no_pool_is_conv3x3(fn, shift, leaky):
    """K11 and K12 with no pool after them: the p2-packed conv unpacked ==
    conv3x3_q16's plain version (so the port runs them on conv3x3_q16)."""
    b, h, w_, c, n = 1, 6, 8, 32, 64
    x, w, bias = _operands(np.random.default_rng(32), (b, h, w_, c, n), shift,
                           32767, full=shift == 31)
    y = fn(pq16.pack2(jnp.asarray(x)), pq16.prep_conv_weights_p2(w, bias),
           shift, leaky, interpret=True)
    want = np.asarray(pq16.unpack2(y))
    got = q16.conv3x3_q16_plain(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(bias), shift, leaky).numpy()
    np.testing.assert_array_equal(got, want)
    assert _unsaturated(got, leaky).mean() > 0.5


def test_conv3x3_pool_q16_checks_operands():
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.integers(-9, 9, (1, 4, 6, 8)).astype(np.int16))
    w = torch.from_numpy(rng.integers(-9, 9, (3, 3, 8, 5)).astype(np.int16))
    b = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="even H and W"):
        q16.conv3x3_pool_q16(x[:, :3], w, b, 3, True, "acc")
    with pytest.raises(ValueError, match="order"):
        q16.conv3x3_pool_q16(x, w, b, 3, True, "max")
    with pytest.raises(ValueError):   # neither CPU nor CUDA: no silent path
        q16.conv3x3_pool_q16(x.to("meta"), w.to("meta"), b.to("meta"), 3,
                             True, "acc")
    assert q16.conv3x3_pool_q16(x, w, b, 3, True, "out").shape == (1, 2, 3, 5)
    assert q16.LAUNCHES["conv3x3_pool_q16"] == 0
