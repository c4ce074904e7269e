"""The port's numpy golden model (yolotpu_torch.golden): the INT16
primitives and GoldenNet.forward_int16 in its four modes (exact, int32,
int8, w8a16), against yolotpu.golden on the same seeded inputs, array for
array and bit for bit."""

import functools

import numpy as np
import pytest

from yolotpu import golden as jgolden
from yolotpu import quant as jquant
from yolotpu import weights as jweights
from yolotpu.graph import ConvSpec as JConvSpec
from yolotpu.models import zoo as jzoo
from yolotpu_torch import golden
from yolotpu_torch import quant as quant_
from yolotpu_torch import weights
from yolotpu_torch.graph import ConvSpec
from yolotpu_torch.models import zoo

# (size, stride, pad, c, n, h, w, activation)
CONVS = [(3, 1, 1, 7, 5, 6, 5, "leaky"), (1, 1, 0, 9, 4, 3, 4, "linear"),
         (3, 2, 1, 4, 3, 7, 6, "leaky"), (3, 1, 1, 3, 8, 4, 4, "linear")]


def _specs(size, stride, pad, c, n, h, w, act):
    out_h = (h + 2 * pad - size) // stride + 1
    out_w = (w + 2 * pad - size) // stride + 1
    kw = dict(idx=0, h=h, w=w, c=c, out_h=out_h, out_w=out_w, out_c=n, n=n,
              size=size, stride=stride, pad=pad, activation=act)
    return ConvSpec(**kw), JConvSpec(**kw)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_sat16_leaky_quantize_equal():
    rng = np.random.default_rng(0)
    v = rng.integers(-70000, 70000, 5000)
    _equal(golden.sat16(v), jgolden.sat16(v))
    v16 = rng.integers(-32768, 32768, 5000).astype(np.int16)
    _equal(golden.leaky_int16(v16), jgolden.leaky_int16(v16))
    x = (rng.standard_normal(5000) * 40).astype(np.float32)
    x[:4] = [0.5, -0.5, 1e9, -1e9]
    for q in (-3, 0, 7, 14):
        _equal(golden.quantize_fp32_to_int16(x, q),
               jgolden.quantize_fp32_to_int16(x, q))


@pytest.mark.parametrize("shift", [-40, -3, 0, 1, 7, 30, 31, 45])
def test_shift_round_half_up_scalar(shift):
    v = np.random.default_rng(1).integers(-2**40, 2**40, 4000)
    v[:3] = [-1, 0, 1]
    _equal(golden.shift_round_half_up(v, shift),
           jgolden.shift_round_half_up(v, shift))


def test_shift_round_half_up_per_channel():
    """One shift per channel, every sign and both caps in one vector,
    broadcast against (channels, h, w) sums at the limits."""
    rng = np.random.default_rng(2)
    shifts = np.array([-35, -30, -2, 0, 1, 5, 30, 33])
    v = rng.integers(-2**31, 2**31, (8, 5, 6))
    v[:, 0, 0] = 2**31 - 1
    v[:, 0, 1] = -2**31
    _equal(golden.shift_round_half_up(v, shifts.reshape(-1, 1, 1)),
           jgolden.shift_round_half_up(v, shifts.reshape(-1, 1, 1)))


@pytest.mark.parametrize("conv", CONVS, ids=[f"{c[0]}x{c[0]}s{c[1]}c{c[3]}n{c[4]}"
                                             for c in CONVS])
@pytest.mark.parametrize("sat", [False, True], ids=["narrow", "saturating"])
def test_int16_convs_equal(conv, sat):
    """conv_int16_exact (per-4-channel, per-tap saturating accumulation)
    and conv_int16_int32acc, on narrow and on saturating operands."""
    spec, jspec = _specs(*conv)
    rng = np.random.default_rng(3)
    lim = 32768 if sat else 512
    x = rng.integers(-lim, lim, (spec.c, spec.h, spec.w)).astype(np.int16)
    wt = rng.integers(-lim, lim, (spec.n, spec.c, spec.size, spec.size)
                      ).astype(np.int16)
    b = rng.integers(-lim, lim, spec.n).astype(np.int16)
    for qw, qa_in, qa_out, qb in ((12, 8, 9, 10), (14, 10, 6, 13), (3, 2, 8, 1)):
        for fn in ("conv_int16_exact", "conv_int16_int32acc"):
            _equal(getattr(golden, fn)(x, wt, b, spec, qw, qa_in, qa_out, qb),
                   getattr(jgolden, fn)(x, wt, b, jspec, qw, qa_in, qa_out, qb))


@pytest.mark.parametrize("conv", CONVS, ids=[f"{c[0]}x{c[0]}s{c[1]}c{c[3]}n{c[4]}"
                                             for c in CONVS])
def test_8bit_weight_convs_equal(conv):
    """conv_w8a16_int32acc and conv_int8_int32acc (with and without the
    head16 epilogue), per-layer and per-channel Q tables, saturating."""
    spec, jspec = _specs(*conv)
    rng = np.random.default_rng(4)
    x16 = rng.integers(-32768, 32768, (spec.c, spec.h, spec.w)).astype(np.int16)
    x8 = rng.integers(-128, 128, (spec.c, spec.h, spec.w)).astype(np.int8)
    wt = rng.integers(-128, 128, (spec.n, spec.c, spec.size, spec.size)
                      ).astype(np.int8)
    b = rng.integers(-2**15, 2**15, spec.n).astype(np.int32)
    per_ch = (rng.integers(4, 9, spec.n), rng.integers(6, 12, spec.n))
    for qw, qb in ((7, 9), per_ch):
        _equal(golden.conv_w8a16_int32acc(x16, wt, b, spec, qw, 9, 10, qb),
               jgolden.conv_w8a16_int32acc(x16, wt, b, jspec, qw, 9, 10, qb))
        for head16 in (False, True):
            _equal(golden.conv_int8_int32acc(x8, wt, b, spec, qw, 4, 3, qb,
                                             head16=head16),
                   jgolden.conv_int8_int32acc(x8, wt, b, jspec, qw, 4, 3, qb,
                                              head16=head16))


@functools.cache
def _stores(model, size):
    """Synthetic weights from seed 0 quantized for the three integer tiers,
    as load_or_synthesize quantizes each (one calibration image from seed
    0), on both sides: (spec, store, jspec, jstore)."""
    out = []
    for zoo_, wts, quant in ((zoo, weights, quant_), (jzoo, jweights, jquant)):
        spec = zoo_.build(model, width=size, height=size)
        store = wts.WeightStore.synthetic(spec, seed=0)
        calib = [np.random.default_rng(0).random((3, size, size)).astype(
            np.float32)]
        act_q = quant.calibrate_activations(spec, store, calib)
        quant.quantize_weights(store, act_q)
        quant.quantize_weights_w8a16(store, act_q)
        quant.quantize_weights_int8(
            store, quant.calibrate_activations_int8(spec, store, calib))
        out += [spec, store]
    return tuple(out)


# mode -> (the store's weights, its Q tables)
MODES = {"int32": ("int16", "qtables"), "exact": ("int16", "qtables"),
         "int8": ("int8", "qtables8"), "w8a16": ("w8a16", "qtables_w8")}


@pytest.mark.parametrize("model,size", [("yolov2", 64), ("yolov2-tiny", 96)])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_int16_modes_equal(model, size, mode):
    """Every layer's output (keep_all) and the dequantized region head, in
    each mode, equal to yolotpu's, dtype for dtype."""
    wname, qname = MODES[mode]
    spec, store, jspec, jstore = _stores(model, size)
    x = np.random.default_rng(5).random((3, size, size), dtype=np.float32)
    got = golden.GoldenNet(spec).forward_int16(
        x, getattr(store, wname), getattr(store, qname), keep_all=True,
        mode=mode)
    want = jgolden.GoldenNet(jspec).forward_int16(
        x, getattr(jstore, wname), getattr(jstore, qname), keep_all=True,
        mode=mode)
    assert got.keys() == want.keys() == set(range(spec.n))
    for idx in want:
        _equal(got[idx], want[idx])
    assert got[spec.n - 1].dtype == np.float32


def test_sibling_route_q_equal():
    spec = zoo.build("yolov2", width=64, height=64)
    reorg = next(l.idx for l in spec.layers if type(l).__name__ == "ReorgSpec")
    for act_q in ({}, {16: 9, 24: 7}, {16: 3}):
        assert (golden._sibling_route_q(spec, reorg, act_q)
                == jgolden._sibling_route_q(
                    jzoo.build("yolov2", width=64, height=64), reorg, act_q))
