"""The port's general integer conv (``ops.q16.conv_q16``, ``ops.q8.conv_s8``
with its int16 head16 output, ``ops.q8.conv_w8a16``: any k x k size, stride
and darknet or explicit padding) and its route (``models.engine_plan``,
``models.yolov2``) against the JAX package's XLA convs, on the CPU, through
the kernels' plain versions.

- per op: each edge form of the general conv in each tier, bit-equal to
  ``yolotpu.ops.convops`` (``conv_int16(compute="int32")``, ``conv_int8``
  with ``head16`` both ways, ``conv_w8a16``), sums built to wrap included;
- the packed planes (``tc.emulate``) hold the new K order, k*k*C tap-major;
- routing: the convs that are not a regular 1x1 or 3x3/s1 take the route
  ("conv", None) in every integer tier, the JAX package's overrides are
  refused or accepted as it refuses or accepts them; the sp slab rule
  serves only darknet padding;
- a small mixed cfg at 96x96, written here (7x7/s2 entry, 3x3/s2, 5x5,
  2x2/s2 padding=0, VALID 3x3, 1x1/s2 and a 3x3 head into a region): its
  int16, int8 (head16 on the 3x3 head) and w8a16 heads bit-equal to
  ``yolotpu``'s ``build_forward(..., compute="int32")``, its fp32 head within
  the fp32 tests' tolerance, its params carried by ``params_from_jax``;
- yolov2-s2 (yolov2 with each 2x2/s2 maxpool a 3x3/s2 conv) at 64x64,
  int16, and one ``Engine.detect`` on the mixed cfg.

Every network's spec, store and JAX forward is built once (functools.cache)
and the JAX forwards take their params as arguments.
"""

import dataclasses
import functools
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from yolotpu import quant as jquant
from yolotpu import weights as jweights
from yolotpu.graph import NetworkSpec as JaxNetworkSpec
from yolotpu.models import engine_plan as jep
from yolotpu.models import yolov2 as jy
from yolotpu.ops import convops as jconv
from yolotpu_torch import quant as tquant
from yolotpu_torch import weights as tweights
from yolotpu_torch.graph import NetworkSpec
from yolotpu_torch.image import letterbox_image
from yolotpu_torch.models import engine_plan, zoo
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.ops import convops, q8, q16, tc
from yolotpu_torch.parallel.forward import serves_on_slab
from yolotpu_torch.runtime.engine import Engine

# name -> (B, H, W, C, N, k, stride, pad)
FORMS = {
    "7x7s2p3-C3": (1, 15, 13, 3, 7, 7, 2, 3),
    "5x5s1p2-C12": (1, 9, 10, 12, 16, 5, 1, 2),
    "3x3-valid-C4": (2, 9, 8, 4, 24, 3, 1, 0),
    # odd H and W: the last row and column are never read
    "2x2s2p0-odd-C7": (1, 11, 9, 7, 16, 2, 2, 0),
    "1x1s2-C16": (2, 9, 7, 16, 8, 1, 2, 0),
    "3x3s2p2-C8": (1, 8, 9, 8, 16, 3, 2, 2),
    # padding 3 > 3 - 1: the first row and column of windows are all
    # padding, their outputs the bias alone
    "3x3s2p3-allpad-C4": (1, 5, 6, 4, 8, 3, 2, 3),
    "3x3s2p1-C32-N425": (1, 7, 6, 32, 425, 3, 2, 1),
}
TIERS = ("int16", "int8", "int8-head16", "w8a16")
# the output type's range, and the spread the requantized sums aim for
TARGET = {torch.int16: 2 ** 12, torch.int8: 2 ** 5}
INFO = {torch.int16: (-32768, 32767), torch.int8: (-128, 127)}
FP32_HEAD_TOL = 1e-4   # tests/test_torch_fp32.py's, of the largest magnitude

MIXED_SIZE = 96
ANCHORS = "0.57,0.68,1.87,2.06,3.34,5.47,7.88,3.53,9.77,9.17"
MIXED_CFG = f"""[net]
batch=1
width={MIXED_SIZE}
height={MIXED_SIZE}
channels=3

[convolutional]
batch_normalize=1
filters=16
size=7
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=5
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=2
stride=2
padding=0
activation=leaky

[convolutional]
batch_normalize=1
filters=48
size=3
stride=1
padding=0
activation=linear

[convolutional]
batch_normalize=1
filters=64
size=1
stride=2
pad=1
activation=leaky

[convolutional]
filters=35
size=3
stride=1
pad=1
activation=linear

[region]
anchors={ANCHORS}
classes=2
coords=4
num=5
softmax=1
"""
MIXED_GENERAL = (0, 2, 4, 5, 6, 7)   # the convs that are not regular
# tier -> (Q tables attribute, JAX params, port params)
NET_TIERS = {"int16": ("qtables", jy.params_int16, ty.params_int16),
             "int8": ("qtables8", jy.params_int8, ty.params_int8),
             "w8a16": ("qtables_w8", jy.params_w8a16, ty.params_w8a16)}


def yolov2_s2_cfg(size: int) -> str:
    """yolov2's cfg with each 2x2/s2 maxpool a 3x3/s2 conv of the width
    before it (darknet-53-style downsampling), at size x size."""
    sections, filters = [], None
    for sec in zoo.to_cfg("yolov2").split("\n\n"):
        if sec.startswith("[maxpool]"):
            assert "size=2\nstride=2" in sec
            sec = ("[convolutional]\nbatch_normalize=1\n"
                   f"filters={filters}\nsize=3\nstride=2\npad=1\n"
                   "activation=leaky")
        if sec.startswith("[convolutional]"):
            filters = int(re.search(r"filters=(\d+)", sec).group(1))
        sections.append(sec)
    return re.sub(r"(width|height)=416", rf"\g<1>={size}",
                  "\n\n".join(sections))


# ---------------------------------------------------------------------------
# per op
# ---------------------------------------------------------------------------

def _operands(form: str, tier: str, wrap: bool = False):
    """x, w (HWIO), bias, shift (an int for int16, an (N,) vector for the
    8-bit-weight tiers, each column within 1 of a base) for one form, sized
    so that most outputs stay unsaturated; with ``wrap`` (int16) x and w
    span int16, so most exact sums leave int32."""
    b, h, wd, c, n, k, stride, pad = FORMS[form]
    rng = np.random.default_rng([list(FORMS).index(form), TIERS.index(tier),
                                 wrap])
    xdtype = np.int8 if tier.startswith("int8") else np.int16
    wdtype = np.int16 if tier == "int16" else np.int8
    out = torch.int16 if tier in ("int16", "w8a16") else torch.int8
    xmax, wmax = int(np.iinfo(xdtype).max), int(np.iinfo(wdtype).max)
    rx, rw = (xmax, wmax) if wrap else (min(xmax, 900), min(wmax, 900))
    x = rng.integers(-rx, rx + 1, (b, h, wd, c)).astype(xdtype)
    w = rng.integers(-rw, rw + 1, (k, k, c, n)).astype(wdtype)
    x.flat[:2] = [-xmax - 1, xmax]
    w.flat[:2] = [-wmax - 1, wmax]
    base = 16 if wrap else max(0, round(np.log2(
        (k * k * c) ** 0.5 * rx * rw / 3 / TARGET[out])))
    bias = rng.integers(-TARGET[out] // 4, TARGET[out] // 4, n).astype(np.int32)
    if tier == "int16":
        return x, w, bias, base
    return x, w, bias, (base + rng.integers(-1, 2, n)).astype(np.int32)


# w8a16 sums built to wrap: (B, H, W, N, k, stride, pad), and the channels
WRAP8 = (1, 5, 6, 24, 3, 2, 1)
WRAP8_BLOCK, WRAP8_SMALL = 1024, 37   # 1024 products (-32768)*(-128) = 2^32


def _wrap_operands_w8a16():
    """x int16 and w int8 of a 3x3/s2 conv whose exact sums leave int32
    and wrap to small values: a block of WRAP8_BLOCK channels is -32768 or
    0 in x (per pixel) and -128 or 0 in w (per tap and column), so it adds
    a multiple of 2^32 to each sum; the other WRAP8_SMALL channels are
    uniform, sized to the shift; channels shuffled."""
    b, h, wd, n, k, _, _ = WRAP8
    rng = np.random.default_rng(11)
    c = WRAP8_BLOCK + WRAP8_SMALL
    x = np.zeros((b, h, wd, c), np.int64)
    w = np.zeros((k, k, c, n), np.int64)
    x[..., :WRAP8_BLOCK] = np.where(rng.random((b, h, wd, 1)) < 0.6, -32768, 0)
    w[:, :, :WRAP8_BLOCK] = np.where(rng.random((k, k, 1, n)) < 0.6, -128, 0)
    x[..., WRAP8_BLOCK:] = rng.integers(-2000, 2001, (b, h, wd, WRAP8_SMALL))
    w[:, :, WRAP8_BLOCK:] = rng.integers(-127, 128, (k, k, WRAP8_SMALL, n))
    perm = rng.permutation(c)
    shift = (8 + rng.integers(-1, 2, n)).astype(np.int32)
    bias = rng.integers(-1024, 1024, n).astype(np.int32)
    return (x[..., perm].astype(np.int16), w[:, :, perm].astype(np.int8),
            bias, shift)


# the JAX package's convs, jitted whole (one compile per case, not one per
# op): geometry, activation and the int16 tier's shift static
_GEOMETRY = ("stride", "pad", "activation")
_JAX_CONV = {
    "int16": jax.jit(functools.partial(jconv.conv_int16, compute="int32"),
                     static_argnames=(*_GEOMETRY, "shift_out")),
    "int8": jax.jit(jconv.conv_int8, static_argnames=(*_GEOMETRY, "head16")),
    "w8a16": jax.jit(jconv.conv_w8a16, static_argnames=_GEOMETRY),
}


def _jax_conv(tier: str, x, w, bias, shift, stride, pad, act):
    geometry = dict(stride=stride, pad=pad, activation=act, shift_out=shift)
    if tier == "int16":
        return _JAX_CONV[tier](x, w, bias, **geometry)
    if tier == "w8a16":
        return _JAX_CONV[tier](x, w, jconv.prep_weights_w8a16(w), bias,
                               **geometry)
    return _JAX_CONV["int8"](x, w, bias, head16=tier == "int8-head16",
                             **geometry)


def _port_conv(tier: str, x, w, bias, shift, stride, pad, leaky):
    x, w, bias = (torch.from_numpy(a) for a in (x, w, bias))
    if tier == "int16":
        return q16.conv_q16(x, w, bias, shift, leaky, stride, pad)
    s = torch.from_numpy(shift)
    if tier == "w8a16":
        return q8.conv_w8a16(x, w, bias, s, leaky, stride, pad)
    if tier == "int8-head16":
        b16, s16 = convops.head16(bias, s)
        return q8.conv_s8(x, w, b16, s16, leaky, stride, pad,
                          out_dtype=torch.int16)
    return q8.conv_s8(x, w, bias, s, leaky, stride, pad)


def _hold(tier: str, operands: tuple, stride: int, pad: int,
          wrap: bool) -> None:
    """The port's general conv of ``tier`` on ``operands`` (x, w, bias,
    shift), linear and leaky, bit-equal to the JAX package's, of the right
    shape, most outputs unsaturated; with ``wrap`` more than a tenth of the
    exact sums outside int32."""
    x, w, bias, shift = operands
    k, n = w.shape[0], w.shape[-1]
    ho = (x.shape[1] + 2 * pad - k) // stride + 1
    wo = (x.shape[2] + 2 * pad - k) // stride + 1
    for leaky, act in ((False, "linear"), (True, "leaky")):
        want = np.asarray(_jax_conv(tier, x, w, bias, shift, stride, pad, act))
        got = _port_conv(tier, x, w, bias, shift, stride, pad, leaky)
        assert got.shape == want.shape == (x.shape[0], ho, wo, n)
        np.testing.assert_array_equal(got.numpy(), want)
        lo, hi = INFO[got.dtype]
        unsat = float(((want > lo) & (want < hi)).mean())
        assert unsat > 0.5, f"blind case: {unsat:.3f} of the outputs unsaturated"
    exact = q16.conv_sum64(torch.from_numpy(x), torch.from_numpy(w), stride,
                           pad)
    wrapped = float((exact.abs() >= 2 ** 31).float().mean())
    assert wrapped > 0.1 if wrap else wrapped == 0


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("form", list(FORMS))
def test_general_conv_equals_convops(form, tier):
    stride, pad = FORMS[form][6:]
    _hold(tier, _operands(form, tier), stride, pad, wrap=False)


@pytest.mark.parametrize("tier", ("int16", "w8a16"))
def test_general_conv_wrapped_sums_equal_convops(tier):
    """Sums that leave int32: int16 operands over their whole range (a
    5x5 conv, K=300), and w8a16 blocks of 1024 products (-32768)*(-128)
    (a 3x3/s2 conv, K=9549)."""
    if tier == "int16":
        _hold(tier, _operands("5x5s1p2-C12", tier, wrap=True), 1, 2, True)
    else:
        _hold(tier, _wrap_operands_w8a16(), *WRAP8[5:], True)


@pytest.mark.parametrize("scheme", (tc.Q16, tc.W8A16, tc.S8),
                         ids=lambda s: s.name)
def test_packed_planes_hold_the_general_k_order(scheme):
    """The planes of a (k, k, C, N) weight, packed as the model packs them,
    give through ``tc.emulate`` on the general im2col (k*k*C tap-major, K
    padded past one K step) the plain version's sums at a stride of 2."""
    rng = np.random.default_rng(7)
    xdtype = np.int8 if scheme is tc.S8 else np.int16
    wdtype = np.int16 if scheme is tc.Q16 else np.int8
    x = torch.from_numpy(rng.integers(np.iinfo(xdtype).min,
                                      np.iinfo(xdtype).max + 1,
                                      (2, 11, 9, 13)).astype(xdtype))
    w = torch.from_numpy(rng.integers(np.iinfo(wdtype).min,
                                      np.iinfo(wdtype).max + 1,
                                      (5, 5, 13, 70)).astype(wdtype))
    pack = {tc.Q16: q16.pack_q16, tc.W8A16: q8.pack_w8a16,
            tc.S8: q8.pack_s8}[scheme]
    got = tc.emulate(q16.im2col(x, 5, 2, 2), pack(w), 5 * 5 * 13, 70, scheme)
    want = q16.acc32(q16.conv_sum64(x, w, 2, 2)).reshape(-1, 70)
    assert torch.equal(got, want)


def test_general_conv_refuses_a_geometry_with_no_output():
    x = torch.zeros((1, 3, 3, 4), dtype=torch.int16)
    w = torch.zeros((5, 5, 4, 8), dtype=torch.int16)
    with pytest.raises(ValueError, match="no output"):
        q16.conv_q16(x, w, torch.zeros(8, dtype=torch.int32), 0, False, 1, 0)


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

@functools.cache
def _net(text: str, port: bool, tiers: tuple = tuple(NET_TIERS)):
    """(spec, store) of a cfg text by one package's host layer: synthetic
    weights from seed 0, calibrated on one seeded image, quantized for
    ``tiers`` (int16 always) as load_or_synthesize does it."""
    import os
    import tempfile
    weights, quant, spec_cls = ((tweights, tquant, NetworkSpec) if port
                                else (jweights, jquant, JaxNetworkSpec))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "net.cfg")
        with open(path, "w") as f:
            f.write(text)
        spec = spec_cls.from_cfg(path)
    store = weights.WeightStore.synthetic(spec, seed=0)
    img = np.random.default_rng(100).random(
        (3, spec.net.height, spec.net.width)).astype(np.float32)
    act_q = quant.calibrate_activations(spec, store, [img])
    quant.quantize_weights(store, act_q)
    if "w8a16" in tiers:
        quant.quantize_weights_w8a16(store, act_q)
    if "int8" in tiers:
        quant.quantize_weights_int8(
            store, quant.calibrate_activations_int8(spec, store, [img]))
    return spec, store


@functools.cache
def _jax_forward(text: str, tier: str, tiers: tuple = tuple(NET_TIERS)):
    spec, store = _net(text, False, tiers)
    if tier == "fp32":
        fwd, params = (jax.jit(jy.build_forward(spec, "fp32",
                                                outputs=("head",))),
                       jy.params_fp32(spec, store))
    else:
        qattr, jparams, _ = NET_TIERS[tier]
        fwd = jax.jit(jy.build_forward(spec, tier, getattr(store, qattr),
                                       compute="int32", outputs=("head",)))
        params = jparams(spec, store)
    return functools.partial(fwd, params)


def _port_model(text: str, tier: str, params=None,
                tiers: tuple = tuple(NET_TIERS)) -> ty.YoloV2Q:
    spec, store = _net(text, True, tiers)
    if tier == "fp32":
        return ty.YoloV2Q(spec, None, params or ty.params_fp32(spec, store),
                          "cpu", "fp32")
    qattr, _, tparams = NET_TIERS[tier]
    return ty.YoloV2Q(spec, getattr(store, qattr),
                      params or tparams(spec, store), "cpu", tier)


def _frames(size: int, n: int = 1) -> np.ndarray:
    return np.random.default_rng(size + 3).random(
        (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("tier", list(NET_TIERS))
def test_mixed_cfg_heads_equal_yolotpu(tier):
    """The mixed cfg's head, every conv that is not regular on the tier's
    general conv (and in int8 the 3x3 head conv on conv_s8's int16
    output), bit-equal to the JAX package's."""
    x = _frames(MIXED_SIZE)
    want = np.asarray(_jax_forward(MIXED_CFG, tier)(jnp.asarray(x))["head"])
    model = _port_model(MIXED_CFG, tier)
    route = {i: model.route[i][0] for i in model.route}
    assert {i for i, k in route.items() if k == "conv"} == set(
        MIXED_GENERAL) | ({8} if tier == "int8" else set())
    assert model.head16 == (8 if tier == "int8" else None)
    got = model(torch.from_numpy(x))["head"].numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 100


def test_mixed_cfg_fp32_head_within_tolerance():
    x = _frames(MIXED_SIZE)
    want = np.asarray(_jax_forward(MIXED_CFG, "fp32")(jnp.asarray(x))["head"])
    got = _port_model(MIXED_CFG, "fp32")(torch.from_numpy(x))["head"].numpy()
    assert np.abs(got - want).max() <= FP32_HEAD_TOL * np.abs(want).max()


@pytest.mark.parametrize("tier", list(NET_TIERS))
def test_params_from_jax_carries_the_general_convs(tier):
    """``params_from_jax`` of the JAX package's tree of the mixed cfg is the
    port's own tree, leaf for leaf (the HWIO weights of every size, the
    biases), and a model built from it gives the same head."""
    jspec, jstore = _net(MIXED_CFG, False)
    tspec, tstore = _net(MIXED_CFG, True)
    qattr, jparams, tparams = NET_TIERS[tier]
    carried = ty.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams(jspec, jstore)))
    own = tparams(tspec, tstore)
    assert carried.keys() == own.keys()
    for name in own:
        for leaf in ("w", "b"):
            assert carried[name][leaf].dtype == own[name][leaf].dtype
            assert torch.equal(carried[name][leaf], own[name][leaf])
    x = torch.from_numpy(_frames(MIXED_SIZE))
    assert torch.equal(_port_model(MIXED_CFG, tier, carried)(x)["head"],
                       _port_model(MIXED_CFG, tier)(x)["head"])


def test_yolov2_s2_int16_head_equals_yolotpu():
    text, tiers = yolov2_s2_cfg(64), ("int16",)
    spec = _net(text, True, tiers)[0]
    convs = spec.conv_layers()
    assert len(convs) == 28
    routes = [k for k, _ in engine_plan.kernels(spec, "int16").values()]
    assert (routes.count("mm"), routes.count("conv3"),
            routes.count("conv")) == (8, 15, 5)
    x = _frames(64)
    want = np.asarray(_jax_forward(text, "int16", tiers)(
        jnp.asarray(x))["head"])
    got = _port_model(text, "int16", tiers=tiers)(
        torch.from_numpy(x))["head"].numpy()
    np.testing.assert_array_equal(got, want)


def test_engine_detect_on_the_mixed_cfg(monkeypatch):
    """Engine.detect (the letterbox, the int16 forward on the CPU, decode
    and NMS) on the mixed cfg: its head is the JAX package's on the same
    letterboxed frame."""
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    spec, store = _net(MIXED_CFG, True)
    im = np.random.default_rng(5).random((3, 70, 110)).astype(np.float32)
    dets, res = Engine(spec, store, "int16", "cpu").detect(im, thresh=0.005)
    boxed = letterbox_image(im, MIXED_SIZE, MIXED_SIZE)
    want = np.asarray(_jax_forward(MIXED_CFG, "int16")(
        jnp.asarray(boxed.transpose(1, 2, 0)[None]))["head"])[0]
    np.testing.assert_array_equal(res.head_chw, want.transpose(2, 0, 1))
    assert np.isfinite(res.head_chw).all() and dets


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", MIXED_GENERAL)
def test_engine_plan_routes_general_convs(idx):
    """A conv that is not a regular 1x1 or 3x3/s1 (stride 2, 5x5, VALID
    3x3, 1x1/s2, 2x2/s2, 7x7/s2) is kind "xla", as the JAX package's
    select_engine names it, and route ("conv", None) in every integer
    tier."""
    spec = _net(MIXED_CFG, True)[0]
    jspec = _net(MIXED_CFG, False)[0]
    l = next(c for c in spec.conv_layers() if c.idx == idx)
    jl = next(c for c in jspec.conv_layers() if c.idx == idx)
    knobs = dict(entry="sd", max_hw=2704)
    assert engine_plan.select_engine(l, spec) == "xla" == \
        jep.select_engine(jl, jspec, **knobs)
    assert engine_plan.kernels(spec, "int16")[idx] == ("conv", None)
    for tier in NET_TIERS:
        assert _port_model(MIXED_CFG, tier).route[idx] == ("conv", None)


@pytest.mark.parametrize("bad,why", [(dict(activation="relu"), "'relu'"),
                                     (dict(groups=2), "grouped")])
def test_engine_plan_refuses_general_convs_it_cannot_run(bad, why):
    """A strided conv with another activation, or groups, is refused, under
    an "xla" override too: the JAX package's integer convs raise for it."""
    spec = _net(MIXED_CFG, True)[0]
    l = dataclasses.replace(spec.conv_layers()[2], **bad)
    with pytest.raises(NotImplementedError, match=why):
        engine_plan.select_engine(l, spec)
    with pytest.raises(NotImplementedError, match=why):
        engine_plan.select_engine(l, spec, {l.idx: "xla"})


@pytest.mark.parametrize("plan_text,ok", [("2:conv3", False), ("2:mm", False),
                                          ("4:xla8", True), ("0:nchw", True),
                                          ("5:xla", True)])
def test_overrides_on_general_convs_as_yolotpu(monkeypatch, plan_text, ok):
    """YOLO2_Q16_PLAN on the mixed cfg's general convs: conv3 or mm on the
    3x3/s2 conv 2 raises ValueError in both packages (yolotpu's params_q16
    and the port's plan); xla8 on the 5x5 conv 4, nchw on the 7x7/s2 entry
    and xla on the 2x2/s2 conv 5 are accepted by both and run on the general
    conv in the port."""
    monkeypatch.setenv("YOLO2_Q16_PLAN", plan_text)
    jspec, jstore = _net(MIXED_CFG, False)
    spec = _net(MIXED_CFG, True)[0]
    idx = int(plan_text.split(":")[0])
    overrides = engine_plan.plan_overrides()
    if not ok:
        with pytest.raises(ValueError, match="not applicable"):
            jy.params_q16(jspec, jstore)
        with pytest.raises(ValueError, match="not applicable"):
            engine_plan.plan(spec, overrides)
        return
    jy.params_q16(jspec, jstore)
    kinds = engine_plan.plan(spec, overrides)
    assert kinds[idx] == overrides[idx]
    assert engine_plan.kernels(spec, "int16", overrides)[idx] == ("conv", None)


def test_sp_slab_serves_only_darknet_padding():
    """The sp slab rule (``parallel.forward.serves_on_slab``): a stride-1
    1x1 or 3x3 conv with darknet's padding runs on an H slab with a one-row
    halo; a VALID 3x3, a 1x1 with padding=1, a 5x5 and any strided conv
    gather H first."""
    spec = _net(MIXED_CFG, True)[0]
    by_idx = {l.idx: l for l in spec.conv_layers()}
    regular3, regular1 = by_idx[1], by_idx[3]
    assert serves_on_slab(regular3, 24) and serves_on_slab(regular1, 24)
    assert not serves_on_slab(dataclasses.replace(regular3, pad=0), 24)
    assert not serves_on_slab(dataclasses.replace(regular1, pad=1), 24)
    for idx in MIXED_GENERAL:
        assert not serves_on_slab(by_idx[idx], 24)
