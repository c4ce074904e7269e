"""The int8 tier's fused conv+pool kernel (yolotpu_torch.ops.q8.conv3x3_pool_s8)
and the route that engages it, held on the CPU at small sizes.

The kernel is conv3x3_s8's implicit GEMM on the 8-bit tensor cores (the S8
scheme) with the output pixels visited window-major and the darknet 2x2/s2
pool in the epilogue, in darknet's order: each member requantized with its
column's bias and shift, then the max. Its arithmetic is rebuilt here from
the port's own pieces: the im2col rows in ``q16.window_major`` order, the S8
sums from the packed planes (``tc.emulate`` with ``q8.pack_s8``), the
per-channel requant of each row, then the max of rows 4i .. 4i+3. That must
equal, bit for bit, the plain version, conv3x3_s8's plain version followed
by ``pool.maxpool``, and the JAX package's int8 conv followed by its maxpool,
on the same seeded numpy inputs: at C=3, C%16==0 and another C, leaky and
linear, per-channel shifts small and large, outputs saturated at both ends
of int8, and K beyond one s32 partial sum, sums that wrap included. The
kernel itself runs only on the card, where chip_smoke.py holds it to the
plain versions.

Then the route: the int8 and int16 tiers fold every regular 3x3 that a
darknet 2x2/s2 pool follows, and whose own output no route reads, by one
rule decided from the graph (int16 in order "acc", int8 in darknet's), at
yolov2 416 and 608, yolov2-tiny and yolov2-s2; w8a16 folds nothing; the
CPU engine of each tier runs that route.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_engine_plan_chip import yolov2_s2
from test_torch_forward_q8 import _inputs, _jax_forward, _tier
from yolotpu.ops import convops as jconv
from yolotpu.ops import pool as jpool
from yolotpu_torch.graph import MaxPoolSpec
from yolotpu_torch.models import engine_plan, zoo
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.ops import _build, convops, pool, q8, q16, tc
from yolotpu_torch.runtime import engine
from yolotpu_torch.weights import QTables

# output spread the aimed shifts give, as in test_torch_q8_tc.py
TARGET = 2**5
# C -> (B, H, W, N): the entry conv's C=3 (gathered by kernel rows), a C
# that takes 16-byte copies, and one that does not, with a ragged N
SHAPES = {3: (2, 6, 8, 32), 32: (1, 8, 6, 64), 24: (2, 4, 10, 20)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _emulated(x, w, bias, shift, leaky):
    """conv3x3_pool_s8 as the kernel computes it: window-major im2col rows,
    the S8 sums from the packed plane, each row requantized with its
    column's bias and shift, then the max of a window's four rows."""
    b, h, wd, c = x.shape
    n = w.shape[-1]
    rows = q16.im2col3x3(_t(x))[q16.window_major(b, h, wd)]
    sums = tc.emulate(rows, q8.pack_s8(_t(w)), 9 * c, n, tc.S8)
    v = convops.requant32(sums, _t(bias), _t(shift), leaky, -128, 127)
    # rows (b, ho, wo, dy, dx): a window's four members are consecutive
    return v.reshape(b, h // 2, wd // 2, 4, n).amax(dim=3).to(
        torch.int8).numpy()


def _references(x, w, bias, shift, leaky):
    """The plain version, conv3x3_s8's plain version then the port's
    maxpool, and the JAX package's int8 conv then its maxpool."""
    tx, tw, tb, ts = _t(x), _t(w), _t(bias), _t(shift)
    plain = q8.conv3x3_pool_s8_plain(tx, tw, tb, ts, leaky).numpy()
    unfused = pool.maxpool(q8.conv3x3_s8_plain(tx, tw, tb, ts, leaky),
                           2, 2, 1).numpy()
    conv = jconv.conv_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                           1, 1, "leaky" if leaky else "linear",
                           jnp.asarray(shift))
    jax = np.asarray(jpool.maxpool(conv, 2, 2, 1))
    return plain, unfused, jax


def _operands(rng, c, kind):
    """x, w, bias and an (N,) shift for SHAPES[c]. ``kind``: "aimed" (the
    shifts put most outputs inside int8, one per column around the
    spread's), "small" (shifts -1 to 2 on small operands), "large" (shifts
    20 to 40, beyond the requant's cap of 30, on full-range operands), or
    "saturating" (operands at the ends of int8, so outputs saturate at both
    ends)."""
    b, h, wd, n = SHAPES[c]
    if kind == "small":
        x = rng.integers(-3, 4, (b, h, wd, c))
        w = rng.integers(-3, 4, (3, 3, c, n))
        shift = rng.integers(-1, 3, n)
    elif kind == "saturating":
        x = rng.choice([-128, 127], (b, h, wd, c))
        w = rng.choice([-128, 127], (3, 3, c, n))
        shift = rng.integers(3, 6, n)
    else:
        x = rng.integers(-128, 128, (b, h, wd, c))
        w = rng.integers(-128, 128, (3, 3, c, n))
        base = int(round(np.log2((9 * c) ** 0.5 * 127 * 127 / 3 / TARGET)))
        shift = (base + rng.integers(-1, 2, n) if kind == "aimed"
                 else rng.integers(20, 41, n))
    bias = rng.integers(-TARGET // 2, TARGET // 2, n)
    return (x.astype(np.int8), w.astype(np.int8), bias.astype(np.int32),
            shift.astype(np.int32))


@pytest.mark.parametrize("kind", ["aimed", "small", "large", "saturating"])
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("c", sorted(SHAPES))
def test_emulated_kernel_equals_plain_unfused_and_jax(c, leaky, kind):
    x, w, bias, shift = _operands(np.random.default_rng(c * 10 + leaky),
                                  c, kind)
    got = _emulated(x, w, bias, shift, leaky)
    b, h, wd, n = SHAPES[c]
    assert got.shape == (b, h // 2, wd // 2, n)
    for want in _references(x, w, bias, shift, leaky):
        np.testing.assert_array_equal(got, want)
    if kind == "aimed":
        # outputs that depend on the sums: most are not saturated
        sat = (got == 127) | (got == (-12 if leaky else -128))
        assert (~sat).mean() > 0.5
    if kind == "saturating":
        assert (got == 127).any() and (got == (-12 if leaky else -128)).any()


@pytest.mark.parametrize("c,fill", [(3700, None), (14608, -128)])
def test_emulated_kernel_beyond_one_split_of_k(c, fill):
    """K = 9C past tc.KMAX: 33,300 on random operands, and 131,472 with
    every operand at -128 on a 4x4 image, where the exact sums of the four
    inner pixels (nine taps in the image) leave int32 and wrap and the
    others' do not; emulate raises if a partial sum would leave s32."""
    assert 9 * c > tc.KMAX
    rng = np.random.default_rng(c)
    n = 8
    if fill is None:
        x = rng.integers(-128, 128, (1, 2, 4, c)).astype(np.int8)
        w = rng.integers(-128, 128, (3, 3, c, n)).astype(np.int8)
        shift = np.full(n, 12, np.int32)
    else:
        x = np.full((1, 4, 4, c), fill, np.int8)
        w = np.full((3, 3, c, n), fill, np.int8)
        shift = np.arange(24, 24 + n, dtype=np.int32)
        assert 6 * c * 128 * 128 < 2**31 <= 9 * c * 128 * 128
    bias = rng.integers(-8, 8, n).astype(np.int32)
    got = _emulated(x, w, bias, shift, True)
    for want in _references(x, w, bias, shift, True):
        np.testing.assert_array_equal(got, want)


def _small_case():
    rng = np.random.default_rng(73)
    x = _t(rng.integers(-99, 99, (2, 4, 6, 8)).astype(np.int8))
    w = _t(rng.integers(-99, 99, (3, 3, 8, 5)).astype(np.int8))
    return (x, w, torch.zeros(5, dtype=torch.int32),
            torch.full((5,), 6, dtype=torch.int32))


@pytest.mark.parametrize("h,wd", [(3, 4), (4, 5), (5, 7)])
def test_odd_h_or_w_refused(h, wd):
    x = torch.zeros((1, h, wd, 8), dtype=torch.int8)
    _, w, b, s = _small_case()
    with pytest.raises(ValueError, match="even H and W"):
        q8.conv3x3_pool_s8(x, w, b, s, True)


def test_planes_required_off_the_cpu(monkeypatch):
    """The wrapper's card branch, reached here with tensors on the meta
    device and the launch recorded instead of made: without planes= it
    raises naming pack_s8, with planes of another weight it raises, and
    with pack_s8(w) it hands the C entry point its arguments in the order
    of _build.SIGNATURES (x, planes, bias, shift, out, workspace, B, H, W,
    C, N, leaky, K steps per split; the stream is added by
    _build.launch)."""
    x, w, b, s = (t.to("meta") for t in _small_case())
    calls = []
    monkeypatch.setattr(q16, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(tc, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, out, *args, counts: calls.append(
                            (name, fn, out, args)) or out)
    with pytest.raises(TypeError, match="planes=pack_s8"):
        q8.conv3x3_pool_s8(x, w, b, s, True)
    wrong = q8.pack_s8(torch.zeros((3, 3, 16, 5), dtype=torch.int8,
                                   device="meta"))
    with pytest.raises(ValueError, match="planes"):
        q8.conv3x3_pool_s8(x, w, b, s, True, planes=wrong)
    assert not calls
    out = q8.conv3x3_pool_s8(x, w, b, s, False, planes=q8.pack_s8(w))
    assert out.shape == (2, 2, 3, 5) and out.dtype == torch.int8
    (name, fn, _, args), = calls
    assert (name, fn) == ("conv3x3_pool_s8", "yq8_conv3x3_pool_s8")
    assert len(args) == len(_build.SIGNATURES[fn]) - 1   # all but the stream
    # K = 72 is one K step and M = 48 rows one tile: unsplit, no workspace
    assert args[5] is None
    assert args[6:] == (2, 4, 6, 8, 5, 0, 1)


def test_planes_ignored_on_the_cpu_and_by_the_plain_version():
    x, w, b, s = _small_case()
    junk = torch.full((3,), 7, dtype=torch.uint8)
    want = pool.maxpool(q8.conv3x3_s8_plain(x, w, b, s, True), 2, 2, 1)
    assert torch.equal(q8.conv3x3_pool_s8_plain(x, w, b, s, True,
                                                planes=junk), want)
    assert torch.equal(q8.conv3x3_pool_s8(x, w, b, s, True, planes=junk),
                       want)
    assert q8.LAUNCHES["conv3x3_pool_s8"] == 0


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

WEIGHT_DTYPE = {"int16": torch.int16, "int8": torch.int8,
                "w8a16": torch.int8}
PACK = {"int16": q16.pack_q16, "int8": q8.pack_s8, "w8a16": q8.pack_w8a16}
SCHEME = {"int16": tc.Q16, "int8": tc.S8, "w8a16": tc.W8A16}


def _meta_model(precision, outputs=("head",), overrides=None):
    """A YoloV2Q of yolov2 416 with zero weights and Q tables on the meta
    device: its routes and packed planes, with no data."""
    spec = zoo.build("yolov2")
    convs = spec.conv_layers()
    qt = QTables([0] * len(convs), [0] * len(convs), [0] * (len(convs) + 1))
    params = {f"conv{l.idx}": {
        "w": torch.zeros((l.size, l.size, l.c, l.n),
                         dtype=WEIGHT_DTYPE[precision], device="meta"),
        "b": torch.zeros(l.n, dtype=torch.int32, device="meta")}
        for l in convs}
    return spec, ty.YoloV2Q(spec, qt, params, "meta", precision, overrides,
                            outputs)


def _rule(spec):
    """The rule's routes, as every tier took them before the int8 fold."""
    return {l.idx: ("mm" if l.size == 1 else "conv3", None)
            for l in spec.conv_layers()}


def test_int8_routes_fold_the_pools_at_yolov2_416():
    """Convs 0, 2, 6 and 10 compute the pool after them; conv 16, whose own
    output route 25 reads, and the head16 conv (30) do not; every fused conv
    keeps conv3x3_s8's planes."""
    spec, net = _meta_model("int8")
    assert ty.YoloV2Q.pooled["int8"] is q8.conv3x3_pool_s8
    assert ty.YoloV2Q.packers["int8"]["conv3_pool"] is q8.pack_s8
    want = _rule(spec)
    want.update(dict.fromkeys((0, 2, 6, 10), ("conv3_pool", None)))
    assert net.route == want
    assert net.route[16] == ("conv3", None) and net.route[30] == ("mm", None)
    assert net.head16 == 30
    assert net.folded == {1, 3, 7, 11}
    assert engine_plan.next_is_pool22(spec, 16) and 16 in spec.layers[25].layers
    for i in (0, 2, 6, 10):
        l = spec.layers[i]
        planes = getattr(net, f"p{i}")
        assert planes.dtype == torch.uint8 and tuple(planes.shape) == \
            tc.S8.planes_shape(9 * l.c, l.n)


def test_int8_acts_leaves_every_conv_unfused():
    spec, net = _meta_model("int8", outputs=("acts",))
    assert net.route == _rule(spec)
    assert not net.folded


P1 = "0:entry_sdmm,2:sd_pool,6:sd_pool,10:sd_pool"


@pytest.mark.parametrize("precision,plan", [
    ("int16", None), ("int16", P1), ("w8a16", None)])
def test_other_tiers_routes_unchanged(precision, plan):
    """The int16 tier folds by the graph as int8 does, in order "acc": by
    the rule alone and under P1's kinds (the plan the H100's search chose),
    the same four convs, on conv3x3_q16's planes; the w8a16 tier, which has
    no pooled kernel, folds nothing."""
    spec = zoo.build("yolov2")
    overrides = plan and engine_plan._parse_plan_items(plan)
    _, net = _meta_model(precision, overrides=overrides)
    want = _rule(spec)
    if precision == "int16":
        want.update(dict.fromkeys((0, 2, 6, 10), ("conv3_pool", "acc")))
    assert net.route == want
    assert net.folded == ({1, 3, 7, 11} if precision == "int16" else set())
    for l in spec.conv_layers():
        assert tuple(getattr(net, f"p{l.idx}").shape) == \
            SCHEME[precision].planes_shape(l.size ** 2 * l.c, l.n)


# model -> (its spec, the convs that a darknet 2x2/s2 pool follows and no
# route reads)
FOLD_MODELS = {
    "yolov2 416": (lambda: zoo.build("yolov2"), {0, 2, 6, 10}),
    "yolov2 608": (lambda: zoo.build("yolov2", width=608, height=608),
                   {0, 2, 6, 10}),
    "yolov2-tiny": (lambda: zoo.build("yolov2-tiny"), {0, 2, 4, 6, 8}),
    "yolov2-s2": (lambda: yolov2_s2(416), set()),
}


@pytest.mark.parametrize("model", sorted(FOLD_MODELS))
@pytest.mark.parametrize("tier", ["int16", "int8"])
def test_fold_is_decided_by_the_graph(tier, model):
    """One rule for both integer tiers: yolov2's conv 16, which route 25
    reads, yolov2-tiny's 2x2/s1 pool after conv 10 and yolov2-s2's strided
    convs fold nothing; each other regular 3x3 that a 2x2/s2 pool follows
    folds it, in order "acc" in int16 and darknet's (None) in int8;
    ``unfused`` and w8a16 give the convs alone."""
    build, folds = FOLD_MODELS[model]
    spec = build()
    route = engine_plan.kernels(spec, tier)
    order = {"int16": "acc", "int8": None}[tier]
    assert {i: o for i, (k, o) in route.items() if k == "conv3_pool"} == \
        dict.fromkeys(folds, order)
    assert all(engine_plan.next_is_pool22(spec, i) for i in folds)
    if 16 in route and model != "yolov2-s2":
        assert engine_plan.next_is_pool22(spec, 16) and route[16][0] == "conv3"
    assert ty.unfused(route) == engine_plan.kernels(spec, "w8a16")
    pools = [l for l in spec.layers if isinstance(l, MaxPoolSpec)]
    assert len(pools) == {"yolov2-tiny": 6, "yolov2-s2": 0}.get(model, 5)


@pytest.mark.parametrize("model,size,tier", [("yolov2", 64, "int8-pc"),
                                             ("yolov2-tiny", 96, "int8")])
def test_small_int8_forward_equals_jax(model, size, tier, monkeypatch):
    """The int8 forward with its pools folded equals the JAX package's int8
    forward and the same model with the fold turned off, bit for bit."""
    spec, store, precision, qt, _, tparams = _tier(model, size, tier, True)
    x = _inputs(size, "uint8")
    want = np.asarray(_jax_forward(model, size, tier)(jnp.asarray(x))["head"])
    params = tparams(spec, store)
    net = ty.YoloV2Q(spec, qt, params, "cpu", precision)
    assert len(net.folded) == (4 if model == "yolov2" else 5)
    np.testing.assert_array_equal(net(_t(x))["head"].numpy(), want)
    monkeypatch.setattr(engine_plan, "FOLD_ORDER", {})
    unfused = ty.YoloV2Q(spec, qt, params, "cpu", precision)
    assert not unfused.folded
    np.testing.assert_array_equal(unfused(_t(x))["head"].numpy(), want)


@pytest.mark.parametrize("precision,plan,fused", [
    ("int8", "", 4), ("int16", P1, 4), ("int16", "", 4),
    ("int16", "0:xla,2:conv3,6:conv3,10:conv3", 0), ("w8a16", "", 0)])
def test_engine_routes_the_pools(precision, plan, fused, monkeypatch):
    """The CPU engine runs the card's route: 4 of yolov2's 5 2x2/s2 pools
    computed in a conv in int8 and int16 (by the rule, or under P1's
    kinds), none under the lever that names every one of those convs
    unfused or in w8a16; its heads equal the unfused model's."""
    monkeypatch.setenv("YOLO2_Q16_PLAN", plan)
    spec = zoo.build("yolov2", width=64, height=64)
    store = engine.load_or_synthesize(spec, None, precision, synthetic=True)
    eng = engine.Engine(spec, store, precision=precision, device="cpu")
    assert eng.model.route == engine_plan.kernels(
        spec, precision, engine_plan.tier_overrides(precision))
    assert len(eng.model.folded) == fused
    assert eng.model.folded <= {1, 3, 7, 11}
    frames = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3),
                                               dtype=np.uint8)
    alone = ty.YoloV2Q(spec, eng.qtables, eng.params, "cpu", precision,
                       outputs=("head",))
    alone.route, alone.folded = ty.unfused(alone.route), set()
    assert torch.equal(eng.model(_t(frames))["head"], alone(_t(frames))["head"])
