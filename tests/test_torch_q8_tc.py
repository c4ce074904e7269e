"""The arithmetic and the weight layout of the 8-bit tiers' tensor-core 3x3
convs (yolotpu_torch.ops.q8: conv3x3_s8, conv3x3_int8 on the S8 scheme,
conv3x3_w8a16 on the W8A16 scheme of csrc/igemm_tc.cuh) against the JAX
package, on the CPU; test_torch_q8_mm_tc.py does the same for the 1x1
convs, mm_s8 and mm_w8a16.

The kernels run only on the card (chip_smoke.py holds them to their plain
versions there). What they compute is held here through ``tc.emulate``,
which sums from the packed weight planes
(``q8.pack_s8``, ``q8.pack_w8a16``) and the activations split as the kernels split them, with
every s32 partial sum checked: equal to the exact sums modulo 2^32
(``acc32(mm_sum64)``), to XLA's int32 dot and conv, and, through the
per-channel requant, to the Pallas kernels they replace
(``pallas_q16.conv3x3_s8_wi``, ``conv3x3_w8a16_wi``, interpret mode) and to
``convops.conv_w8a16`` on sums built to wrap.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax
import pytest
import torch

from yolotpu.ops import convops as jconv
from yolotpu.ops import pallas_q16 as pq16
from yolotpu_torch.ops import convops, q8, q16, tc

SCHEMES = {"s8": (tc.S8, np.int8), "w8a16": (tc.W8A16, np.int16)}
PACK = {tc.S8: q8.pack_s8, tc.W8A16: q8.pack_w8a16}
TARGET = {np.int8: 2**5, np.int16: 2**13}   # output spread the shifts aim at


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _draw(rng, shape, dtype, values=None):
    if values is not None:
        return rng.choice(values, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _unsaturated(out, leaky):
    lo, hi = np.iinfo(out.dtype).min, np.iinfo(out.dtype).max
    sat = (out == lo) | (out == hi)
    if leaky:
        sat |= out == -((-lo) // 10)
    return ~sat


@pytest.mark.parametrize("scheme", SCHEMES)
def test_pack_w8_layout(scheme):
    """Byte (g, h, r, e) of block (nb, kc) is w[32 kc + order[16 h + e],
    64 nb + 8 g + r] as a byte, order FRAG_K for W8A16 (int16 A) and
    0 .. 31 for S8; K is padded with zeros to the scheme's K step (128 for
    S8, 64 for W8A16) and N to 64."""
    sch = SCHEMES[scheme][0]
    k, n = 150, 100
    w = np.random.default_rng(9).integers(-128, 128, (k, n)).astype(np.int8)
    planes = PACK[sch](_t(w)).numpy()
    kp = -(-k // sch.bk) * sch.bk
    assert planes.shape == sch.planes_shape(k, n) == (2, kp // 32, 1, 8, 2, 8,
                                                      16)
    assert planes.dtype == np.uint8
    order = tc.FRAG_K if scheme == "w8a16" else tuple(range(32))
    wp = np.zeros((kp, 128), np.int64)
    wp[:k, :n] = w
    for nb in range(2):
        for kc in range(kp // 32):
            for g in range(8):
                for h in range(2):
                    ks = [32 * kc + order[16 * h + e] for e in range(16)]
                    want = wp[ks][:, 64 * nb + 8 * g:64 * nb + 8 * g + 8].T
                    np.testing.assert_array_equal(
                        planes[nb, kc, 0, g, h], want.astype(np.int8).view(np.uint8))
    # the padding is zeros
    full = tc.plane_matrix(_t(planes), 0, torch.int8).numpy()
    assert not full[[i for i in range(kp) if 32 * (i // 32) + order[i % 32] >= k]].any()
    assert not full[:, n:].any()


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("m,k,n,xvalues", [
    (40, 96, 64, "extremes"),   # x and w at the ends of their types
    (37, 300, 70, None),        # K not a multiple of 32, ragged N
    (20, 1024, 425, None),      # the head's N
    (9, 27, 32, None),          # the entry conv's K
])
def test_tc_sum_equals_exact_and_xla(scheme, m, k, n, xvalues):
    sch, xdtype = SCHEMES[scheme]
    rng = np.random.default_rng(k + n)
    xv = ({np.int8: (-128, 127), np.int16: (-32768, -32513, 32767)}[xdtype]
          if xvalues else None)
    x = _draw(rng, (m, k), xdtype, xv)
    w = _draw(rng, (k, n), np.int8, (-128, 127) if xvalues else None)
    tx, tw = _t(x), _t(w)
    got = tc.emulate(tx, PACK[sch](tw), k, n, sch)
    assert got.dtype == torch.int32
    assert torch.equal(got, q16.acc32(q16.mm_sum64(tx, tw)))
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("b,h,w_,c,n", [(2, 7, 5, 3, 40), (1, 6, 6, 40, 70)])
def test_tc_sum_of_im2col_equals_conv(scheme, b, h, w_, c, n):
    sch, xdtype = SCHEMES[scheme]
    rng = np.random.default_rng(c)
    x = _draw(rng, (b, h, w_, c), xdtype)
    w = _draw(rng, (3, 3, c, n), np.int8)
    tx, tw = _t(x), _t(w)
    got = tc.emulate(q16.im2col3x3(tx), PACK[sch](tw), 9 * c, n,
                     sch).reshape(b, h, w_, n)
    assert torch.equal(got, q16.acc32(q16.conv3x3_sum64(tx, tw)))
    # XLA's conv takes one dtype: int16 x int8 through int32, whose products
    # (|x*w| <= 2^22) and sums here stay exact
    xj, wj = (x, w) if xdtype == np.int8 else (x.astype(np.int32),
                                               w.astype(np.int32))
    want = lax.conv_general_dilated(
        jnp.asarray(xj), jnp.asarray(wj), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("vector,leaky", [(True, True), (False, False)])
def test_tc_sum_requant_equals_pallas(scheme, vector, leaky):
    """The emulated sums through the per-channel requant == the Pallas
    kernel the scheme replaces (K7 conv3x3_s8_wi, K6 conv3x3_w8a16_wi), with
    a shift per column or one for the layer."""
    sch, xdtype = SCHEMES[scheme]
    rng = np.random.default_rng(31 + vector)
    c, n = 32, 64
    xm = int(np.iinfo(xdtype).max)
    x = rng.integers(-xm - 1, xm + 1, (2, 8, 8, c)).astype(xdtype)
    x.flat[:2] = [-xm - 1, xm]
    w = rng.integers(-128, 128, (3, 3, c, n)).astype(np.int8)
    w.flat[:2] = [-128, 127]
    base = int(round(np.log2((9 * c) ** 0.5 * xm * 127 / 3 / TARGET[xdtype])))
    s = (base + rng.integers(-1, 2, n) if vector
         else np.full(n, base)).astype(np.int32)
    bias = rng.integers(-TARGET[xdtype] // 2, TARGET[xdtype] // 2,
                        n).astype(np.int32)
    sums = tc.emulate(q16.im2col3x3(_t(x)), PACK[sch](_t(w)), 9 * c,
                      n, sch).reshape(2, 8, 8, n)
    lo, hi = np.iinfo(xdtype).min, np.iinfo(xdtype).max
    got = convops.requant32(sums, _t(bias), _t(s), leaky, lo, hi).numpy()
    wp = pq16.prep_conv_weights_w8(w, bias, s if vector else int(s[0]))
    kernel = pq16.conv3x3_s8_wi if scheme == "s8" else pq16.conv3x3_w8a16_wi
    want = kernel(jnp.asarray(x), wp, leaky=leaky, interpret=True)
    assert want is not None
    want = np.asarray(want)[..., :n]
    np.testing.assert_array_equal(got.astype(want.dtype), want)
    assert _unsaturated(want, leaky).mean() > 0.5


def _wrap_operands(rng, rows, taps, n, shift, nblk=2, npair=8, ns=112):
    """x (rows, C) int16, w (taps, C, N) int8 whose exact sums leave int32
    but wrap to small values (as in test_torch_q8.py): blocks of 1024
    channels at -32768 or 0 in x and -128 or 0 in w, pairs (v, -v) x (u, u)
    at +-32767 and +-127 that cancel, and ns channels sized to the shift;
    channels shuffled."""
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


@pytest.mark.parametrize("shift", [3, 5])
def test_w8a16_tc_sum_wraps_like_xla(shift):
    """Sums outside int32, recombined as (high << 8) + low modulo 2^32 with
    no correction constant == the JAX package's plane-stacked conv."""
    bsz, h, wd, n = 1, 5, 4, 16
    x, w, b = _wrap_operands(np.random.default_rng(5 + shift), bsz * h * wd, 9,
                             n, shift)
    c = x.shape[-1]
    x, w = x.reshape(bsz, h, wd, c), w.reshape(3, 3, c, n)
    s = np.full(n, shift, np.int32)
    sums = tc.emulate(q16.im2col3x3(_t(x)), q8.pack_w8a16(_t(w)),
                      9 * c, n, tc.W8A16).reshape(bsz, h, wd, n)
    got = convops.requant32(sums, _t(b), _t(s), False).numpy().astype(np.int16)
    want = np.asarray(jconv.conv_w8a16(
        jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(jconv.prep_weights_w8a16(w)), jnp.asarray(b), 1, 1,
        "linear", jnp.asarray(s)))
    np.testing.assert_array_equal(got, want)
    exact = q16.conv3x3_sum64(_t(x), _t(w)).numpy()
    assert (_unsaturated(got, False) & (np.abs(exact) >= 2**31)).mean() > 0.1
    assert _unsaturated(got, False).mean() > 0.5


@pytest.mark.parametrize("scheme,c,xv", [
    ("s8", 3700, -128),          # K = 33,300 at x = w = -128
    ("w8a16", 3700, -32513),     # high byte -128, low byte 255
    ("w8a16", 7400, -32513),     # K = 66,600: an unchunked low sum leaves s32
])
def test_tc_sum_chunks_a_long_k(scheme, c, xv):
    """K beyond one split (tc.KMAX values of k) with operands at their
    extremes: every s32 partial sum stays inside s32 (tc.emulate raises
    otherwise), and the sums equal the exact ones modulo 2^32 and XLA's;
    tc.split cuts the same K into splits of at most tc.KMAX."""
    sch, xdtype = SCHEMES[scheme]
    k, n = 9 * c, 8
    x = np.full((2, k), xv, xdtype)
    w = np.full((k, n), -128, np.int8)
    tx, tw = _t(x), _t(w)
    got = tc.emulate(tx, PACK[sch](tw), k, n, sch)
    assert torch.equal(got, q16.acc32(q16.mm_sum64(tx, tw)))
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if scheme == "w8a16" and k > 65793:
        # the low bytes (255) times -128 over all of K would leave s32
        assert 255 * -128 * k < -2**31
    kps = tc.split(2, n, k, 132, sch)
    assert -(-k // (kps * sch.bk)) >= 2 and kps * sch.bk <= tc.KMAX


def test_tc_sum_raises_when_a_partial_leaves_s32():
    """The emulator checks each s32 set: a plane layout whose chunks were
    longer than tc.KMAX would fail here, not pass silently."""
    k = 66600
    x = _t(np.full((1, k), -32513, np.int16))
    planes = q8.pack_w8a16(_t(np.full((k, 8), -128, np.int8)))
    kmax = tc.KMAX
    try:
        tc.KMAX = 1 << 20   # one chunk: the low sum is 255 * -128 * K
        with pytest.raises(OverflowError):
            tc.emulate(x, planes, k, 8, tc.W8A16)
    finally:
        tc.KMAX = kmax


@pytest.mark.parametrize("name", ["conv3x3_s8", "conv3x3_w8a16",
                                  "conv3x3_int8", "mm_s8", "mm_w8a16"])
def test_planes_required_on_card_ignored_by_plain(name):
    """On the card each wrapper raises without planes= (naming its scheme's
    packer, a function of q8 that packs this kernel's weight) or with planes
    of the wrong shape; the plain versions and the CPU path take planes= and
    do not read them."""
    sch = tc.W8A16 if name.endswith("w8a16") else tc.S8
    mm = name.startswith("mm")
    wshape = (16, 8) if mm else (3, 3, 16, 8)
    k = 16 if mm else 9 * 16
    assert sch.pack == {tc.S8: "pack_s8", tc.W8A16: "pack_w8a16"}[sch]
    with pytest.raises(TypeError, match=f"planes={sch.pack}"):
        tc.check_planes(name, None, k, 8, torch.device("cpu"), sch)
    good = getattr(q8, sch.pack)(torch.zeros(wshape, dtype=torch.int8))
    tc.check_planes(name, good, k, 8, torch.device("cpu"), sch)
    other = tc.S8 if sch is tc.W8A16 else tc.W8A16
    wrong = PACK[other](torch.zeros((3, 3, 16, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="planes"):
        tc.check_planes(name, wrong, k, 8, torch.device("cpu"), sch)

    rng = np.random.default_rng(3)
    xdtype = np.int16 if name.endswith("w8a16") else np.int8
    x = _t(rng.integers(-9, 9, (20, 16) if mm else (1, 5, 4, 16)).astype(xdtype))
    w = _t(rng.integers(-9, 9, wshape).astype(np.int8))
    b = torch.zeros(8, dtype=torch.int32)
    shift = 2 if name == "conv3x3_int8" else torch.full((8,), 2, dtype=torch.int32)
    plain = getattr(q8, name + "_plain")
    want = plain(x, w, b, shift, True)
    junk = torch.full((3,), 7, dtype=torch.uint8)
    assert torch.equal(plain(x, w, b, shift, True, planes=junk), want)
    assert torch.equal(getattr(q8, name)(x, w, b, shift, True, planes=junk), want)
    assert q8.LAUNCHES[name] == 0


@pytest.mark.parametrize("tier,packer", [("int8", q8.pack_s8),
                                         ("w8a16", q8.pack_w8a16)])
def test_model_packs_the_conv3_weights(tier, packer):
    """YoloV2Q packs, off the CPU, the weights of every conv of its 8-bit
    tier, 3x3 and 1x1, the int8 convs fused with their pool included, with
    that tier's packer (buffers p{idx} of the planes' shape), and none on
    the CPU; the packed planes of the entry conv give its sums."""
    from yolotpu_torch.models import engine_plan, yolov2, zoo
    from yolotpu_torch.models.yolov2 import YoloV2Q
    from yolotpu_torch.runtime.engine import load_or_synthesize
    spec = zoo.build("yolov2", width=64, height=64)
    routes = {"mm", "conv3", "conv"} | ({"conv3_pool"} if tier == "int8"
                                        else set())
    assert YoloV2Q.packers[tier] == dict.fromkeys(routes, packer)
    route = engine_plan.kernels(spec, tier)
    used = {"mm", "conv3"} | ({"conv3_pool"} if tier == "int8" else set())
    assert {k for k, _ in route.values()} == used
    assert YoloV2Q.kernels[tier][1].__name__.startswith("conv3x3_")
    store = load_or_synthesize(spec, None, precision=tier, seed=0)
    params = (yolov2.params_int8 if tier == "int8"
              else yolov2.params_w8a16)(spec, store, "cpu")
    qtables = store.qtables8 if tier == "int8" else store.qtables_w8
    sch = tc.S8 if tier == "int8" else tc.W8A16
    on_cpu = YoloV2Q(spec, qtables, params, "cpu", tier)
    off_cpu = YoloV2Q(spec, qtables, params, "meta", tier)
    kinds = set()
    for l in spec.conv_layers():
        assert not hasattr(on_cpu, f"p{l.idx}")
        planes = getattr(off_cpu, f"p{l.idx}")
        assert planes.dtype == torch.uint8 and tuple(planes.shape) == \
            sch.planes_shape(l.c * l.size * l.size, l.n)
        kinds.add(route[l.idx][0])
    assert kinds == used
    l = spec.conv_layers()[0]
    assert route[l.idx][0] == ("conv3_pool" if tier == "int8" else "conv3")
    assert l.c == 3
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (3, 3, l.c, l.n)).astype(np.int8)
    xdtype = np.int8 if tier == "int8" else np.int16
    x = _draw(rng, (1, 6, 6, l.c), xdtype)
    sch = tc.S8 if tier == "int8" else tc.W8A16
    sums = tc.emulate(q16.im2col3x3(_t(x)), packer(_t(w)), 9 * l.c, l.n, sch)
    assert torch.equal(sums.reshape(1, 6, 6, l.n),
                       q16.acc32(q16.conv3x3_sum64(_t(x), _t(w))))


# yolov2 416's 1x1 convs (5; 9; 13 and 15; 26; 19 and 21; 30): H*W, K, N
MM_SHAPES = [(104 * 104, 128, 64), (52 * 52, 256, 128), (26 * 26, 512, 256),
             (26 * 26, 512, 64), (13 * 13, 1024, 512), (13 * 13, 1024, 425)]

# (scheme, M, N, K, splits): the 8-bit tiers' yolov2 416 3x3 shapes at batch 1
# and 8 as chip_smoke.py's split sweep timed them on the card. S8's waves
# count two blocks per SM: its 13x13 convs at batch 1 were fastest at 4-5
# splits, and counting three or four per SM chose 8-11
@pytest.mark.parametrize("scheme,m,n,k,want", [
    ("s8", 169, 1024, 4608, 5),
    ("s8", 169, 1024, 9216, 5),
    ("s8", 169, 1024, 11520, 5),
    ("s8", 676, 512, 2304, 1),      # 26x26 at b=1: unsplit was fastest
    ("s8", 1352, 1024, 11520, 1),   # 13x13 at b=8: tiles enough
    ("w8a16", 169, 1024, 9216, 8),
    ("w8a16", 676, 512, 2304, 4),
    ("w8a16", 2704, 256, 1152, 1),
    # the eight 1x1 convs (six shapes) at batch 1 and 8: with 1 to 16 K steps
    # the sweep found every one fastest unsplit, under both schemes, the
    # 13x13 ones at batch 1 (21 to 24 output tiles) included
    *((scheme, b * hw, n, k, 1) for scheme in ("s8", "w8a16") for b in (1, 8)
      for hw, k, n in MM_SHAPES),
])
def test_tc_split_8bit(scheme, m, n, k, want):
    sch = SCHEMES[scheme][0]
    kps = tc.split(m, n, k, 132, sch)
    ktiles = -(-k // sch.bk)
    assert -(-ktiles // kps) == want and kps * sch.bk <= tc.KMAX
