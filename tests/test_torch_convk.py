"""The stream-K schedule of the general convs (``ops.tc.stream_k`` on
``ops.tc.convk_tile``, the kernel ``csrc/convk_tc.cuh`` behind
``q16.conv_q16``, ``q8.conv_w8a16`` and ``q8.conv_s8``), on the CPU:

- the planner on yolov2-s2's five strided convs at batch 1, 2 and 8 and on
  edge shapes, for an H100's 132 SMs and for a few SMs: every (tile, K step)
  unit in exactly one segment, shares that differ by at most one step, no
  segment longer than KMAX / BK steps or across a tile, a grid no larger
  than the SMs times the blocks that stay on one, and each shared tile's
  partials found where they were left;
- the tile as a function of the shape;
- the stream-K schedule emulated (whole tiles are the planner's choice
  where they cost no more): ``tc.emulate`` of each segment's K steps of its
  tile, the partials added modulo 2^32 in a shuffled order, then the
  requant, equal to ``conv_q16_plain`` / ``conv_w8a16_plain`` /
  ``conv_s8_plain`` (int8 and int16 output) and to the JAX package's
  ``convops.conv_int16`` / ``conv_w8a16`` / ``conv_int8`` (``head16`` for
  the int16 output) on seeded inputs, sums that wrap included;
- the wrappers' card branch, reached with meta tensors: the entry point
  gets the plan's tile, grid and counters.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from yolotpu.ops import convops as jconv
from yolotpu_torch.ops import _build, convops, q8, q16, tc
from yolotpu_torch.tools import convk_stamps

SMS = 132   # an H100's
# yolov2-s2's five 3x3/s2 convs (H = W, C = N)
S2 = ((416, 32), (208, 64), (104, 128), (52, 256), (26, 512))
# (M, N, K) edge shapes: one tile, M < 64, N of 24, 40, 425, C = 13, K past
# KMAX (a 7x7 conv over 1024 channels)
EDGES = ((16, 64, 4608), (5, 7, 147), (200, 24, 576), (200, 32, 576),
         (200, 40, 576), (200, 425, 576), (56, 40, 117), (25, 16, 50176))
SCHEMES = (tc.Q16, tc.W8A16, tc.S8)
PLANS = ([(b * (h // 2) ** 2, c, 9 * c, SMS) for h, c in S2 for b in (1, 2, 8)]
         + [(*e, SMS) for e in EDGES]
         + [(121, 64, 4608, 1), (121, 64, 4608, 2), (200, 425, 576, 7)])


def _plan(m, n, k, sms, scheme):
    return tc.stream_k(m, n, k, sms, scheme,
                       tc.convk_tile(m, n, k, sms, scheme))


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s.name)
@pytest.mark.parametrize("shape", PLANS, ids=lambda s: "x".join(map(str, s)))
def test_stream_k_plan_covers_each_unit_once(shape, scheme):
    m, n, k, sms = shape
    p = _plan(m, n, k, sms, scheme)
    assert p.tiles == -(-m // p.bm) * -(-n // p.bn)
    assert p.ktiles == -(-k // scheme.bk) and p.kchunk == tc.KMAX // scheme.bk
    assert 1 <= p.grid <= sms * tc.CONVK_BLOCKS[(scheme.name, p.bm, p.bn)]
    shares = [p.start(b + 1) - p.start(b) for b in range(p.grid)]
    assert sum(shares) == p.units and min(shares) > 0
    if p.quantum == 1:   # stream-K
        assert p.grid == 1 or p.units // p.grid >= tc.SK_MIN_STEPS
        assert max(shares) - min(shares) <= 1
    else:   # whole tiles, at most one more on a block than on another
        assert p.quantum == p.ktiles and p.grid == min(
            p.tiles, sms * tc.CONVK_BLOCKS[(scheme.name, p.bm, p.bn)])
        assert max(shares) - min(shares) <= p.ktiles
        assert all(v % p.ktiles == 0 for v in shares)
    seen = np.zeros((p.tiles, p.ktiles), np.int64)
    blocks: dict[int, list] = {}
    for b, t, k0, k1 in p.segments():
        assert 0 <= k0 < k1 <= p.ktiles and k1 - k0 <= p.kchunk
        assert k0 // p.kchunk == (k1 - 1) // p.kchunk   # within one s32 set
        assert p.start(b) <= t * p.ktiles + k0 and t * p.ktiles + k1 <= p.start(b + 1)
        seen[t, k0:k1] += 1
        blocks.setdefault(t, []).append(b)
    assert (seen == 1).all()
    # a shared tile's partials: each block's two regions hold one partial
    # each, and the completing segment reads where the others wrote
    shared = [t for t, bs in blocks.items() if len(bs) > 1 or p.chunked]
    assert bool(shared) == (p.slots > 0)
    if p.chunked:
        assert p.slots == p.tiles
        assert p.workspace_words == p.tiles * (p.bm * p.bn + 1)
        return
    written = {}
    for t in shared:
        assert 0 <= p.slot(t) < p.slots
        regions = sorted(p.region(b, t) for b in blocks[t])
        assert regions == sorted(p.regions(t))
        for r in regions:
            assert r not in written and r // 2 < p.grid
            written[r] = t
    assert len({p.slot(t) for t in shared}) == len(shared)
    assert p.workspace_words == (2 * p.grid * p.bm * p.bn + p.grid
                                 if shared else 0)


@pytest.mark.parametrize("n,bn", [(7, 32), (24, 32), (32, 32), (33, 64),
                                  (64, 64), (425, 64), (1024, 64)])
def test_convk_tile_fits_n(n, bn):
    """A 32-wide tile where N <= 32 (no tensor-core work on columns past
    N), 64 wide otherwise; the tile is one the kernel builds."""
    for scheme in SCHEMES:
        for m in (16, 43264, 346112):
            tile = tc.convk_tile(m, n, 288, SMS, scheme)
            assert tile[1] == bn and tile in tc.CONVK_TILES


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s.name)
def test_convk_tile_rows_by_the_work(scheme):
    """128 rows only for Q16 at 64-wide columns and at least CONVK_WIDE K
    steps of 64 x 64 tiles for each block the card keeps: yolov2-s2's
    strided convs at batch 8 but for the 32-wide first one, none at
    batch 1; W8A16 and S8 always 64 rows."""
    for b in (1, 8):
        for h, c in S2:
            m, k = b * (h // 2) ** 2, 9 * c
            units = -(-m // 64) * -(-c // 64) * -(-k // scheme.bk)
            wide = units >= tc.CONVK_WIDE * SMS * tc.CONVK_BLOCKS[
                (scheme.name, 64, 64)]
            want = (128 if scheme is tc.Q16 and c > 32 and wide else 64,
                    32 if c <= 32 else 64)
            assert tc.convk_tile(m, c, k, SMS, scheme) == want
            assert want[0] == (128 if scheme is tc.Q16 and b == 8 and c > 32
                               else 64)


# (B, H, W, C, N, k, stride, pad, SMs): each schedule shares tiles
CASES = {
    "2tiles-4blocks": (1, 22, 22, 256, 64, 3, 2, 1, 2),
    "2tiles-6blocks": (1, 22, 22, 256, 64, 3, 2, 1, 3),
    "one-tile-N24": (1, 8, 8, 256, 24, 3, 2, 1, SMS),
    "N425-C13": (1, 11, 9, 13, 425, 5, 2, 2, 3),
    "5x5-N40": (2, 9, 10, 16, 40, 5, 1, 2, 5),
    "5x5-N40-C32": (2, 9, 10, 32, 40, 5, 1, 2, 5),
}
# the int8 tiers' cases: 5x5-N40's 12 K steps of 128 k take one block
CASES8 = [c for c in CASES if c != "5x5-N40"]
# the spread the requantized narrow sums aim for, by output type
TARGET = {torch.int16: 2 ** 12, torch.int8: 2 ** 5}
# w8a16 sums built to wrap: a 3x3/s2 conv over 1024 + 37 channels, one
# output tile of 150 K steps spread over 18 blocks
WRAP8 = (1, 5, 6, 1061, 24, 3, 2, 1, SMS)
WRAP8_BLOCK = 1024   # 1024 products (-32768)*(-128) = 2^32
# int8 sums built to wrap: a 1x1/s2 conv over 2^18 + 37 channels, one
# output tile of 2049 K steps (past KMAX: a zeroed slot) on 3 blocks
WRAP_S8 = (1, 5, 4, 2 ** 18 + 37, 24, 1, 2, 0, 1)
WRAP_S8_BLOCK = 2 ** 18   # 2^18 products (-128)*(-128) = 2^32
# tier -> the general conv's scheme, its packer and output type
TIERS = {"int16": (tc.Q16, q16.pack_q16, torch.int16),
         "w8a16": (tc.W8A16, q8.pack_w8a16, torch.int16),
         "int8": (tc.S8, q8.pack_s8, torch.int8),
         "int8-head16": (tc.S8, q8.pack_s8, torch.int16)}


def _geometry(case: str) -> tuple:
    return {"wrap8": WRAP8, "wrap_s8": WRAP_S8}.get(case) or CASES[case]


def _operands(case: str, tier: str, wrap: bool):
    """x, w, bias and shift (an int for int16, a vector within 1 of a base
    for the 8-bit-weight tiers) of a case: narrow operands with the shift
    that spreads the sums about TARGET (int8-head16: int8's operands, whose
    bias and shift head16 moves to int16); with ``wrap`` full-range int16
    at shift 16, or for w8a16 blocks of WRAP8_BLOCK channels of -32768 (x)
    and -128 (w), for int8 blocks of WRAP_S8_BLOCK channels of -128 (x and
    w), that add multiples of 2^32."""
    b, h, wd, c, n, k = _geometry(case)[:6]
    int8 = tier.startswith("int8")
    rng = np.random.default_rng([(list(CASES) + ["wrap8", "wrap_s8"]).index(
        case), wrap, tier == "w8a16", int8])
    target = TARGET[torch.int8 if int8 else torch.int16]
    bias = rng.integers(-target // 4, target // 4, n).astype(np.int32)
    if case == "wrap_s8":
        blk = WRAP_S8_BLOCK
        x = np.zeros((b, h, wd, c), np.int8)
        w = np.zeros((k, k, c, n), np.int8)
        x[..., :blk] = np.where(rng.random((b, h, wd, 1)) < 0.6, -128, 0)
        w[:, :, :blk] = np.where(rng.random((k, k, 1, n)) < 0.6, -128, 0)
        x[..., blk:] = rng.integers(-128, 128, (b, h, wd, c - blk))
        w[:, :, blk:] = rng.integers(-127, 128, (k, k, c - blk, n))
        perm = rng.permutation(c)
        shift = (10 + rng.integers(-1, 2, n)).astype(np.int32)
        return x[..., perm], w[:, :, perm], bias, shift
    if case == "wrap8":
        x = np.zeros((b, h, wd, c), np.int64)
        w = np.zeros((k, k, c, n), np.int64)
        x[..., :WRAP8_BLOCK] = np.where(rng.random((b, h, wd, 1)) < 0.6, -32768, 0)
        w[:, :, :WRAP8_BLOCK] = np.where(rng.random((k, k, 1, n)) < 0.6, -128, 0)
        x[..., WRAP8_BLOCK:] = rng.integers(-2000, 2001, (b, h, wd, c - WRAP8_BLOCK))
        w[:, :, WRAP8_BLOCK:] = rng.integers(-127, 128, (k, k, c - WRAP8_BLOCK, n))
        perm = rng.permutation(c)
        shift = (8 + rng.integers(-1, 2, n)).astype(np.int32)
        return (x[..., perm].astype(np.int16), w[:, :, perm].astype(np.int8),
                bias, shift)
    if wrap:   # int16 over its whole range
        x = rng.integers(-32768, 32768, (b, h, wd, c)).astype(np.int16)
        w = rng.integers(-32768, 32768, (k, k, c, n)).astype(np.int16)
        return x, w, bias, 16
    rx, rw = (127, 127) if int8 else (700, 700 if tier == "int16" else 127)
    x = rng.integers(-rx, rx + 1, (b, h, wd, c)).astype(
        np.int8 if int8 else np.int16)
    w = rng.integers(-rw, rw + 1, (k, k, c, n)).astype(
        np.int16 if tier == "int16" else np.int8)
    base = max(0, round(np.log2((k * k * c) ** 0.5 * rx * rw / 3 / target)))
    if tier == "int16":
        return x, w, bias, base
    return x, w, bias, (base + rng.integers(-1, 2, n)).astype(np.int32)


def _emulated(tier: str, x, w, bias, shift, stride: int, pad: int,
              sms: int, leaky: bool, rng) -> torch.Tensor:
    """The kernel's schedule on the CPU: per segment the tile's rows and
    K steps (their columns of the im2col and their 32-k chunks of the
    packed planes) through tc.emulate, the partials of each tile added mod
    2^32 in a shuffled order, then the requant (int8-head16: head16's bias
    and shift, to int16)."""
    scheme, pack, out = TIERS[tier]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    k, n = w.shape[0], w.shape[-1]
    ho, wo = q16.conv_out_hw(x.shape[1], x.shape[2], k, stride, pad)
    a = q16.im2col(xt, k, stride, pad)
    m, kk = a.shape
    planes = pack(wt)
    p = _plan(m, n, kk, sms, scheme)
    assert p.slots > 0   # the case exercises shared tiles
    ntiles = -(-n // p.bn)
    parts: dict[int, list] = {}
    for _, t, k0, k1 in p.segments():
        r0, c0 = t // ntiles * p.bm, t % ntiles * p.bn
        kb, ke = k0 * scheme.bk, min(k1 * scheme.bk, kk)
        part = tc.emulate(a[r0:r0 + p.bm, kb:ke],
                          planes[:, kb // 32:k1 * scheme.bk // 32].contiguous(),
                          ke - kb, n, scheme)[:, c0:c0 + p.bn]
        parts.setdefault(t, []).append(part.to(torch.int64))
    acc = torch.zeros((m, n), dtype=torch.int64)
    for t, ps in parts.items():
        r0, c0 = t // ntiles * p.bm, t % ntiles * p.bn
        for i in rng.permutation(len(ps)):
            blk = acc[r0:r0 + p.bm, c0:c0 + p.bn]
            acc[r0:r0 + p.bm, c0:c0 + p.bn] = (blk + ps[i]) & 0xFFFFFFFF
    acc = convops.wrap32(acc).reshape(x.shape[0], ho, wo, n)
    b, s = torch.from_numpy(bias), (shift if tier == "int16"
                                    else torch.from_numpy(shift))
    if tier == "int8-head16":
        b, s = convops.head16(b, s)
    lo, hi = (-128, 127) if out == torch.int8 else (-32768, 32767)
    return convops.requant32(acc, b, s, leaky, lo, hi).to(out)


@functools.cache
def _jax_conv(tier: str, stride: int, pad: int, act: str, shift=None):
    geometry = dict(stride=stride, pad=pad, activation=act)
    if tier == "int16":
        return jax.jit(functools.partial(jconv.conv_int16, compute="int32",
                                         shift_out=shift, **geometry))
    if tier.startswith("int8"):
        return jax.jit(functools.partial(jconv.conv_int8,
                                         head16=tier == "int8-head16",
                                         **geometry))
    return jax.jit(functools.partial(jconv.conv_w8a16, **geometry))


@pytest.fixture
def stream_k_only(monkeypatch):
    """stream_k plans stream-K, never whole tiles, for the test's length."""
    monkeypatch.setattr(tc, "SK_FIXUP", -10 ** 9)
    tc.stream_k.cache_clear()
    yield
    monkeypatch.undo()
    tc.stream_k.cache_clear()


@pytest.mark.parametrize("case,tier,wrap", [
    *((c, t, False) for c in CASES for t in ("int16", "w8a16")),
    *((c, t, False) for c in CASES8 for t in ("int8", "int8-head16")),
    *((c, "int16", True) for c in CASES), ("wrap8", "w8a16", True),
    ("wrap_s8", "int8", True)])
def test_stream_k_schedule_equals_plain_and_jax(case, tier, wrap,
                                                stream_k_only):
    x, w, bias, shift = _operands(case, tier, wrap)
    stride, pad, sms = _geometry(case)[6:]
    rng = np.random.default_rng(5)
    xt, wt, bt = (torch.from_numpy(v) for v in (x, w, bias))
    exact = q16.conv_sum64(xt, wt, stride, pad)
    wrapped = float((exact.abs() >= 2 ** 31).float().mean())
    assert wrapped > 0.1 if wrap else wrapped == 0
    for leaky, act in ((False, "linear"), (True, "leaky")):
        got = _emulated(tier, x, w, bias, shift, stride, pad, sms, leaky, rng)
        if tier == "int16":
            plain = q16.conv_q16_plain(xt, wt, bt, shift, leaky, stride, pad)
            want = _jax_conv(tier, stride, pad, act, shift)(x, w, bias)
        elif tier == "w8a16":
            s = torch.from_numpy(shift)
            plain = q8.conv_w8a16_plain(xt, wt, bt, s, leaky, stride, pad)
            want = _jax_conv(tier, stride, pad, act)(
                x, w, jconv.prep_weights_w8a16(w), bias, shift_out=shift)
        else:
            b, s = bt, torch.from_numpy(shift)
            if tier == "int8-head16":
                b, s = convops.head16(b, s)
            plain = q8.conv_s8_plain(xt, wt, b, s, leaky, stride, pad,
                                     TIERS[tier][2])
            want = _jax_conv(tier, stride, pad, act)(x, w, bias,
                                                     shift_out=shift)
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        info = torch.iinfo(got.dtype)
        unsat = float(((got > info.min) & (got < info.max)).float().mean())
        assert unsat > 0.5, f"blind case: {unsat:.3f} unsaturated"


@pytest.mark.parametrize("tier", ("int16", "w8a16", "int8"))
def test_card_branch_hands_the_plan_to_the_kernel(tier, monkeypatch):
    """The wrappers' card branch with meta tensors, the launch recorded: the
    C entry point gets its arguments in _build.SIGNATURES's order, ending
    with the tile, the grid and the counters of tc.stream_k's plan."""
    calls = []
    monkeypatch.setattr(q16, "check_operands", lambda *a, **kw: None)
    monkeypatch.setattr(tc, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, out, *args, counts: calls.append(
                            (name, fn, args)) or out)
    x = torch.zeros((8, 26, 26, 512), dtype=torch.int16, device="meta")
    b = torch.zeros(512, dtype=torch.int32, device="meta")
    w8 = torch.zeros((3, 3, 512, 512), dtype=torch.int8, device="meta")
    if tier == "int8":
        out = q8.conv_s8(x.to(torch.int8), w8, b, b, True, 2, 1,
                         planes=q8.pack_s8(w8))
        fn, scheme, dtype = "yq8_conv_s8", tc.S8, torch.int8
    elif tier == "int16":
        w = torch.zeros((3, 3, 512, 512), dtype=torch.int16, device="meta")
        out = q16.conv_q16(x, w, b, 3, True, 2, 1, planes=q16.pack_q16(w))
        fn, scheme, dtype = "yq16_conv", tc.Q16, torch.int16
    else:
        out = q8.conv_w8a16(x, w8, b, b, True, 2, 1, planes=q8.pack_w8a16(w8))
        fn, scheme, dtype = "yq8_conv_w8a16", tc.W8A16, torch.int16
    assert out.shape == (8, 13, 13, 512) and out.dtype == dtype
    (name, got_fn, args), = calls
    assert got_fn == fn and len(args) == len(_build.SIGNATURES[fn]) - 1
    p = _plan(8 * 13 * 13, 512, 9 * 512, SMS, scheme)
    assert args[-5:] == (p.bm, p.bn, p.grid, p.quantum, p.slots)


def test_convk_stamps_instrument_the_kernel():
    """The stamp tool's anchors are all in csrc/convk_tc.cuh, so it can
    time a K step's phases on the card: eleven clock64 stamps, block 0's
    first consumer and first producer thread; its reader goes into the
    source of each kernel it stamps, which runs that kernel's scheme."""
    assert set(convk_stamps.KERNELS) == {"conv_q16", "conv_s8"}
    for kernel, scheme in (("conv_q16", "Q16"), ("conv_s8", "S8")):
        with open(f"{convk_stamps.PKG}/csrc/{convk_stamps.KERNELS[kernel]}") as f:
            assert f"convk::launch<{scheme}>" in f.read()
    path = convk_stamps.PKG + "/csrc/convk_tc.cuh"
    with open(path) as f:
        src = f.read()
    got = convk_stamps.instrument(src)
    assert got.count("clock64()") == src.count("clock64()") + 11
    assert got.count(convk_stamps.CONSUMER) == got.count(convk_stamps.PRODUCER) == 1
    with pytest.raises(ValueError, match="anchor"):
        convk_stamps.instrument(src.replace("tc::wgmma_wait_all();", ""))
