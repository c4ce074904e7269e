"""The tensor-core body shared by the int16 and 8-bit tiers: its operand
schemes, weight-plane layout, split of K and launch.

The Python side of ``csrc/igemm_tc.cuh``, whose one templated body runs
``q16.mm_q16`` and ``q16.conv3x3_q16`` (scheme ``Q16``), ``q8.mm_w8a16`` and
``q8.conv3x3_w8a16`` (``W8A16``), and ``q8.mm_s8``, ``q8.conv3x3_s8`` and
``q8.conv3x3_int8`` (``S8``) on the 8-bit tensor cores. Each scheme cuts its
operands into 8-bit pieces, sums the products of each shift into an s32 set
over at most ``KMAX`` values of k, and recombines the sets modulo 2^32:

  Q16    int16 A, the weight's s8 high and u8 low planes: three sets
         (<< 16, << 8, << 0)
  W8A16  int16 A against one s8 plane: two sets (<< 8, << 0)
  S8     int8 A against one s8 plane: one set

The wrappers take the weights as planes packed once, at model build
(``q16.pack_q16``, ``q8.pack_s8``, ``q8.pack_w8a16``: one packer per scheme,
for a 1x1 and a 3x3 weight alike, all through ``arrange_planes``).
``emulate`` computes a scheme's sums from those planes the way the kernel
does, so the CPU tests hold the layout and each scheme's exactness. Where
the output tiles cannot fill the card, ``split`` cuts K over blocks, and
``launch`` allocates the workspace the kernel zeroes.

The general convs (``q16.conv_q16``, scheme Q16; ``q8.conv_w8a16``, W8A16;
``q8.conv_s8``, S8) run on a kernel of their own, ``csrc/convk_tc.cuh``, on
the same schemes and planes: a persistent grid walks every (output tile, K
step) unit of the conv in shares that ``stream_k`` plans, on a tile that
``convk_tile`` chooses from the shape, and ``launch_convk`` allocates the
workspace of the tiles that several blocks share.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _build
from .convops import wrap32

# The body's output tile (BM x BN), the k of one s32 partial sum (KMAX),
# as csrc/igemm_tc.cuh fixes them.
BM, BN, KMAX = 64, 64, 32768

# What splitting K adds to a block's time, in K steps: the workspace's
# memset, the atomic adds and the last block's pass over its tile. Set from
# chip_smoke.py's split sweep (every split of K at every yolov2 416 shape
# at batch 1 and 8, NVIDIA H100 80GB HBM3): for Q16 any value from 15 to 26
# picks, at each shape, a split at most 6% slower than the fastest one
# measured there, and 20 is the middle of that range; the sweep of W8A16
# and S8 found no shape where it picks a split more than 10% slower. Their
# 1x1 convs (1 to 16 K steps, fewer than the cost) stay unsplit, which the
# sweep found fastest at every shape, the 13x13 ones at batch 1 included.
SPLIT_COST = 20


@dataclass(frozen=True, eq=False)   # one object per scheme: hashed by identity
class Scheme:
    """One operand scheme of the tensor-core body, as its C struct in
    ``csrc/igemm_tc.cuh`` fixes it: ``id`` (its number in
    ``yq_tc_config``), the bytes of one A value and the weight planes; then
    ``wave``, the blocks per SM whose K steps ``split`` counts in one wave,
    set from chip_smoke.py's split sweep (at most the struct's MIN_BLOCKS,
    which chip_smoke.py checks on the card); and the name of the function
    that packs its planes. A K step is 128 bytes of A per row, ``bk``
    values of k; the planes hold their k in fragment order (FRAG_K) where A
    is int16 and in natural order where it is int8."""
    name: str
    id: int
    a_bytes: int
    planes: int
    wave: int
    pack: str

    @property
    def bk(self) -> int:
        return 128 // self.a_bytes

    @property
    def frag(self) -> bool:
        return self.a_bytes == 2

    def planes_shape(self, k: int, n: int) -> tuple[int, ...]:
        """The packed planes of a (K, N) weight: (Np/64 column tiles, Kp/32
        chunks, planes, 8 column groups g, 2 k halves h, 8 columns r, 16 k
        bytes e), K padded to ``bk`` and N to BN."""
        return (_round_up(n, BN) // 64, _round_up(k, self.bk) // 32,
                self.planes, 8, 2, 8, 16)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


Q16 = Scheme("q16", 0, a_bytes=2, planes=2, wave=3, pack="pack_q16")
W8A16 = Scheme("w8a16", 1, a_bytes=2, planes=1, wave=3, pack="pack_w8a16")
# S8's waves count two blocks per SM, though four stay on one: the split
# sweep found the 13x13 convs at batch 1 fastest at 4-5 splits, where more
# blocks than two per SM gave no shorter wave, and with three or four per
# SM in its waves split chose 8-11 splits, up to 1.28x slower (NVIDIA H100
# 80GB HBM3).
S8 = Scheme("s8", 2, a_bytes=1, planes=1, wave=2, pack="pack_s8")

# Fragment position p = 16h + 4t + i of a 32-k chunk (h < 2, lane t < 4,
# byte i < 4) holds k = FRAG_K[p]: ldmatrix gives lane t the int16 pairs
# (2t, 2t+1) and (8+2t, 9+2t), and their high or low bytes make one 8-bit
# A fragment register; the B operand holds its k in the same order.
FRAG_K = tuple(16 * (p // 16) + 2 * (p % 16 // 4) + p % 2 + 8 * (p % 4 // 2)
               for p in range(32))


def arrange_planes(byte_planes: list[torch.Tensor],
                   scheme: Scheme) -> torch.Tensor:
    """Byte planes of a (K, N) weight, uint8 (K, N) each, -> the tensor-core
    kernels' B operand, uint8 ``scheme.planes_shape(K, N)`` on their device:
    K padded to ``scheme.bk`` and N to BN with zeros; for each
    64-column tile nb and 32-k chunk kc the planes in turn, each in the
    shared-memory layout of the wgmma B descriptor: byte (g, h, r, e) of
    plane j holds plane j's byte of column 64 nb + 8 g + r at
    k = 32 kc + order[16 h + e], order FRAG_K or (for int8 A) 0 .. 31."""
    k, n = byte_planes[0].shape
    nb, kc = scheme.planes_shape(k, n)[:2]
    dev = byte_planes[0].device
    order = torch.tensor(FRAG_K if scheme.frag else range(32), device=dev)

    def arrange(plane: torch.Tensor) -> torch.Tensor:
        wp = torch.zeros((kc * 32, nb * 64), dtype=torch.uint8, device=dev)
        wp[:k, :n] = plane
        # (kc, h, e, nb, g, r) -> (nb, kc, g, h, r, e)
        p = wp.view(kc, 32, nb * 64)[:, order].view(kc, 2, 16, nb, 8, 8)
        return p.permute(3, 0, 4, 1, 5, 2)

    return torch.stack([arrange(p) for p in byte_planes], dim=2).contiguous()


def plane_matrix(planes: torch.Tensor, j: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Plane j of packed planes, its bytes read as ``dtype`` (torch.int8 or
    torch.uint8), as an int64 (Kp, Np) matrix in the planes' k order: row
    32 kc + p holds k = 32 kc + order[p], as the kernel's A fragments take
    it."""
    nb, kc = planes.shape[:2]
    q = planes[:, :, j].contiguous().view(dtype).to(torch.int64)
    # (nb, kc, g, h, r, e) -> (kc, h, e, nb, g, r)
    return q.permute(1, 3, 5, 0, 2, 4).reshape(kc * 32, nb * 64)


def emulate(x: torch.Tensor, planes: torch.Tensor, k: int, n: int,
            scheme: Scheme) -> torch.Tensor:
    """x (M, K) (int16 A, or int8 for S8) and ``scheme``'s packed planes of
    a (K, N) weight -> the (M, N) int32 sums modulo 2^32, computed as the
    tensor-core kernel of that scheme computes them: x in the planes' k
    order, split into its high (s8, << 8) and low (u8) bytes where it is
    int16, the weight's high (s8, << 8) and low (u8) planes for Q16 or its
    one s8 plane; the products of equal shift summed into one s32 set (Q16:
    << 16, << 8, << 0; W8A16: << 8, << 0; S8: one) over at most KMAX
    values of k, each set required to fit s32 (OverflowError otherwise),
    recombined modulo 2^32 and summed over the chunks modulo 2^32. For
    tests: it holds the packing layout and each scheme's exactness on the
    CPU."""
    ws = ([(plane_matrix(planes, 0, torch.int8), 8),
           (plane_matrix(planes, 1, torch.uint8), 0)] if scheme.planes == 2
          else [(plane_matrix(planes, 0, torch.int8), 0)])
    kp = ws[0][0].shape[0]
    xk = torch.zeros((x.shape[0], kp), dtype=torch.int64)
    xk[:, :k] = x.to(torch.int64)
    if scheme.frag:
        xk = xk.view(-1, kp // 32, 32)[:, :, list(FRAG_K)].reshape(-1, kp)
    xs = [(xk >> 8, 8), (xk & 255, 0)] if scheme.a_bytes == 2 else [(xk, 0)]
    acc = torch.zeros((x.shape[0], ws[0][0].shape[1]), dtype=torch.int64)

    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)

    for c0 in range(0, kp, KMAX):
        c = slice(c0, c0 + KMAX)
        sets: dict[int, torch.Tensor] = {}
        for a, sa in xs:
            for b, sb in ws:
                sets[sa + sb] = sets.get(sa + sb, 0) + dot(a[:, c], b[c])
        for sh, s in sets.items():
            if s.numel() and int(s.abs().max()) >= 2 ** 31:
                raise OverflowError(f"the partial sum << {sh} leaves s32")
            acc = (acc + (s << sh)) & 0xFFFFFFFF
    return wrap32(acc[:, :n])


@functools.lru_cache(maxsize=4096)
def split(m: int, n: int, k: int, sms: int, scheme: Scheme) -> int:
    """The K steps (of ``scheme.bk``) per split for an (M, K) @ (K, N) on the
    tensor-core body with ``sms`` SMs: of the split counts from
    ceil(K / KMAX) up, the one whose waves (of ``scheme.wave`` blocks per
    SM) times a block's time is least, a block's time being its K steps,
    plus SPLIT_COST where K is split; the fewest splits on a tie."""
    tiles = -(-m // BM) * -(-n // BN)
    ktiles = -(-k // scheme.bk)
    best, best_cost = None, None
    for s in range(-(-k // KMAX), ktiles + 1):
        kps = -(-ktiles // s)
        splits = -(-ktiles // kps)
        waves = -(-tiles * splits // (sms * scheme.wave))
        cost = waves * (kps + (SPLIT_COST if splits > 1 else 0))
        if best_cost is None or cost < best_cost:
            best, best_cost = kps, cost
    return best


# The general convs' tiles (BM, BN), as csrc/convk_tc.cuh builds them, and
# per scheme and tile the blocks per SM that stream_k fills, the kernel's
# MIN_BLOCKS (chip_smoke.py checks that the card keeps them): a block is one
# producer warpgroup and BM / 64 consumer warpgroups; three blocks of one
# consumer where its accumulators take at most 64 registers (S8, W8A16,
# and Q16 at 32 columns), else two, or one of two consumers, fill an SM's
# registers.
CONVK_TILES = ((64, 64), (64, 32), (128, 64), (128, 32))
CONVK_BLOCKS = {(s, bm, bn): 1 if bm == 128 else
                3 if (s != "q16" or bn == 32) else 2
                for s in ("q16", "w8a16", "s8") for bm, bn in CONVK_TILES}
# K steps of 64 x 64 tiles per block of the card from which a Q16 conv takes
# 128-row tiles (convk_tile).
CONVK_WIDE = 16
# The fewest K steps a block's share holds: fewer blocks where the conv has
# less work than that per block, so that a small conv does not pay a shared
# tile's partials for every few K steps.
SK_MIN_STEPS = 8
# What sharing tiles adds to a block's time, in K steps (the partials, the
# counters and their zeroing, the completing block's reads): stream_k
# deals whole tiles instead where that is no slower by this count.
SK_FIXUP = 40


def convk_tile(m: int, n: int, k: int, sms: int,
               scheme: Scheme) -> tuple[int, int]:
    """The (BM, BN) output tile of the general conv kernel for an (M, K) @
    (K, N) of ``scheme`` on ``sms`` SMs: 32 columns where N <= 32, so no
    tensor-core work or B byte goes to columns past N; 64 otherwise. 64
    rows, or 128 (two consumer warpgroups sharing each B stage) for a Q16
    conv of 64-wide columns with at least CONVK_WIDE K steps of 64 x 64
    tiles for each block the card keeps of them, where chip_smoke.py's
    sweep found 128 rows faster (NVIDIA H100 80GB HBM3)."""
    if n <= 32:
        return 64, 32
    units = -(-m // 64) * -(-n // 64) * -(-k // scheme.bk)
    wide = units >= CONVK_WIDE * sms * CONVK_BLOCKS[(scheme.name, 64, 64)]
    return (128 if scheme is Q16 and wide else 64), 64


@dataclass(frozen=True)
class StreamK:
    """A schedule of the general conv kernel: the ``tiles`` output tiles of
    ``bm`` x ``bn`` (tile t = m-tile t // (N / bn), n-tile t % (N / bn)),
    each of ``ktiles`` K steps, are the units t * ktiles + kt, and block b
    of the ``grid`` takes units [start(b), start(b + 1)), an even share of
    whole ``quantum``s: single units (stream-K, quantum 1) or whole tiles
    (quantum ktiles). A block's run of K steps within one tile, cut again at
    every ``kchunk`` steps (KMAX values of k, one s32 set), is a segment; a
    tile that is not one segment is shared and sums its segments in the
    workspace."""
    bm: int
    bn: int
    ktiles: int
    tiles: int
    grid: int
    kchunk: int
    quantum: int = 1

    @property
    def units(self) -> int:
        return self.tiles * self.ktiles

    def start(self, b: int) -> int:
        return b * (self.units // self.quantum) // self.grid * self.quantum

    def owner(self, u: int) -> int:
        """The block whose share holds unit u (stream-K)."""
        return ((u + 1) * self.grid - 1) // self.units

    def segments(self) -> list[tuple[int, int, int, int]]:
        """Every segment (block, tile, first K step, end K step), in unit
        order, as the kernel walks them."""
        out = []
        for b in range(self.grid):
            u, end = self.start(b), self.start(b + 1)
            while u < end:
                t, kt = divmod(u, self.ktiles)
                kend = min(self.ktiles, (kt // self.kchunk + 1) * self.kchunk,
                           kt + end - u)
                out.append((b, t, kt, kend))
                u += kend - kt
        return out

    @property
    def chunked(self) -> bool:
        """K past KMAX: every tile sums its segments in a slot of its own."""
        return self.ktiles > self.kchunk

    @functools.cached_property
    def slots(self) -> int:
        """The counters of shared tiles: one per tile past KMAX; else, where
        some tile is shared, one per block (a shared tile's counter is the
        block that owns its first unit, which ends its share inside it);
        else none."""
        if self.chunked:
            return self.tiles
        return self.grid if self.quantum == 1 and any(
            self.start(b) % self.ktiles for b in range(1, self.grid)) else 0

    def slot(self, tile: int) -> int:
        return tile if self.chunked else self.owner(tile * self.ktiles)

    def region(self, block: int, tile: int) -> int:
        """Where block ``block`` leaves its partial of shared tile ``tile``
        (not past KMAX): region 2b for the block's first segment, 2b + 1 for
        its last, as the kernel writes it."""
        return 2 * block + (0 if self.start(block) >= tile * self.ktiles else 1)

    def regions(self, tile: int) -> list[int]:
        """The regions that the segment completing shared tile ``tile``
        reads, as the kernel finds them: block b0 = owner of the tile's
        first unit left its last segment (its first where its share starts
        with the tile), every later block of the tile its first."""
        first = tile * self.ktiles
        b0, b1 = self.owner(first), self.owner(first + self.ktiles - 1)
        return [2 * b + (1 if b == b0 and self.start(b0) != first else 0)
                for b in range(b0, b1 + 1)]

    @property
    def workspace_words(self) -> int:
        """uint32 of the workspace: past KMAX a bm x bn partial tile and a
        counter per tile (all zeroed by the kernel's launch); else, where a
        tile is shared, two bm x bn regions a block, then a counter a block
        (the counters zeroed)."""
        if self.chunked:
            return self.slots * (self.bm * self.bn + 1)
        return self.slots and 2 * self.grid * self.bm * self.bn + self.slots


@functools.lru_cache(maxsize=4096)
def stream_k(m: int, n: int, k: int, sms: int, scheme: Scheme,
             tile: tuple[int, int]) -> StreamK:
    """The schedule of an (M, K) @ (K, N) of ``scheme`` on the general conv
    kernel's ``tile`` with ``sms`` SMs, at most as many blocks as stay on
    the card at once (sms x CONVK_BLOCKS): whole tiles a block where the
    most tiles a block takes cost no more K steps than stream-K's share and
    SK_FIXUP; else stream-K, each block an even, contiguous share of the
    units (shares differ by at most one), of no fewer than SK_MIN_STEPS."""
    bm, bn = tile
    ktiles = -(-k // scheme.bk)
    tiles = -(-m // bm) * -(-n // bn)
    cap = sms * CONVK_BLOCKS[(scheme.name, bm, bn)]
    grid = max(1, min(cap, tiles * ktiles // SK_MIN_STEPS))
    whole = min(cap, tiles)
    if -(-tiles // whole) * ktiles <= -(-tiles * ktiles // grid) + SK_FIXUP:
        return StreamK(bm, bn, ktiles, tiles, whole, KMAX // scheme.bk, ktiles)
    return StreamK(bm, bn, ktiles, tiles, grid, KMAX // scheme.bk)


@functools.lru_cache(maxsize=4096)
def _planes_shape(scheme: Scheme, k: int, n: int) -> tuple[int, ...]:
    return scheme.planes_shape(k, n)


def check_planes(name: str, planes, k: int, n: int, device: torch.device,
                 scheme: Scheme) -> None:
    """Raise unless ``planes`` are ``scheme``'s packed planes of a (K, N)
    weight, contiguous on ``device``."""
    if planes is None:
        raise TypeError(f"{name}: on the card the kernel takes the weights "
                        f"also as packed planes (planes={scheme.pack}(w), "
                        "made once at model build)")
    want = _planes_shape(scheme, k, n)   # the wrappers' host time counts
    if (planes.dtype != torch.uint8 or tuple(planes.shape) != want
            or planes.device != device or not planes.is_contiguous()):
        raise ValueError(f"{name}: planes {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}; want "
                         f"contiguous uint8 {want} on {device}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(name: str, fn: str, out: torch.Tensor, m: int, n: int, k: int,
           pointers: tuple, ints: tuple, scheme: Scheme,
           counts: dict) -> torch.Tensor:
    """Launch a tensor-core kernel of ``scheme`` (``_build.launch``): C entry
    point ``fn`` takes ``pointers``, the output, the workspace, ``ints``,
    the K steps per split and the stream. Where ``split`` splits K, the
    workspace the kernel zeroes (M*N sums and one counter per output tile)
    is allocated here."""
    kps = split(m, n, k, _sm_count(out.device.index or 0), scheme)
    ws = None
    if -(-k // scheme.bk) > kps:
        ws = torch.empty(m * n + -(-m // BM) * -(-n // BN),
                         dtype=torch.int32, device=out.device)
    return _build.launch(name, fn, out, *pointers, out.data_ptr(),
                         None if ws is None else ws.data_ptr(), *ints, kps,
                         counts=counts)


def launch_convk(name: str, fn: str, out: torch.Tensor, m: int, n: int,
                 k: int, pointers: tuple, ints: tuple, scheme: Scheme,
                 counts: dict) -> torch.Tensor:
    """Launch the general conv kernel of ``scheme`` (``_build.launch``): C
    entry point ``fn`` takes ``pointers``, the output, the workspace,
    ``ints``, then the tile (BM, BN), the grid, the share quantum and the
    workspace slots of the schedule ``stream_k`` plans on ``convk_tile``.
    Where a tile is shared, the workspace is allocated here."""
    sms = _sm_count(out.device.index or 0)
    plan = stream_k(m, n, k, sms, scheme, convk_tile(m, n, k, sms, scheme))
    words = plan.workspace_words
    ws = (torch.empty(words, dtype=torch.int32, device=out.device) if words
          else None)
    return _build.launch(name, fn, out, *pointers, out.data_ptr(),
                         None if ws is None else ws.data_ptr(), *ints,
                         plan.bm, plan.bn, plan.grid, plan.quantum,
                         plan.slots, counts=counts)
