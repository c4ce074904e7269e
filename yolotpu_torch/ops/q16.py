"""The exact-int16 conv kernels: wrappers, plain versions, launch counts.

The counterpart of ``yolotpu/ops/pallas_q16.py``. The kernels compute what
the Pallas kernels compute, the exact int16 x int16 sum modulo 2^32 followed
by the requant chain (``convops.requant32``):

  mm_q16            x (M, K) @ w (K, N)               the 1x1 convs
                    (replaces ``matmul_q16_requant``)
  conv3x3_q16       SAME 3x3/s1 conv, NHWC x HWIO      the 3x3 convs
                    (replaces ``conv3x3_q16_flat`` and its fallback
                    ``conv3x3_q16_requant``)
  conv3x3_pool_q16  the same conv and the darknet 2x2/s2 maxpool after it,
                    the pool's max taken in one of ``POOL_ORDERS``
                    (replaces ``entry_sdmm_forward``, ``entryf_forward``,
                    ``entry8_forward``, and ``conv3x3p2_q16_requant`` /
                    ``conv3x3p2f_q16_requant`` under ``maxpool2x2_p2``)

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches the hand-written kernel (``csrc/``, built by ``_build``) or raises.
``LAUNCHES`` counts kernel launches, and only those.

The plain versions gather the 1 or 9 taps and run one float64 matmul. That
is exact: |x*w| <= 2^30 and K <= 9*1280 keep every partial sum below 2^44,
far inside float64's 53-bit mantissa in any summation order, so rounding to
int64 and wrapping to int32 gives the wraparound int32 sum.

mm_q16 and conv3x3_q16 run on the 8-bit tensor cores (``csrc/igemm_tc.cuh``):
each int16 is cut into a signed high and an unsigned low byte, and the
three s32 partial sums (high x high, the two mixed products, low x low) are
recombined modulo 2^32. On the card they take the weights also as packed
planes (``pack_q16``, once at model build): the high (s8) and low (u8)
bytes, padded to the kernel's tile in K and N and laid out as its B
fragments. ``mm_split_sum`` computes the sums from those planes the way the
kernel does, so the CPU tests hold the layout. conv3x3_pool_q16 reads HWIO
int16 as a (taps*C, N) row-major matrix on the CUDA cores. The bias is the
(N,) int32 pre-shifted bias.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from .convops import requant32, wrap32

LAUNCHES = {"mm_q16": 0, "conv3x3_q16": 0, "conv3x3_pool_q16": 0}

# Where conv3x3_pool_q16 takes the pool's max, by the kernel's order index.
# The three agree while acc + 2^(shift-1) does not wrap:
#   "acc"    the max of the window's four int32 sums, then the requant
#   "acc_h"  the max of each horizontal pair's sums, the requant, then the
#            max of the vertical pair
#   "out"    the requant of each of the four, then the max (conv, then pool)
POOL_ORDERS = ("acc", "acc_h", "out")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def prep_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO (k, k, C, N) -> the kernels' weight operand: (C, N) for a 1x1
    layer, (3, 3, C, N) for a 3x3 one, contiguous, in its own dtype (int16,
    or int8 for the kernels of ``ops.q8``)."""
    w = w_hwio
    if w.shape[:2] == (1, 1):
        w = w.reshape(w.shape[2], w.shape[3])
    return w.contiguous()


# The tensor-core body's tile (csrc/igemm_tc.cuh: BM, BN, BK, KMAX,
# MIN_BLOCKS): the planes are padded to TC_BK in K and TC_BN in N, one s32
# partial sum covers at most TC_KMAX values of k, and TC_RESIDENT blocks
# stay resident on an SM.
TC_BM, TC_BN, TC_BK, TC_KMAX, TC_RESIDENT = 64, 64, 64, 32768, 3
# Fragment position p = 16h + 4t + i of a 32-k chunk (h < 2, lane t < 4,
# byte i < 4) holds k = FRAG_K[p]: ldmatrix gives lane t the int16 pairs
# (2t, 2t+1) and (8+2t, 9+2t), and their high or low bytes make one 8-bit
# A fragment register; the B operand holds its k in the same order.
FRAG_K = tuple(16 * (p // 16) + 2 * (p % 16 // 4) + p % 2 + 8 * (p % 4 // 2)
               for p in range(32))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def planes_shape(k: int, n: int) -> tuple[int, ...]:
    """The packed planes of a (K, N) weight: (Np/64 column tiles, Kp/32
    chunks, 2 planes, 8 column groups g, 2 k halves h, 8 columns r, 16 k
    bytes e)."""
    return (_round_up(n, TC_BN) // 64, _round_up(k, TC_BK) // 32, 2, 8, 2, 8, 16)


def pack_q16(w: torch.Tensor) -> torch.Tensor:
    """int16 weights, (C, N) or HWIO (3, 3, C, N), read as (K, N) -> the
    tensor-core kernels' B operand, uint8 ``planes_shape(K, N)`` on w's
    device: K padded to TC_BK and N to TC_BN with zeros, each value split
    into its high byte (s8, w >> 8) and low byte (u8, w & 255); for each
    64-column tile nb and 32-k chunk kc, the high plane, then the low, in
    the shared-memory layout of the wgmma B descriptor: byte (g, h, r, e)
    holds column 64 nb + 8 g + r at k = 32 kc + FRAG_K[16 h + e]."""
    wk = w.reshape(-1, w.shape[-1])
    k, n = wk.shape
    nb, kc = planes_shape(k, n)[:2]
    wp = torch.zeros((kc * 32, nb * 64), dtype=torch.int16, device=w.device)
    wp[:k, :n] = wk
    order = torch.tensor(FRAG_K, device=w.device)

    def arrange(plane: torch.Tensor) -> torch.Tensor:
        # (kc, h, e, nb, g, r) -> (nb, kc, g, h, r, e)
        p = plane.view(kc, 32, nb * 64)[:, order].view(kc, 2, 16, nb, 8, 8)
        return p.permute(3, 0, 4, 1, 5, 2)

    hi = (wp >> 8).to(torch.int8).view(torch.uint8)
    lo = (wp & 255).to(torch.uint8)
    return torch.stack([arrange(hi), arrange(lo)], dim=2).contiguous()


def unpack_planes(planes: torch.Tensor, k: int, n: int):
    """The high (s8) and low (u8) planes of pack_q16's output as int64 (Kp,
    Np) matrices, rows in fragment order: row 32 kc + p holds k =
    32 kc + FRAG_K[p], as the kernel's A fragments take it."""
    nb, kc = planes_shape(k, n)[:2]

    def plane(j: int, dtype: torch.dtype) -> torch.Tensor:
        q = planes[:, :, j].contiguous().view(dtype).to(torch.int64)
        # (nb, kc, g, h, r, e) -> (kc, h, e, nb, g, r)
        return q.permute(1, 3, 5, 0, 2, 4).reshape(kc * 32, nb * 64)

    return plane(0, torch.int8), plane(1, torch.uint8)


def mm_split_sum(x: torch.Tensor, planes: torch.Tensor, k: int,
                 n: int) -> torch.Tensor:
    """x (M, K) int16 and pack_q16's planes of a (K, N) weight -> the (M, N)
    int32 sums modulo 2^32, computed as the tensor-core kernels compute
    them: x split into its high (s8) and low (u8) bytes, both operands in
    fragment order, three partial sums over at most TC_KMAX values of k
    each (high x high; high x low + low x high; low x low), each required to
    fit s32, recombined as (hh << 16) + (mid << 8) + ll modulo 2^32 and
    summed over the chunks modulo 2^32. For tests: it holds the packing
    layout and the split's exactness on the CPU."""
    wh, wl = unpack_planes(planes, k, n)
    kp = wh.shape[0]
    xp = torch.zeros((x.shape[0], kp), dtype=torch.int64)
    xp[:, :k] = x.to(torch.int64)
    xk = xp.view(-1, kp // 32, 32)[:, :, list(FRAG_K)].reshape(-1, kp)
    xh, xl = xk >> 8, xk & 255
    acc = torch.zeros((x.shape[0], wh.shape[1]), dtype=torch.int64)

    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)
        if s.numel() and int(s.abs().max()) >= 2 ** 31:
            raise OverflowError("a partial sum leaves s32")
        return s

    for c0 in range(0, kp, TC_KMAX):
        c = slice(c0, c0 + TC_KMAX)
        hh = dot(xh[:, c], wh[c])
        mid = dot(xh[:, c], wl[c]) + dot(xl[:, c], wh[c])
        if mid.numel() and int(mid.abs().max()) >= 2 ** 31:
            raise OverflowError("the middle partial sum leaves s32")
        acc = (acc + (hh << 16) + (mid << 8) + dot(xl[:, c], wl[c])) & 0xFFFFFFFF
    return wrap32(acc[:, :n])


# What splitting K adds to a block's time, in K steps (TC_BK each): the
# workspace's memset, the atomic adds and the last block's pass over its
# tile. Set from chip_smoke.py's split sweep (every split of K at every
# yolov2 416 shape at batch 1 and 8, NVIDIA H100 80GB HBM3): any value from
# 15 to 26 picks, at each shape, a split at most 6% slower than the fastest
# one measured there, and 20 is the middle of that range.
TC_SPLIT_COST = 20


@functools.lru_cache(maxsize=4096)
def tc_split(m: int, n: int, k: int, sms: int) -> int:
    """The K steps (of TC_BK) per split for an (M, K) @ (K, N) on the
    tensor-core body with ``sms`` SMs: of the split counts from
    ceil(K / TC_KMAX) up, the one whose waves of resident blocks times a
    block's time is least, a block's time being its K steps, plus
    TC_SPLIT_COST where K is split; the fewest splits on a tie."""
    tiles = -(-m // TC_BM) * -(-n // TC_BN)
    ktiles = -(-k // TC_BK)
    best, best_cost = None, None
    for s in range(-(-k // TC_KMAX), ktiles + 1):
        kps = -(-ktiles // s)
        splits = -(-ktiles // kps)
        waves = -(-tiles * splits // (sms * TC_RESIDENT))
        cost = waves * (kps + (TC_SPLIT_COST if splits > 1 else 0))
        if best_cost is None or cost < best_cost:
            best, best_cost = kps, cost
    return best


def acc32(accf: torch.Tensor) -> torch.Tensor:
    """Exact float64 sums -> int32 modulo 2^32."""
    return wrap32(torch.round(accf).to(torch.int64))


def mm_sum64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact (M, N) sums of mm_q16, before the wrap, in float64."""
    return x.to(torch.float64) @ w.to(torch.float64)


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the (B*H*W, 9C) SAME 3x3 im2col matrix, tap-major
    (the HWIO weight order), zeros in the padding, in x's dtype."""
    b, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))   # SAME: zeros
    return torch.cat([xp[:, dy:dy + h, dx:dx + wd]
                      for dy in range(3) for dx in range(3)],
                     dim=-1).reshape(-1, 9 * c)


def conv3x3_sum64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact (B, H, W, N) sums of conv3x3_q16, before the wrap, in
    float64."""
    b, h, wd, c = x.shape
    n = w.shape[-1]
    acc = (im2col3x3(x.to(torch.float64))
           @ w.reshape(9 * c, n).to(torch.float64))
    return acc.reshape(b, h, wd, n)


def mm_q16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 shift: int, leaky: bool, planes=None) -> torch.Tensor:
    """mm_q16 in float64; ``planes`` is taken, as the kernel takes it, and
    not read: the plain version reads w."""
    acc = acc32(mm_sum64(x, w))
    return requant32(acc, bias, shift, leaky).to(torch.int16)


def conv3x3_q16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      shift: int, leaky: bool, planes=None) -> torch.Tensor:
    """conv3x3_q16 in float64; ``planes`` is taken and not read, as in
    mm_q16_plain."""
    acc = acc32(conv3x3_sum64(x, w))
    return requant32(acc, bias, shift, leaky).to(torch.int16)


def conv3x3_pool_q16_plain(x: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor, shift: int, leaky: bool,
                           order: str) -> torch.Tensor:
    """conv3x3_q16_plain's sums, then the 2x2/s2 pool in ``order``; every
    max is a signed int32 (or int16) max of the wrapped values, as
    ``jnp.maximum`` takes it."""
    acc = acc32(conv3x3_sum64(x, w))
    b, h, wd, n = acc.shape
    # (b, ho, dy, wo, dx, n): the pool window's members on axes 2 and 4
    win = acc.reshape(b, h // 2, 2, wd // 2, 2, n)
    if order == "acc":
        v = requant32(win.amax(dim=(2, 4)), bias, shift, leaky)
    elif order == "acc_h":
        v = requant32(win.amax(dim=4), bias, shift, leaky).amax(dim=2)
    elif order == "out":
        v = requant32(win, bias, shift, leaky).amax(dim=(2, 4))
    else:
        raise ValueError(f"conv3x3_pool_q16: order {order!r} (one of "
                         f"{', '.join(POOL_ORDERS)})")
    return v.to(torch.int16)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           x_ndim: int, w_shape_ok: bool, x_dtype: torch.dtype = torch.int16,
           w_dtype: torch.dtype = torch.int16) -> None:
    if x.dtype != x_dtype or w.dtype != w_dtype or bias.dtype != torch.int32:
        raise TypeError(f"{name}: want {x_dtype} x, {w_dtype} w, int32 bias; "
                        f"got {x.dtype}, {w.dtype}, {bias.dtype}")
    if x.ndim != x_ndim or not w_shape_ok or bias.shape != (w.shape[-1],):
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"bias{tuple(bias.shape)} do not fit")
    if not (x.device == w.device == bias.device):
        raise ValueError(f"{name}: operands on {x.device}, {w.device}, "
                         f"{bias.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for device "
                         f"{x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous() and w.is_contiguous()
                                        and bias.is_contiguous()):
        raise ValueError(f"{name}: the kernel needs contiguous operands")


def _launch(name: str, fn: str, out: torch.Tensor, *args,
            counts: dict = LAUNCHES) -> torch.Tensor:
    """Call C entry point ``fn`` on the current stream, raise on a CUDA
    error, and count one launch of ``name`` in ``counts``."""
    lib = _build.load_library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(lib.cdll, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    counts[name] += 1
    return out


def _rows_fit(name: str, m: int) -> None:
    if m >= 1 << 31:
        raise ValueError(f"{name}: M={m} does not fit the kernel's int")


def _check_planes(name: str, planes, k: int, n: int,
                  device: torch.device) -> None:
    if planes is None:
        raise TypeError(f"{name}: on the card the kernel takes the weights "
                        "also as packed planes (planes=pack_q16(w), made once "
                        "at model build)")
    want = planes_shape(k, n)
    if (planes.dtype != torch.uint8 or tuple(planes.shape) != want
            or planes.device != device or not planes.is_contiguous()):
        raise ValueError(f"{name}: planes {planes.dtype} "
                         f"{tuple(planes.shape)} on {planes.device}; want "
                         f"contiguous uint8 {want} on {device}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tc_launch(name: str, fn: str, out: torch.Tensor, m: int, n: int, k: int,
               operands: tuple, shape: tuple, shift: int,
               leaky: bool) -> torch.Tensor:
    """Launch a tensor-core kernel with its split of K and, where it splits,
    the workspace the kernel zeroes (M*N sums and one counter per output
    tile)."""
    kps = tc_split(m, n, k, _sm_count(out.device.index or 0))
    ws = None
    if -(-k // TC_BK) > kps:   # split: M*N sums and a counter per tile
        ws = torch.empty(m * n + -(-m // TC_BM) * -(-n // TC_BN),
                         dtype=torch.int32, device=out.device)
    return _launch(name, fn, out, *operands, out.data_ptr(),
                   None if ws is None else ws.data_ptr(), *shape, int(shift),
                   int(leaky), kps)


def mm_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, shift: int,
           leaky: bool, planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) int16 @ w (K, N) int16, fused requant -> (M, N) int16. On
    the card ``planes`` (pack_q16(w)) is the kernel's weight operand."""
    _check("mm_q16", x, w, bias, 2, w.ndim == 2 and w.shape[0] == x.shape[-1])
    if x.device.type == "cpu":
        return mm_q16_plain(x, w, bias, shift, leaky)
    (m, k), n = x.shape, w.shape[1]
    _rows_fit("mm_q16", m)
    _check_planes("mm_q16", planes, k, n, x.device)
    out = torch.empty((m, n), dtype=torch.int16, device=x.device)
    return _tc_launch("mm_q16", "yq16_mm", out, m, n, k,
                      (x.data_ptr(), planes.data_ptr(), bias.data_ptr()),
                      (m, k, n), shift, leaky)


def conv3x3_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                shift: int, leaky: bool,
                planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int16, w (3, 3, C, N) int16 -> SAME 3x3/s1 conv with
    fused requant, (B, H, W, N) int16. On the card ``planes``
    (pack_q16(w)) is the kernel's weight operand."""
    _check("conv3x3_q16", x, w, bias, 4,
           w.ndim == 4 and w.shape[:3] == (3, 3, x.shape[-1]))
    if x.device.type == "cpu":
        return conv3x3_q16_plain(x, w, bias, shift, leaky)
    b, h, wd, c = x.shape
    n = w.shape[-1]
    _rows_fit("conv3x3_q16", b * h * wd)
    _check_planes("conv3x3_q16", planes, 9 * c, n, x.device)
    out = torch.empty((b, h, wd, n), dtype=torch.int16, device=x.device)
    return _tc_launch("conv3x3_q16", "yq16_conv3x3", out, b * h * wd, n, 9 * c,
                      (x.data_ptr(), planes.data_ptr(), bias.data_ptr()),
                      (b, h, wd, c, n), shift, leaky)


def conv3x3_pool_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     shift: int, leaky: bool, order: str) -> torch.Tensor:
    """x (B, H, W, C) int16 with H and W even, w (3, 3, C, N) int16 -> SAME
    3x3/s1 conv with fused requant and the darknet 2x2/s2 maxpool after it,
    the max taken in ``order`` (one of POOL_ORDERS): (B, H/2, W/2, N)
    int16."""
    _check("conv3x3_pool_q16", x, w, bias, 4,
           w.ndim == 4 and w.shape[:3] == (3, 3, x.shape[-1]))
    b, h, wd, c = x.shape
    if h % 2 or wd % 2 or order not in POOL_ORDERS:
        raise ValueError(f"conv3x3_pool_q16: want even H and W and an order "
                         f"in {POOL_ORDERS}; got {h}x{wd}, {order!r}")
    if x.device.type == "cpu":
        return conv3x3_pool_q16_plain(x, w, bias, shift, leaky, order)
    n = w.shape[-1]
    out = torch.empty((b, h // 2, wd // 2, n), dtype=torch.int16,
                      device=x.device)
    return _launch("conv3x3_pool_q16", "yq16_conv3x3_pool", out, x.data_ptr(),
                   w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                   b, h, wd, c, n, int(shift), int(leaky),
                   POOL_ORDERS.index(order))
