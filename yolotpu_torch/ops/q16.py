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
  conv_q16          any k x k conv, any stride and zero padding: the convs
                    that are not a regular 1x1 or 3x3/s1 (replaces no Pallas
                    kernel: XLA's ``conv_general_dilated`` in
                    ``convops.conv_int16`` and ``conv_int16_dec8``)

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches the hand-written kernel (``csrc/``, built by ``_build``) or raises.
``LAUNCHES`` counts kernel launches, and only those.

The plain versions gather the taps (1, 9, or k*k at any stride: ``im2col``)
and run one float64 matmul. That is exact: |x*w| <= 2^30 and K <= 49*1280
keep every partial sum below 2^46, inside float64's 53-bit mantissa in any
summation order, so rounding to int64 and wrapping to int32 gives the
wraparound int32 sum.

All four run on the 8-bit tensor cores (``csrc/igemm_tc.cuh``; conv_q16 on
the general convs' own kernel, ``csrc/convk_tc.cuh``, with a schedule that
``tc.stream_k`` plans): each int16
is cut into a signed high and an unsigned low byte, and the three s32
partial sums (high x high, the two mixed products, low x low) are
recombined modulo 2^32 (``ops.tc``, scheme ``tc.Q16``). On the card they
take the weights also as packed planes (``pack_q16``, once at model build):
the high (s8) and low (u8) bytes, padded to the kernel's tile in K and N
and laid out as its B fragments. ``tc.emulate`` computes the sums from
those planes the way the kernel does, so the CPU tests hold the layout.
conv3x3_pool_q16 is conv3x3_q16's implicit GEMM with its rows, the output
pixels, visited window-major (``window_major``): rows 4i .. 4i+3 are the
four members of pool window i, and the kernel's epilogue pools them into
one output row. conv_q16's implicit GEMM has a row per output pixel of any
window size, stride and padding, and K = k*k*C in the same tap-major
order, so pack_q16 serves its (k, k, C, N) weight as it serves a 3x3 one.
The bias is the (N,) int32 pre-shifted bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, tc
from .convops import requant32, wrap32

LAUNCHES = {"mm_q16": 0, "conv3x3_q16": 0, "conv3x3_pool_q16": 0,
            "conv_q16": 0}

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


def pack_q16(w: torch.Tensor) -> torch.Tensor:
    """int16 weights, (C, N) or HWIO (k, k, C, N), read as (K, N) -> the
    Q16 kernels' B operand (``tc.arrange_planes``, uint8
    ``tc.Q16.planes_shape(K, N)`` on w's device): each value split into its high byte (s8, w >> 8),
    plane 0, and its low byte (u8, w & 255), plane 1, in FRAG_K order."""
    wk = w.reshape(-1, w.shape[-1])
    hi = (wk >> 8).to(torch.int8).view(torch.uint8)
    lo = (wk & 255).to(torch.uint8)
    return tc.arrange_planes([hi, lo], tc.Q16)


def acc32(accf: torch.Tensor) -> torch.Tensor:
    """Exact float64 sums -> int32 modulo 2^32."""
    return wrap32(torch.round(accf).to(torch.int64))


def mm_sum64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact (M, N) sums of mm_q16, before the wrap, in float64."""
    return x.to(torch.float64) @ w.to(torch.float64)


def conv_out_hw(h: int, wd: int, size: int, stride: int,
                pad: int) -> tuple[int, int]:
    """The (Ho, Wo) of a size x size conv with ``stride`` over (h, wd) with
    ``pad`` pixels of zeros on each side: (in + 2 pad - size) // stride + 1,
    darknet's."""
    return ((h + 2 * pad - size) // stride + 1,
            (wd + 2 * pad - size) // stride + 1)


def im2col(x: torch.Tensor, size: int, stride: int, pad: int) -> torch.Tensor:
    """(B, H, W, C) -> the (B*Ho*Wo, size*size*C) im2col matrix of a
    size x size conv with ``stride`` and ``pad`` pixels of zeros on each
    side, tap-major (the HWIO weight order), in x's dtype."""
    b, h, wd, c = x.shape
    ho, wo = conv_out_hw(h, wd, size, stride, pad)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    rows, cols = stride * (ho - 1) + 1, stride * (wo - 1) + 1
    return torch.cat([xp[:, dy:dy + rows:stride, dx:dx + cols:stride]
                      for dy in range(size) for dx in range(size)],
                     dim=-1).reshape(-1, size * size * c)


def conv_sum64(x: torch.Tensor, w: torch.Tensor, stride: int,
               pad: int) -> torch.Tensor:
    """The exact (B, Ho, Wo, N) sums of conv_q16 (w (k, k, C, N)), before
    the wrap, in float64."""
    k, n = w.shape[0], w.shape[-1]
    ho, wo = conv_out_hw(x.shape[1], x.shape[2], k, stride, pad)
    acc = (im2col(x.to(torch.float64), k, stride, pad)
           @ w.reshape(-1, n).to(torch.float64))
    return acc.reshape(x.shape[0], ho, wo, n)


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the (B*H*W, 9C) SAME 3x3 im2col matrix, tap-major
    (the HWIO weight order), zeros in the padding, in x's dtype."""
    return im2col(x, 3, 1, 1)


def conv3x3_sum64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact (B, H, W, N) sums of conv3x3_q16, before the wrap, in
    float64."""
    return conv_sum64(x, w, 1, 1)


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


def conv_q16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   shift: int, leaky: bool, stride: int, pad: int,
                   planes=None) -> torch.Tensor:
    """conv_q16 in float64; ``planes`` is taken and not read, as in
    mm_q16_plain."""
    acc = acc32(conv_sum64(x, w, stride, pad))
    return requant32(acc, bias, shift, leaky).to(torch.int16)


def window_major(b: int, h: int, wd: int) -> torch.Tensor:
    """The pixel (b, y, x), as the index (b*H + y)*W + x, of each row of the
    conv3x3_pool_q16 kernel's GEMM, (B*H*W,) int64: row m is member
    q = m % 4 of pool window m // 4, the windows in (b, ho, wo) order and
    the member at (2 ho + q // 2, 2 wo + q % 2), so rows 4i .. 4i+3 are the
    four sums that window i pools."""
    m = torch.arange(b * h * wd)
    win, q = m // 4, m % 4
    img, r = win // (h * wd // 4), win % (h * wd // 4)
    y = 2 * (r // (wd // 2)) + q // 2
    x = 2 * (r % (wd // 2)) + q % 2
    return (img * h + y) * wd + x


def pool_windows(win: torch.Tensor, bias: torch.Tensor, shift: int,
                 leaky: bool, order: str) -> torch.Tensor:
    """int32 sums (B, H/2, 2, W/2, 2, N), a pool window's members on axes 2
    and 4 (dy, dx), -> the 2x2/s2 pool and requant in ``order``, (B, H/2,
    W/2, N) int16; every max is a signed int32 (or int16) max of the
    wrapped values, as ``jnp.maximum`` takes it."""
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


def conv3x3_pool_q16_plain(x: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor, shift: int, leaky: bool,
                           order: str, planes=None) -> torch.Tensor:
    """conv3x3_q16_plain's sums, then the 2x2/s2 pool in ``order``
    (``pool_windows``); ``planes`` is taken and not read, as in
    mm_q16_plain."""
    acc = acc32(conv3x3_sum64(x, w))
    b, h, wd, n = acc.shape
    # (b, ho, dy, wo, dx, n)
    return pool_windows(acc.reshape(b, h // 2, 2, wd // 2, 2, n), bias, shift,
                        leaky, order)


def check_operands(name: str, x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor, x_ndim: int, w_shape_ok: bool,
                   x_dtype: torch.dtype = torch.int16,
                   w_dtype: torch.dtype = torch.int16) -> None:
    """Raise unless x, w and bias have the dtypes, ranks and shapes a
    wrapper takes (``w_shape_ok``: w fits x) and lie on one device, the CPU
    or a card, contiguous on a card."""
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


def check_conv(name: str, x: torch.Tensor, w: torch.Tensor, stride: int,
               pad: int) -> tuple[int, int]:
    """The output's (Ho, Wo) of a general conv of x (B, H, W, C) by w
    (k, k, C, N) at ``stride`` and ``pad``; ValueError where the geometry
    gives no output."""
    k = w.shape[0]
    if stride < 1 or pad < 0 or min(x.shape[1:3]) + 2 * pad < k:
        raise ValueError(f"{name}: a {k}x{k} conv with stride {stride} and "
                         f"padding {pad} has no output on "
                         f"{tuple(x.shape[1:3])}")
    return conv_out_hw(x.shape[1], x.shape[2], k, stride, pad)


def conv_weight_ok(x: torch.Tensor, w: torch.Tensor) -> bool:
    """w is a square (k, k, C, N) HWIO weight for x's C channels."""
    return (w.ndim == 4 and w.shape[0] == w.shape[1]
            and w.shape[2] == x.shape[-1])


def mm_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, shift: int,
           leaky: bool, planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) int16 @ w (K, N) int16, fused requant -> (M, N) int16. On
    the card ``planes`` (pack_q16(w)) is the kernel's weight operand."""
    check_operands("mm_q16", x, w, bias, 2,
                   w.ndim == 2 and w.shape[0] == x.shape[-1])
    if x.device.type == "cpu":
        return mm_q16_plain(x, w, bias, shift, leaky)
    (m, k), n = x.shape, w.shape[1]
    _build.check_rows("mm_q16", m)
    tc.check_planes("mm_q16", planes, k, n, x.device, tc.Q16)
    out = torch.empty((m, n), dtype=torch.int16, device=x.device)
    return tc.launch("mm_q16", "yq16_mm", out, m, n, k,
                     (x.data_ptr(), planes.data_ptr(), bias.data_ptr()),
                     (m, k, n, int(shift), int(leaky)), tc.Q16, LAUNCHES)


def conv3x3_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                shift: int, leaky: bool,
                planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int16, w (3, 3, C, N) int16 -> SAME 3x3/s1 conv with
    fused requant, (B, H, W, N) int16. On the card ``planes``
    (pack_q16(w)) is the kernel's weight operand."""
    check_operands("conv3x3_q16", x, w, bias, 4,
                   w.ndim == 4 and w.shape[:3] == (3, 3, x.shape[-1]))
    if x.device.type == "cpu":
        return conv3x3_q16_plain(x, w, bias, shift, leaky)
    b, h, wd, c = x.shape
    n = w.shape[-1]
    _build.check_rows("conv3x3_q16", b * h * wd)
    tc.check_planes("conv3x3_q16", planes, 9 * c, n, x.device, tc.Q16)
    out = torch.empty((b, h, wd, n), dtype=torch.int16, device=x.device)
    return tc.launch("conv3x3_q16", "yq16_conv3x3", out, b * h * wd, n, 9 * c,
                     (x.data_ptr(), planes.data_ptr(), bias.data_ptr()),
                     (b, h, wd, c, n, int(shift), int(leaky)), tc.Q16,
                     LAUNCHES)


def conv3x3_pool_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     shift: int, leaky: bool, order: str,
                     planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int16 with H and W even, w (3, 3, C, N) int16 -> SAME
    3x3/s1 conv with fused requant and the darknet 2x2/s2 maxpool after it,
    the max taken in ``order`` (one of POOL_ORDERS): (B, H/2, W/2, N)
    int16. On the card ``planes`` (pack_q16(w), conv3x3_q16's) is the
    kernel's weight operand; K is split as for the conv's B*H*W rows."""
    check_operands("conv3x3_pool_q16", x, w, bias, 4,
                   w.ndim == 4 and w.shape[:3] == (3, 3, x.shape[-1]))
    b, h, wd, c = x.shape
    if h % 2 or wd % 2 or order not in POOL_ORDERS:
        raise ValueError(f"conv3x3_pool_q16: want even H and W and an order "
                         f"in {POOL_ORDERS}; got {h}x{wd}, {order!r}")
    if x.device.type == "cpu":
        return conv3x3_pool_q16_plain(x, w, bias, shift, leaky, order)
    n = w.shape[-1]
    _build.check_rows("conv3x3_pool_q16", b * h * wd)
    tc.check_planes("conv3x3_pool_q16", planes, 9 * c, n, x.device, tc.Q16)
    out = torch.empty((b, h // 2, wd // 2, n), dtype=torch.int16,
                      device=x.device)
    return tc.launch("conv3x3_pool_q16", "yq16_conv3x3_pool", out,
                     b * h * wd, n, 9 * c,
                     (x.data_ptr(), planes.data_ptr(), bias.data_ptr()),
                     (b, h, wd, c, n, int(shift), int(leaky),
                      POOL_ORDERS.index(order)), tc.Q16, LAUNCHES)


def conv_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, shift: int,
             leaky: bool, stride: int, pad: int,
             planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int16, w (k, k, C, N) int16 -> the k x k conv with
    ``stride`` and ``pad`` pixels of zeros on each side of H and W, fused
    requant: (B, Ho, Wo, N) int16, Ho = (H + 2 pad - k) // stride + 1. Any
    conv of the int16 tier that is not a regular 1x1 or 3x3/s1. On the card
    ``planes`` (pack_q16(w)) is the kernel's weight operand."""
    check_operands("conv_q16", x, w, bias, 4, conv_weight_ok(x, w))
    ho, wo = check_conv("conv_q16", x, w, stride, pad)
    if x.device.type == "cpu":
        return conv_q16_plain(x, w, bias, shift, leaky, stride, pad)
    b, h, wd, c = x.shape
    k, n = w.shape[0], w.shape[-1]
    _build.check_rows("conv_q16", b * ho * wo)
    tc.check_planes("conv_q16", planes, k * k * c, n, x.device, tc.Q16)
    out = torch.empty((b, ho, wo, n), dtype=torch.int16, device=x.device)
    return tc.launch_convk("conv_q16", "yq16_conv", out, b * ho * wo, n,
                           k * k * c,
                           (x.data_ptr(), planes.data_ptr(), bias.data_ptr()),
                           (b, h, wd, c, n, k, int(stride), int(pad),
                            int(shift), int(leaky)),
                           tc.Q16, LAUNCHES)
