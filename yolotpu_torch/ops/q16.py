"""The two exact-int16 conv kernels: wrappers, plain versions, launch counts.

The counterpart of ``yolotpu/ops/pallas_q16.py``. Both kernels compute what
the Pallas kernels compute, the exact int16 x int16 sum modulo 2^32 followed
by the requant chain (``convops.requant32``):

  mm_q16        x (M, K) @ w (K, N)               the 1x1 convs
                (replaces ``matmul_q16_requant``)
  conv3x3_q16   SAME 3x3/s1 conv, NHWC x HWIO      the 3x3 convs
                (replaces ``conv3x3_q16_flat`` and its fallback
                ``conv3x3_q16_requant``)

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches the hand-written kernel (``csrc/``, built by ``_build``) or raises.
``LAUNCHES`` counts kernel launches, and only those.

The plain versions gather the 1 or 9 taps and run one float64 matmul. That
is exact: |x*w| <= 2^30 and K <= 9*1280 keep every partial sum below 2^44,
far inside float64's 53-bit mantissa in any summation order, so rounding to
int64 and wrapping to int32 gives the wraparound int32 sum.

Weights need no packing beyond the JAX tree's own layout: the kernels read
HWIO int16 as a (taps*C, N) row-major matrix, and the bias is the (N,)
int32 pre-shifted bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .convops import requant32, wrap32

LAUNCHES = {"mm_q16": 0, "conv3x3_q16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def prep_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO int16 (k, k, C, N) -> the kernels' weight operand: (C, N) for a
    1x1 layer, (3, 3, C, N) for a 3x3 one, contiguous int16."""
    w = w_hwio.to(torch.int16)
    if w.shape[:2] == (1, 1):
        w = w.reshape(w.shape[2], w.shape[3])
    return w.contiguous()


def _acc32(accf: torch.Tensor) -> torch.Tensor:
    """Exact float64 sums -> int32 modulo 2^32."""
    return wrap32(torch.round(accf).to(torch.int64))


def mm_sum64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact (M, N) sums of mm_q16, before the wrap, in float64."""
    return x.to(torch.float64) @ w.to(torch.float64)


def conv3x3_sum64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact (B, H, W, N) sums of conv3x3_q16, before the wrap, in
    float64."""
    b, h, wd, c = x.shape
    n = w.shape[-1]
    xp = F.pad(x.to(torch.float64), (0, 0, 1, 1, 1, 1))   # SAME: zeros
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd]
                      for dy in range(3) for dx in range(3)], dim=-1)
    acc = cols.reshape(-1, 9 * c) @ w.reshape(9 * c, n).to(torch.float64)
    return acc.reshape(b, h, wd, n)


def mm_q16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 shift: int, leaky: bool) -> torch.Tensor:
    acc = _acc32(mm_sum64(x, w))
    return requant32(acc, bias, shift, leaky).to(torch.int16)


def conv3x3_q16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      shift: int, leaky: bool) -> torch.Tensor:
    acc = _acc32(conv3x3_sum64(x, w))
    return requant32(acc, bias, shift, leaky).to(torch.int16)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           x_ndim: int, w_shape_ok: bool) -> None:
    if x.dtype != torch.int16 or w.dtype != torch.int16 \
            or bias.dtype != torch.int32:
        raise TypeError(f"{name}: want int16 x, int16 w, int32 bias; got "
                        f"{x.dtype}, {w.dtype}, {bias.dtype}")
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


def _launch(name: str, fn: str, out: torch.Tensor, *args) -> torch.Tensor:
    lib = _build.load_library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(lib.cdll, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def mm_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, shift: int,
           leaky: bool) -> torch.Tensor:
    """x (M, K) int16 @ w (K, N) int16, fused requant -> (M, N) int16."""
    _check("mm_q16", x, w, bias, 2, w.ndim == 2 and w.shape[0] == x.shape[-1])
    if x.device.type == "cpu":
        return mm_q16_plain(x, w, bias, shift, leaky)
    (m, k), n = x.shape, w.shape[1]
    if m >= 1 << 31:
        raise ValueError(f"mm_q16: M={m} does not fit the kernel's int")
    out = torch.empty((m, n), dtype=torch.int16, device=x.device)
    return _launch("mm_q16", "yq16_mm", out, x.data_ptr(), w.data_ptr(),
                   bias.data_ptr(), out.data_ptr(), m, k, n, int(shift),
                   int(leaky))


def conv3x3_q16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                shift: int, leaky: bool) -> torch.Tensor:
    """x (B, H, W, C) int16, w (3, 3, C, N) int16 -> SAME 3x3/s1 conv with
    fused requant, (B, H, W, N) int16."""
    _check("conv3x3_q16", x, w, bias, 4,
           w.ndim == 4 and w.shape[:3] == (3, 3, x.shape[-1]))
    if x.device.type == "cpu":
        return conv3x3_q16_plain(x, w, bias, shift, leaky)
    b, h, wd, c = x.shape
    n = w.shape[-1]
    out = torch.empty((b, h, wd, n), dtype=torch.int16, device=x.device)
    return _launch("conv3x3_q16", "yq16_conv3x3", out, x.data_ptr(),
                   w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                   b, h, wd, c, n, int(shift), int(leaky))
