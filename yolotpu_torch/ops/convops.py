"""Integer ops of the int16-exact tier, in PyTorch (NHWC).

The counterpart of the int16 subset of ``yolotpu/ops/convops.py``. The
contract is the JAX package's: integer arithmetic in int32 with wraparound,
round-half-up requant shifts with their magnitude capped at 30, int16
saturation, and the integer leaky ``v/10`` truncated toward zero. PyTorch
leaves int32 overflow to the C++ compiler, so every step that can wrap is
taken in int64 and brought back with ``wrap32``, which makes the wraparound
explicit and the same on the CPU and on the card.
"""

from __future__ import annotations

import torch


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def round_shift(v: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 shift with round-half-up on right shifts, magnitude capped at
    30, wrapping like the JAX version (``convops.round_shift``)."""
    if shift > 0:
        mag = min(shift, 30)
        return wrap32(v.to(torch.int64) + (1 << (mag - 1))) >> mag
    if shift < 0:
        return wrap32(v.to(torch.int64) << min(-shift, 30))
    return v


def sat16(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(-32768, 32767)


def leaky_int16(v: torch.Tensor) -> torch.Tensor:
    """v < 0 -> v/10 truncated toward zero; int32 in, int32 out."""
    return torch.where(v < 0, torch.div(v, 10, rounding_mode="trunc"), v)


def requant32(acc: torch.Tensor, bias: torch.Tensor, shift: int,
              leaky: bool) -> torch.Tensor:
    """The kernels' epilogue (``pallas_q16._requant32``): int32 accumulator
    -> shift, +bias (wrapping), sat16, optional integer leaky; int32 out."""
    v = sat16(wrap32(round_shift(acc, shift).to(torch.int64)
                     + bias.to(torch.int64)))
    if leaky:
        v = sat16(leaky_int16(v))
    return v


def quantize_input_int16(x: torch.Tensor, q: int) -> torch.Tensor:
    """fp32 -> int16 at scale 2**q: fp32 clamp, then round half away from
    zero (``convops.quantize_input_int16``)."""
    v = (x.to(torch.float32) * (2.0 ** q)).clamp(-32768.0, 32767.0)
    r = torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))
    return r.to(torch.int16)


def dequantize_int16(x: torch.Tensor, q: int) -> torch.Tensor:
    return x.to(torch.float32) * (2.0 ** (-q))


def realign_int16(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Reorg-branch Q realignment: arithmetic shift with no rounding, then
    saturation to the input's own integer range."""
    info = torch.iinfo(x.dtype)
    v = x.to(torch.int64)
    v = (v >> shift) if shift > 0 else wrap32(v << -shift).to(torch.int64)
    return v.clamp(info.min, info.max).to(x.dtype)
