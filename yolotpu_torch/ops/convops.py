"""Conv ops of the four tiers, in PyTorch (NHWC, weights HWIO).

The counterpart of ``yolotpu/ops/convops.py``. The fp32 tier's conv is the
JAX package's ``lax.conv_general_dilated`` at HIGHEST precision, which runs
outside any Pallas kernel: here it is ``F.conv2d`` (cuDNN on the card) with
TF32 off for the call, after darknet's explicit padding, then the bias and
one of the 13 darknet activations.

The integer ops' contract is the JAX package's: integer arithmetic in int32 with wraparound,
round-half-up requant shifts with their magnitude capped at 30 (one per
layer, or one per output channel), saturation to the output type, and the
integer leaky ``v/10`` truncated toward zero. PyTorch
leaves int32 overflow to the C++ compiler, so every step that can wrap is
taken in int64 and brought back with ``wrap32``, which makes the wraparound
explicit and the same on the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 / 255 as a true division, the host loader's and the
    JAX package's. A Python divisor would not do on the card: PyTorch's CUDA
    division by a CPU scalar multiplies by its reciprocal, which differs
    from x / 255 in the last bit for 126 of the 256 values; a 0-dim tensor
    on x's device is divided by, and is made there (no host copy, so this
    runs under CUDA graph capture)."""
    return x.to(torch.float32) / torch.full((), 255.0, device=x.device)


def pad_same_darknet(x: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    """Darknet's conv padding: ``pad`` pixels of ``value`` on each side of H
    and W of an NHWC tensor (``convops.pad_same_darknet``); the conv is then
    VALID, output (in + 2*pad - size)//stride + 1."""
    if pad == 0:
        return x
    return F.pad(x, (0, 0, pad, pad, pad, pad), value=value)


def no_tf32():
    """cuDNN's flags as the caller has them, with TF32 off, for a ``with``
    block; the caller's flags come back after it."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class Conv2dNoTF32(torch.autograd.Function):
    """``F.conv2d`` whose backward also runs with TF32 off. Autograd runs
    the backward convs after the forward's ``with`` block has ended, under
    whatever flags hold then, and PyTorch's default for cuDNN is TF32 on: a
    plain ``F.conv2d`` under ``no_tf32`` would train on TF32 gradients
    (about three decimal digits, against JAX's HIGHEST). The backward is
    the one autograd runs for a conv, ``aten.convolution_backward``, under
    ``no_tf32``. x NCHW, w OIHW, no bias, no padding."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with no_tf32():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False,
                [0, 0], 1, [*ctx.needs_input_grad[:2], False])
        return gx, gw, None


def conv_fp32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
              pad: int, activation: str) -> torch.Tensor:
    """fp32 conv + bias + activation: x (B, H, W, Cin) f32, w (k, k, Cin,
    Cout) HWIO, b (Cout,) -> (B, Ho, Wo, Cout) f32 (``convops.conv_fp32``
    at HIGHEST precision). cuDNN runs it with TF32 off for this call only
    (cuDNN's own default is TF32, about three decimal digits); the flags of
    the caller are restored after it; the conv is ``Conv2dNoTF32``, whose
    backward, where a gradient is wanted, keeps TF32 off too. A weight that
    is an HWIO view of a contiguous (Cout, k, k, Cin) tensor reaches cuDNN
    as a channels-last filter with no copy, as the NHWC input does."""
    xp = pad_same_darknet(x, pad, 0.0)
    out = Conv2dNoTF32.apply(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                             stride)
    return activate_fp32(out.permute(0, 2, 3, 1) + b, activation)


def activate_fp32(x: torch.Tensor, activation: str) -> torch.Tensor:
    """All 13 darknet activations (``convops.activate_fp32``,
    yolo_math.cpp:111-129), elementwise in fp32."""
    if activation == "linear":
        return x
    if activation == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if activation == "relu":
        return torch.clamp_min(x, 0)
    if activation == "logistic":
        return torch.sigmoid(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "elu":
        return torch.where(x >= 0, x, torch.expm1(x))
    if activation == "ramp":
        return x * (x > 0) + 0.1 * x
    if activation == "relie":
        return torch.where(x > 0, x, 0.01 * x)
    if activation == "loggy":
        return 2.0 * torch.sigmoid(x) - 1.0
    if activation == "plse":
        return torch.where(x < -4, 0.01 * (x + 4),
                           torch.where(x > 4, 0.01 * (x - 4) + 1,
                                       0.125 * x + 0.5))
    if activation == "stair":
        nf = torch.floor(x)
        half = torch.floor(x / 2.0)
        return torch.where(torch.fmod(nf, 2.0) == 0, half, (x - nf) + half)
    if activation == "hardtan":
        return torch.clamp(x, -1.0, 1.0)
    if activation == "lhtan":
        return torch.where(x < 0, 0.001 * x,
                           torch.where(x > 1, 0.001 * (x - 1) + 1, x))
    raise NotImplementedError(activation)


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


def round_shift_vec(v: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``round_shift`` with one shift per lane of the last axis (an (N,)
    int32 vector), the per-channel requant (``convops.round_shift_vec``)."""
    s = shift.to(torch.int64)
    spos = s.clamp(0, 30)
    half = torch.where(s > 0, torch.ones_like(s) << (spos - 1).clamp(min=0), 0)
    v64 = v.to(torch.int64)
    right = wrap32(v64 + half).to(torch.int64) >> spos
    left = wrap32(v64 << (-s).clamp(0, 30))
    return torch.where(s > 0, right.to(torch.int32), left)


def sat16(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(-32768, 32767)


def leaky_int16(v: torch.Tensor) -> torch.Tensor:
    """v < 0 -> v/10 truncated toward zero; int32 in, int32 out."""
    return torch.where(v < 0, torch.div(v, 10, rounding_mode="trunc"), v)


def requant32(acc: torch.Tensor, bias: torch.Tensor,
              shift: int | torch.Tensor, leaky: bool, lo: int = -32768,
              hi: int = 32767) -> torch.Tensor:
    """The kernels' epilogue (``pallas_q16._requant32``, and the per-channel
    ``_mm_requant_kernel_vshift``): int32 accumulator -> shift (an int, or an
    (N,) vector over the last axis), +bias (wrapping), saturation to
    [lo, hi], optional integer leaky; int32 out."""
    rs = (round_shift_vec(acc, shift) if isinstance(shift, torch.Tensor)
          else round_shift(acc, shift))
    v = wrap32(rs.to(torch.int64) + bias.to(torch.int64)).clamp(lo, hi)
    if leaky:
        v = leaky_int16(v).clamp(lo, hi)
    return v


def head16(bias: torch.Tensor,
           shift: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 tier's head16 epilogue (``conv_int8(head16=True)``): the
    conv feeding the region requantizes to int16 at an 8-bits-finer scale,
    so its shift drops by 8 and its bias moves up by 8 bits (taken in int64
    and wrapped to int32, as the JAX int32 shift wraps)."""
    return (wrap32(bias.to(torch.int64) << 8),
            (shift.to(torch.int64) - 8).to(torch.int32))


def quantize_input_int16(x: torch.Tensor, q: int) -> torch.Tensor:
    """fp32 -> int16 at scale 2**q: fp32 clamp, then round half away from
    zero (``convops.quantize_input_int16``)."""
    v = (x.to(torch.float32) * (2.0 ** q)).clamp(-32768.0, 32767.0)
    r = torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))
    return r.to(torch.int16)


def quantize_input_int8(x: torch.Tensor, q: int) -> torch.Tensor:
    """fp32 -> int8 at scale 2**q: fp32 clamp, then round half away from
    zero (``convops.quantize_input_int8``)."""
    v = (x.to(torch.float32) * (2.0 ** q)).clamp(-128.0, 127.0)
    r = torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))
    return r.to(torch.int8)


def dequantize_int16(x: torch.Tensor, q: int) -> torch.Tensor:
    """int16 or int8 at scale 2**q -> fp32."""
    return x.to(torch.float32) * (2.0 ** (-q))


def realign_int16(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Reorg-branch Q realignment: arithmetic shift with no rounding, then
    saturation to the input's own integer range."""
    info = torch.iinfo(x.dtype)
    v = x.to(torch.int64)
    v = (v >> shift) if shift > 0 else wrap32(v << -shift).to(torch.int64)
    return v.clamp(info.min, info.max).to(x.dtype)
