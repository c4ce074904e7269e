"""The four conv kernels of the 8-bit-weight tiers: wrappers, plain
versions, weight packing, launch counts.

The counterpart of ``yolotpu/ops/pallas_matmul.py`` and of the w8 section of
``yolotpu/ops/pallas_q16.py``. Every kernel computes the exact sum modulo
2^32 followed by the per-channel requant chain (``convops.requant32`` with
an (N,) shift vector and the output type's range):

  mm_s8          x int8 (M, K) @ w int8 (K, N) -> int8, or int16 for the
                 head16 conv (replaces ``matmul_int8_requant`` and
                 ``matmul_int16_out_requant``)
  mm_w8a16       x int16 (M, K) @ w int8 (K, N) -> int16
                 (replaces ``matmul_w8a16_requant``)
  conv3x3_s8     SAME 3x3/s1 conv, int8 NHWC x int8 HWIO -> int8
                 (replaces ``conv3x3_s8_wi``)
  conv3x3_w8a16  SAME 3x3/s1 conv, int16 NHWC x int8 HWIO -> int16
                 (replaces ``conv3x3_w8a16_wi``)
  conv3x3_pool_s8
                 conv3x3_s8 and the darknet 2x2/s2 maxpool after it, in
                 darknet's order (requant, then the max), -> (B, H/2, W/2,
                 N) int8 (replaces no Pallas kernel: the JAX package's
                 int8 tier runs ``convops.conv_int8`` then ``pool.maxpool``)
  conv3x3_int8   conv3x3_s8 with one shift for the layer, broadcast here:
                 the same function and kernel (replaces
                 ``pallas_conv.conv3x3_int8`` and ``conv3x3_int8_im2col``)
  conv_s8        any k x k conv, any stride and zero padding, int8 NHWC x
                 int8 HWIO -> int8, or int16 for a head16 conv that is not
                 a 1x1 (replaces no Pallas kernel: XLA's s8 conv in
                 ``convops.conv_int8``)
  conv_w8a16     the same, int16 NHWC x int8 HWIO -> int16 (XLA's conv in
                 ``convops.conv_w8a16``)

The kernels' shift is always an (N,) int32 tensor: a per-layer shift is
broadcast once, when the model is built.

All of them run on the 8-bit tensor cores (``csrc/igemm_tc.cuh`` and
``ops.tc``, the body they share with ``q16``'s tensor-core kernels;
conv_s8 and conv_w8a16 on the general convs' own kernel,
``csrc/convk_tc.cuh``, launched by ``tc.launch_convk``) in two operand
schemes: ``tc.S8`` (mm_s8, conv3x3_s8, conv3x3_pool_s8, conv3x3_int8,
conv_s8: int8 x int8, one s32 sum) and ``tc.W8A16`` (mm_w8a16, conv3x3_w8a16,
conv_w8a16: each int16
activation cut into an s8 high and a u8 low byte against the int8 weight,
two s32 sums recombined as (high << 8) + low modulo 2^32; the TPU's low
plane carried a -128 offset and a ``cw``/``nconst`` column constant, which
do not carry over). On the card they take the weights also as one packed s8
plane, ``planes=`` (``pack_s8`` or ``pack_w8a16``, by the kernel's scheme,
of the (K, N) or HWIO weight, made once at model build), and ``tc.emulate``
computes the sums from those planes the way the kernels do, so the CPU
tests hold the layout.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches the hand-written kernel (``csrc/``, built by ``_build``) or raises.
``LAUNCHES`` counts kernel launches, and only those; ``INT16_OUT_LAUNCHES``
counts the ``mm_s8`` and ``conv_s8`` launches among them that wrote int16.

The plain versions reuse ``q16.mm_sum64``, ``q16.conv3x3_sum64`` and
``q16.conv_sum64``: float64 sums of integer products, exact here because
|x*w| <= 2^22 and K <= 49*1280 keep every partial sum below 2^38.
"""

from __future__ import annotations

import torch

from . import _build, q16, tc
from .convops import requant32

LAUNCHES = {"mm_s8": 0, "mm_w8a16": 0, "conv3x3_s8": 0, "conv3x3_w8a16": 0,
            "conv3x3_int8": 0, "conv_s8": 0, "conv_w8a16": 0,
            "conv3x3_pool_s8": 0}
INT16_OUT_LAUNCHES = {"mm_s8": 0, "conv_s8": 0}

_RANGE = {torch.int8: (-128, 127), torch.int16: (-32768, 32767)}


def reset_launches() -> None:
    for counts in (LAUNCHES, INT16_OUT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _requant(accf: torch.Tensor, bias: torch.Tensor, shift: torch.Tensor,
             leaky: bool, out_dtype: torch.dtype) -> torch.Tensor:
    lo, hi = _RANGE[out_dtype]
    return requant32(q16.acc32(accf), bias, shift, leaky, lo, hi).to(out_dtype)


def mm_s8_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                shift: torch.Tensor, leaky: bool,
                out_dtype: torch.dtype = torch.int8,
                planes=None) -> torch.Tensor:
    """mm_s8 in float64; ``planes`` is taken, as the kernel takes it, and
    not read: the plain version reads w."""
    return _requant(q16.mm_sum64(x, w), bias, shift, leaky, out_dtype)


def mm_w8a16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   shift: torch.Tensor, leaky: bool,
                   planes=None) -> torch.Tensor:
    """mm_w8a16 in float64; ``planes`` is taken and not read."""
    return _requant(q16.mm_sum64(x, w), bias, shift, leaky, torch.int16)


def conv3x3_s8_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     shift: torch.Tensor, leaky: bool,
                     planes=None) -> torch.Tensor:
    """conv3x3_s8 in float64; ``planes`` is taken and not read."""
    return _requant(q16.conv3x3_sum64(x, w), bias, shift, leaky, torch.int8)


def conv3x3_pool_s8_plain(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, shift: torch.Tensor,
                          leaky: bool, planes=None) -> torch.Tensor:
    """conv3x3_s8_plain's sums and per-channel requant, then the max of each
    2x2/s2 window; ``planes`` is taken and not read."""
    y = conv3x3_s8_plain(x, w, bias, shift, leaky)
    b, h, wd, n = y.shape
    return y.reshape(b, h // 2, 2, wd // 2, 2, n).amax(dim=(2, 4))


def conv3x3_w8a16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        shift: torch.Tensor, leaky: bool,
                        planes=None) -> torch.Tensor:
    """conv3x3_w8a16 in float64; ``planes`` is taken and not read."""
    return _requant(q16.conv3x3_sum64(x, w), bias, shift, leaky, torch.int16)


def conv_s8_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  shift: torch.Tensor, leaky: bool, stride: int, pad: int,
                  out_dtype: torch.dtype = torch.int8,
                  planes=None) -> torch.Tensor:
    """conv_s8 in float64; ``planes`` is taken and not read."""
    return _requant(q16.conv_sum64(x, w, stride, pad), bias, shift, leaky,
                    out_dtype)


def conv_w8a16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     shift: torch.Tensor, leaky: bool, stride: int, pad: int,
                     planes=None) -> torch.Tensor:
    """conv_w8a16 in float64; ``planes`` is taken and not read."""
    return _requant(q16.conv_sum64(x, w, stride, pad), bias, shift, leaky,
                    torch.int16)


def _broadcast(shift_out: int, w: torch.Tensor) -> torch.Tensor:
    return torch.full((w.shape[-1],), int(shift_out), dtype=torch.int32,
                      device=w.device)


def conv3x3_int8_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       shift_out: int, leaky: bool,
                       planes=None) -> torch.Tensor:
    """conv3x3_int8 in float64; ``planes`` is taken and not read."""
    return conv3x3_s8_plain(x, w, bias, _broadcast(shift_out, w), leaky)


def _pack(w: torch.Tensor, scheme: tc.Scheme) -> torch.Tensor:
    """int8 weights, (C, N) or HWIO (k, k, C, N), read as (K, N) -> the
    ``scheme`` kernel's B operand, one s8 plane (``tc.arrange_planes``,
    uint8 ``scheme.planes_shape(K, N)`` on w's device: K padded to 128 for
    tc.S8 and to 64 for tc.W8A16, N to 64, with zeros), in natural k order
    for tc.S8 and in FRAG_K order for tc.W8A16, whose A fragments come from
    int16 activations."""
    return tc.arrange_planes([w.reshape(-1, w.shape[-1]).view(torch.uint8)],
                             scheme)


def pack_s8(w: torch.Tensor) -> torch.Tensor:
    """The planes of w, (K, N) or (k, k, C, N) int8, for the tc.S8 kernels:
    mm_s8, conv3x3_s8, conv3x3_pool_s8, conv3x3_int8 and conv_s8."""
    return _pack(w, tc.S8)


def pack_w8a16(w: torch.Tensor) -> torch.Tensor:
    """The planes of w, (K, N) or (k, k, C, N) int8, for the tc.W8A16
    kernels: mm_w8a16, conv3x3_w8a16 and conv_w8a16."""
    return _pack(w, tc.W8A16)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           shift: torch.Tensor, x_dtype: torch.dtype, x_ndim: int,
           general: bool = False) -> None:
    """x_ndim 2: a matmul, w (K, N); 4: a 3x3 conv, w (3, 3, C, N), or with
    ``general`` any k x k conv, w (k, k, C, N)."""
    w_ok = (w.ndim == 2 and w.shape[0] == x.shape[-1] if x_ndim == 2 else
            q16.conv_weight_ok(x, w) if general else
            w.ndim == 4 and w.shape[:3] == (3, 3, x.shape[-1]))
    q16.check_operands(name, x, w, bias, x_ndim, w_ok, x_dtype=x_dtype,
                       w_dtype=torch.int8)
    if shift.dtype != torch.int32 or shift.shape != bias.shape \
            or shift.device != x.device:
        raise ValueError(f"{name}: want an int32 shift of shape "
                         f"{tuple(bias.shape)} on {x.device}; got {shift.dtype} "
                         f"{tuple(shift.shape)} on {shift.device}")
    if x.device.type == "cuda" and not shift.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous shift")


def _launch(name: str, fn: str, x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor, shift: torch.Tensor, leaky: bool,
            out_dtype: torch.dtype, planes, scheme: tc.Scheme,
            *flags: int,
            conv: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch ``scheme``'s kernel ``fn`` on checked operands: x (M, K) against
    w (K, N), or x NHWC against w (3, 3, C, N), or with ``conv`` = (stride,
    pad) x NHWC against w (k, k, C, N) in a general conv whose geometry
    ``q16.check_conv`` has passed; the entry point's ints are x's shape, N,
    for a general conv k, stride and pad, then leaky and ``flags``. A
    general conv launches through ``tc.launch_convk``, the others through
    ``tc.launch``."""
    n = w.shape[-1]
    k = w.numel() // n
    shape, geometry = (*x.shape[:-1], n), ()
    if conv is not None:
        ho, wo = q16.conv_out_hw(x.shape[1], x.shape[2], w.shape[0], *conv)
        shape = (x.shape[0], ho, wo, n)
        geometry = (w.shape[0], *(int(v) for v in conv))
    m = shape[0] * shape[1] * shape[2] if len(shape) == 4 else shape[0]
    _build.check_rows(name, m)
    tc.check_planes(name, planes, k, n, x.device, scheme)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    launch = tc.launch if conv is None else tc.launch_convk
    return launch(name, fn, out, m, n, k,
                  (x.data_ptr(), planes.data_ptr(), bias.data_ptr(),
                   shift.data_ptr()),
                  (*x.shape, n, *geometry, int(leaky), *flags), scheme,
                  LAUNCHES)


def mm_s8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
          shift: torch.Tensor, leaky: bool,
          out_dtype: torch.dtype = torch.int8,
          planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) int8 @ w (K, N) int8, fused per-channel requant -> (M, N)
    int8, or int16 with ``out_dtype=torch.int16`` (the head16 conv). On the
    card ``planes`` (pack_s8(w)) is the kernel's weight operand."""
    if out_dtype not in _RANGE:
        raise ValueError(f"mm_s8: out_dtype {out_dtype} (int8 or int16)")
    _check("mm_s8", x, w, bias, shift, torch.int8, 2)
    if x.device.type == "cpu":
        return mm_s8_plain(x, w, bias, shift, leaky, out_dtype)
    out16 = out_dtype == torch.int16
    out = _launch("mm_s8", "yq8_mm_s8", x, w, bias, shift, leaky, out_dtype,
                  planes, tc.S8, int(out16))
    INT16_OUT_LAUNCHES["mm_s8"] += out16
    return out


def mm_w8a16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             shift: torch.Tensor, leaky: bool,
             planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) int16 @ w (K, N) int8, fused per-channel requant -> (M, N)
    int16. On the card ``planes`` (pack_w8a16(w)) is the kernel's weight
    operand."""
    _check("mm_w8a16", x, w, bias, shift, torch.int16, 2)
    if x.device.type == "cpu":
        return mm_w8a16_plain(x, w, bias, shift, leaky)
    return _launch("mm_w8a16", "yq8_mm_w8a16", x, w, bias, shift, leaky,
                   torch.int16, planes, tc.W8A16)


def conv3x3_s8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               shift: torch.Tensor, leaky: bool,
               planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8, w (3, 3, C, N) int8 -> SAME 3x3/s1 conv with the
    fused per-channel requant, (B, H, W, N) int8. On the card ``planes``
    (pack_s8(w)) is the kernel's weight operand."""
    _check("conv3x3_s8", x, w, bias, shift, torch.int8, 4)
    if x.device.type == "cpu":
        return conv3x3_s8_plain(x, w, bias, shift, leaky)
    return _launch("conv3x3_s8", "yq8_conv3x3_s8", x, w, bias, shift, leaky,
                   torch.int8, planes, tc.S8)


def conv3x3_pool_s8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    shift: torch.Tensor, leaky: bool,
                    planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8 with H and W even, w (3, 3, C, N) int8 -> SAME
    3x3/s1 conv with the fused per-channel requant and the darknet 2x2/s2
    maxpool after it, (B, H/2, W/2, N) int8: conv3x3_s8 then the pool, bit
    for bit. On the card ``planes`` (pack_s8(w), conv3x3_s8's) is the
    kernel's weight operand; K is split as for the conv's B*H*W rows."""
    _check("conv3x3_pool_s8", x, w, bias, shift, torch.int8, 4)
    b, h, wd, c = x.shape
    if h % 2 or wd % 2:
        raise ValueError(f"conv3x3_pool_s8: want even H and W; got {h}x{wd}")
    if x.device.type == "cpu":
        return conv3x3_pool_s8_plain(x, w, bias, shift, leaky)
    n = w.shape[-1]
    _build.check_rows("conv3x3_pool_s8", b * h * wd)
    tc.check_planes("conv3x3_pool_s8", planes, 9 * c, n, x.device, tc.S8)
    out = torch.empty((b, h // 2, wd // 2, n), dtype=torch.int8,
                      device=x.device)
    return tc.launch("conv3x3_pool_s8", "yq8_conv3x3_pool_s8", out,
                     b * h * wd, n, 9 * c,
                     (x.data_ptr(), planes.data_ptr(), bias.data_ptr(),
                      shift.data_ptr()),
                     (b, h, wd, c, n, int(leaky)), tc.S8, LAUNCHES)


def conv3x3_int8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 shift_out: int, leaky: bool,
                 planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8, w (3, 3, C, N) int8 -> SAME 3x3/s1 conv, one
    shift for the layer, +bias, clip to int8, integer leaky: (B, H, W, N)
    int8. conv3x3_s8's kernel, with the shift broadcast to (N,); on the card
    ``planes`` is pack_s8(w)."""
    shift = _broadcast(shift_out, w)
    _check("conv3x3_int8", x, w, bias, shift, torch.int8, 4)
    if x.device.type == "cpu":
        return conv3x3_s8_plain(x, w, bias, shift, leaky)
    return _launch("conv3x3_int8", "yq8_conv3x3_s8", x, w, bias, shift,
                   leaky, torch.int8, planes, tc.S8)


def conv3x3_w8a16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  shift: torch.Tensor, leaky: bool,
                  planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int16, w (3, 3, C, N) int8 -> SAME 3x3/s1 conv with the
    fused per-channel requant, (B, H, W, N) int16. On the card ``planes``
    (pack_w8a16(w)) is the kernel's weight operand."""
    _check("conv3x3_w8a16", x, w, bias, shift, torch.int16, 4)
    if x.device.type == "cpu":
        return conv3x3_w8a16_plain(x, w, bias, shift, leaky)
    return _launch("conv3x3_w8a16", "yq8_conv3x3_w8a16", x, w, bias, shift,
                   leaky, torch.int16, planes, tc.W8A16)


def conv_s8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            shift: torch.Tensor, leaky: bool, stride: int, pad: int,
            out_dtype: torch.dtype = torch.int8,
            planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int8, w (k, k, C, N) int8 -> the k x k conv with
    ``stride`` and ``pad`` pixels of zeros on each side of H and W, fused
    per-channel requant: (B, Ho, Wo, N) int8, Ho = (H + 2 pad - k) // stride
    + 1, or int16 with ``out_dtype=torch.int16`` (a head16 conv). Any conv
    of the int8 tier that is not a regular 1x1 or 3x3/s1. On the card
    ``planes`` (pack_s8(w)) is the kernel's weight operand."""
    if out_dtype not in _RANGE:
        raise ValueError(f"conv_s8: out_dtype {out_dtype} (int8 or int16)")
    _check("conv_s8", x, w, bias, shift, torch.int8, 4, general=True)
    q16.check_conv("conv_s8", x, w, stride, pad)
    if x.device.type == "cpu":
        return conv_s8_plain(x, w, bias, shift, leaky, stride, pad, out_dtype)
    out16 = out_dtype == torch.int16
    out = _launch("conv_s8", "yq8_conv_s8", x, w, bias, shift, leaky,
                  out_dtype, planes, tc.S8, int(out16), conv=(stride, pad))
    INT16_OUT_LAUNCHES["conv_s8"] += out16
    return out


def conv_w8a16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               shift: torch.Tensor, leaky: bool, stride: int, pad: int,
               planes: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C) int16, w (k, k, C, N) int8 -> the k x k conv with
    ``stride`` and ``pad`` pixels of zeros on each side of H and W, fused
    per-channel requant: (B, Ho, Wo, N) int16. Any conv of the w8a16 tier
    that is not a regular 1x1 or 3x3/s1. On the card ``planes``
    (pack_w8a16(w)) is the kernel's weight operand."""
    _check("conv_w8a16", x, w, bias, shift, torch.int16, 4, general=True)
    q16.check_conv("conv_w8a16", x, w, stride, pad)
    if x.device.type == "cpu":
        return conv_w8a16_plain(x, w, bias, shift, leaky, stride, pad)
    return _launch("conv_w8a16", "yq8_conv_w8a16", x, w, bias, shift, leaky,
                   torch.int16, planes, tc.W8A16, conv=(stride, pad))
