"""The yardstick's arithmetic: the work a frame needs, the card's peaks, and
which device kernels are the port's own.

Operations are 2 x the multiply-accumulates of every conv, counted from the
network's layers (not from the kernels launched, so a fused, split or renamed
kernel reads the same work). A conv's bytes count its input, its weights and
its output once each, at the tier's element sizes. A residual layer does
no MACs: a shortcut reads its two inputs and writes their sum, an upsample
reads its input and writes its output, once each, at the tier's activation
size. The peaks are NVIDIA's data sheet for the H100 SXM (dense rates, at
the full 700 W): 1979e12 8-bit tensor-core operations a second and 3.35e12
bytes a second of device memory.
The integer tiers run on the 8-bit tensor cores, so a MAC of the tier takes
as many 8-bit products as its operand bytes multiply to: 4 for int16 x int16,
2 for int16 x int8, 1 for int8 x int8.
"""

from __future__ import annotations

from .netcfg import Layer, convs, heads

PEAK_S8_OPS = 1979e12          # 8-bit tensor-core operations a second
PEAK_BYTES = 3.35e12           # device-memory bytes a second
# tier -> (activation bytes, weight bytes, 8-bit products a MAC)
TIERS = {"int16": (2, 2, 4), "w8a16": (2, 1, 2), "int8": (1, 1, 1)}
# the port's hand-written kernels, by a part of their device names: its
# convs (every conv of the integer tiers, those fused with a pool among
# them) and its NMS
CONV_KERNELS = ("igemm_tc_kernel", "convk_tc_kernel")
NMS_KERNELS = ("nms_table_kernel", "nms_greedy_kernel")


def is_conv(kernel: str) -> bool:
    """Whether a device kernel is one of the port's convs."""
    return any(k in kernel for k in CONV_KERNELS)


def is_ours(kernel: str) -> bool:
    """Whether a device kernel is one of the port's hand-written ones."""
    return is_conv(kernel) or any(k in kernel for k in NMS_KERNELS)


def tier_peak_ops(precision: str) -> float:
    """Operations a second the tier can reach on the 8-bit tensor cores."""
    return PEAK_S8_OPS / TIERS[precision][2]


def conv_ops(layer: Layer) -> float:
    """Operations (2 x MACs) of one conv for one frame."""
    return 2.0 * layer.macs


def conv_bytes(layer: Layer, precision: str, head: bool = False) -> float:
    """Bytes of one conv for one frame: input and output at the tier's
    activation size (the int8 tier's heads write int16), weights at its
    weight size."""
    act, wgt, _ = TIERS[precision]
    out = 2 if head else act
    return (act * layer.h * layer.w * layer.c
            + out * layer.out_h * layer.out_w * layer.out_c
            + wgt * layer.size ** 2 * layer.c * layer.out_c)


def frame_ops(layers: list[Layer]) -> float:
    """Operations of the network's convs for one frame."""
    return sum(conv_ops(l) for l in convs(layers))


def conv_bound_seconds(layers: list[Layer], precision: str) -> float:
    """The least device time of the network's convs for one frame: for each
    conv the larger of its operations over the tier's peak and its bytes
    over the memory's, summed. In the int8 tier every head's conv writes
    16 bits."""
    peak = tier_peak_ops(precision)
    head_convs = {h.idx - 1 for h in heads(layers)}
    return sum(max(conv_ops(l) / peak,
                   conv_bytes(l, precision, head=(precision == "int8"
                                                  and l.idx in head_convs))
                   / PEAK_BYTES)
               for l in convs(layers))


def residual_bytes(layers: list[Layer], precision: str) -> int:
    """Bytes of the network's shortcuts and upsamples for one frame: each
    input read and each output written once, at the tier's activation
    size."""
    n = 0
    for l in layers:
        if l.kind == "shortcut":
            n += 3 * l.h * l.w * l.c
        elif l.kind == "upsample":
            n += l.h * l.w * l.c + l.out_h * l.out_w * l.out_c
    return TIERS[precision][0] * n


def residual_bound_seconds(layers: list[Layer], precision: str) -> float:
    """The least device time of the network's shortcuts and upsamples for
    one frame: their bytes over the memory's peak."""
    return residual_bytes(layers, precision) / PEAK_BYTES
