"""Per-layer kernel plan of the integer tiers on the GPU.

The counterpart of ``yolotpu/models/engine_plan.py``. The TPU plan chose,
per layer, between a dozen engine kinds measured on one TPU generation; on
the GPU each tier has two hand-written kernels that cover every conv of
yolov2, yolov2-voc and yolov2-tiny, so the plan is one rule for every tier:

  regular 1x1/s1 conv  -> "mm"
  regular 3x3/s1 conv  -> "conv3", the C=3 entry conv and the 208x208 /
                          104x104 layers included

where regular means stride 1, darknet SAME padding, no groups, and a linear
or leaky activation. The kernel of each kind, by tier:

  tier    mm                                   conv3
  int16   ops.q16.mm_q16                       ops.q16.conv3x3_q16
  int8    ops.q8.mm_s8 (int16 out: the head)   ops.q8.conv3x3_s8
  w8a16   ops.q8.mm_w8a16                      ops.q8.conv3x3_w8a16

The TPU plan's fused entry (conv 0 and pool 1 as one 4x4/s2 conv with a
group-max on the accumulator) computes the same bits as conv3 followed by
the pool only while acc + 2^(shift-1) does not wrap: the max commutes with
the requant chain because that chain is monotone, and the wrap breaks the
monotony. Here the pool runs as its own op, as darknet orders them. Where
that sum wraps (full-range operands at shift 31) the two differ: see
ROADMAP.md, Queue 3. Any other conv raises: no kernel serves it yet. No
plan file is read until one has been measured on the card.
"""

from __future__ import annotations

from yolotpu.graph import ConvSpec, NetworkSpec


def select_engine(l: ConvSpec) -> str:
    regular = (l.stride == 1 and l.groups == 1 and l.pad == l.size // 2
               and l.activation in ("leaky", "linear"))
    if regular and l.size == 1:
        return "mm"
    if regular and l.size == 3:
        return "conv3"
    raise NotImplementedError(
        f"conv{l.idx} ({l.size}x{l.size}/{l.stride} {l.c}->{l.n}, "
        f"{l.activation}, groups={l.groups}) has no GPU kernel yet: see "
        "ROADMAP.md, Queue 1, item M14 (general convs)")


def plan(spec: NetworkSpec) -> dict[int, str]:
    """conv layer idx -> kernel kind, for every conv of the graph."""
    return {l.idx: select_engine(l) for l in spec.conv_layers()}
