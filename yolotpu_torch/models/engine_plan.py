"""Per-layer kernel plan of the integer tiers on the GPU.

The counterpart of ``yolotpu/models/engine_plan.py``. The default plan is
one rule for every tier:

  regular 1x1/s1 conv  -> "mm"
  regular 3x3/s1 conv  -> "conv3", the C=3 entry conv and the 208x208 /
                          104x104 layers included
  any other conv       -> "xla", as ``yolotpu``'s ``select_engine`` names
                          it: any k x k size, any stride, darknet or
                          explicit padding (VALID, padding=)

where regular means stride 1, darknet SAME padding, no groups, and a linear
or leaky activation. Every conv of yolov2, yolov2-voc and yolov2-tiny is
regular. The kernel of each route (``kernels``), by tier:

  tier    mm                  conv3                  conv
  int16   ops.q16.mm_q16      ops.q16.conv3x3_q16    ops.q16.conv_q16
  int8    ops.q8.mm_s8        ops.q8.conv3x3_s8      ops.q8.conv_s8
  w8a16   ops.q8.mm_w8a16     ops.q8.conv3x3_w8a16   ops.q8.conv_w8a16

In the int8 tier the conv that feeds the region writes int16 (head16):
``mm_s8``'s or ``conv_s8``'s int16 output.

Both integer tiers fold pools by one rule, from the graph and the tier
(``kernels``): a regular 3x3/s1 conv that a darknet 2x2/s2 pool follows
(``next_is_pool22``), and whose own output no route reads, also computes
that pool, route ("conv3_pool", order), and the pool does not run:

  | tier   | conv                                     | port kernel       | pool order |
  |--------|------------------------------------------|-------------------|------------|
  | int16  | regular 3x3/s1, a 2x2/s2 pool after it,  | conv3x3_pool_q16  | "acc": max of the 4 accumulators, then requant |
  |        |   its own output read by no route        |                   |            |
  | int8   | the same                                 | conv3x3_pool_s8   | None: darknet's, requant each of the 4, then max |
  | w8a16, | -                                        | -                 | no fold: no pooled kernel |
  |   fp32 |                                          |                   |            |

("acc" is darknet's order whenever acc + 2^(shift-1) does not wrap int32;
the int16 fold measured faster than the unfused convs at b=1, 8 and 128 on
an H100, ``plans/plan_search_yolov2_416_nvidia_h100_80gb_hbm3.json``.) The
JAX package runs these pools as their own op; the int16 fold is bit-equal
to its Pallas kinds ``entry_sdmm``/``sd_pool``, which take the max in the
same order.

The one lever over the rule is the int16 tier's ``YOLO2_Q16_PLAN``, the
TPU plan's per-layer overrides in its format
(``YOLO2_Q16_PLAN="0:entry_sdmm,2:sd_pool"``, parsed by ``plan_overrides``,
which with ``ALL_KINDS`` and ``next_is_pool22`` mirrors
``yolotpu/models/engine_plan.py``), with every kind of ``ALL_KINDS``
accepted where ``yolotpu``'s ``params_q16`` accepts it and refused with the
same ``ValueError`` where it does not. A conv the lever names runs its
kind, fold or none, whatever the rule would give it (``2:conv3`` runs conv
2 unfused, its pool as its own op). A kind that folds the following 2x2/s2
pool runs ``ops.q16.conv3x3_pool_q16`` (conv3x3_q16's tensor-core body with
the pool in its epilogue) in the order where the TPU kind takes the pool's
max; the orders differ once acc + 2^(shift-1) wraps:

  | TPU kind                                       | port kernel       | pool order |
  |------------------------------------------------|-------------------|------------|
  | entry_sdmm (K8), entry_sd, entry_s2d, sd_pool  | conv3x3_pool_q16  | "acc": max of the 4 accumulators, then requant |
  | entryf (K9), entry8 (K10)                      | conv3x3_pool_q16  | "acc_h": max of each horizontal pair on the accumulator, requant, max of the vertical pair |
  | conv3p2 (K11; K12 is its flat-band form) when  | conv3x3_pool_q16  | "out": requant each of the 4, then max |
  |   a 2x2/s2 pool follows                        |                   |            |
  | conv3p2 with no pool after; conv3, xla, xla8,  | conv3x3_q16 (K2)  | - (a following pool runs as its own op) |
  |   mm_patches, mm_pairs, nchw, on a regular 3x3 |                   |            |
  | mm; xla or nchw on a regular 1x1               | mm_q16            | -          |
  | xla, xla8 or nchw on any other conv            | conv_q16          | -          |

The TPU kinds' space-to-depth and p2 lane packing, hi/lo s8 planes and
8-pixel patch groups were how they reached the TPU's s8 matrix unit with
full lanes; they do not carry over (ROADMAP.md). Where a route reads the
conv's own pre-pool output, a fused kind runs unfused, conv3x3_q16 then the
pool, as ``yolotpu`` does (its ``xla_fallback``). A conv whose activation is
not linear or leaky, or with groups, raises NotImplementedError in every
integer tier, as in ``yolotpu``, whose integer convs refuse any other
activation (``convops.conv_int16``, ``conv_w8a16``, ``conv_int8``) and
have no grouped form.

``yolotpu``'s other knobs do not carry over. Its per-chip plan file is the
rule here, for every network and card. Its ``entry`` ("sd" runs a C<=4
entry conv as "entry_sd") is a per-layer kind here
(``YOLO2_Q16_PLAN="0:entry_sd"``). ``max_hw`` and ``xla_min_c``
(``YOLO2_Q16_PALLAS_MAX_HW``, ``YOLO2_Q16_XLA_MIN_C``,
``YOLO2_Q16_XLA_DEC8``) only send a regular 3x3 to "xla" or "xla8", which
run the same ``conv3x3_q16`` here as "conv3" does (the table above): they
cannot change a launch. ``plan_dir()`` names where the port's evidence
files live (the search's timings, the accuracy evidence, the roofline
tables); nothing there routes a conv.
"""

from __future__ import annotations

import os
import re

import torch

from ..graph import ConvSpec, MaxPoolSpec, NetworkSpec, RouteSpec

PRODUCTION_KINDS = ("mm", "conv3", "entry_sd", "xla")
EVIDENCE_KINDS = ("entryf", "entry8", "entry_sdmm", "entry_s2d", "conv3p2",
                  "mm_pairs", "mm_patches", "nchw", "xla8", "sd_pool")
ALL_KINDS = PRODUCTION_KINDS + EVIDENCE_KINDS


def _parse_plan_items(s: str) -> dict[int, str]:
    """'idx:kind,idx:kind' -> {idx: kind}; unknown kinds fail loudly."""
    out: dict[int, str] = {}
    for item in s.split(","):
        item = item.strip()
        if not item:
            continue
        idx, _, kind = item.partition(":")
        kind = kind.strip()
        if kind not in ALL_KINDS:
            raise ValueError(
                f"YOLO2_Q16_PLAN: unknown engine kind {kind!r} "
                f"(choose from {ALL_KINDS})")
        out[int(idx)] = kind
    return out


def plan_overrides() -> dict[int, str]:
    """Parse YOLO2_Q16_PLAN — the one per-layer bisection override."""
    return _parse_plan_items(os.environ.get("YOLO2_Q16_PLAN", ""))


def tier_overrides(precision: str) -> dict[int, str] | None:
    """The overrides of a tier's model: the YOLO2_Q16_PLAN lever for int16,
    None for the other tiers."""
    return plan_overrides() if precision == "int16" else None


# ---------------------------------------------------------------------------
# Where the port's evidence files live
# ---------------------------------------------------------------------------

def device_kind_slug(kind: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", kind.lower()).strip("_")


def plan_dir() -> str:
    """The port's plans/ directory, where its evidence files are named by
    the card (``device_kind_slug``): a path, not a routing knob.
    YOLO2_PLAN_DIR overrides; the default is ``yolotpu_torch/plans/``, never
    the JAX package's ``plans/``, whose files were measured on a TPU."""
    env = os.environ.get("YOLO2_PLAN_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "plans")


def current_device_kind(device: torch.device | str) -> str:
    """The name an evidence file is keyed by: the card's for a CUDA device,
    "cpu" for any other."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def next_is_pool22(spec: NetworkSpec, idx: int) -> bool:
    """True when the layer after ``idx`` is a darknet 2x2/s2 maxpool whose
    effective padding is zero (darknet's default padding=size-1 pads only
    bottom/right and is unused when the input dims are even) — the shape
    the fused entry kinds fold into their epilogue."""
    nxt = next((l for l in spec.layers if l.idx == idx + 1), None)
    if not (isinstance(nxt, MaxPoolSpec) and nxt.size == 2
            and nxt.stride == 2):
        return False
    out_h = (nxt.h + nxt.padding - 2) // 2 + 1
    out_w = (nxt.w + nxt.padding - 2) // 2 + 1
    return (nxt.h % 2 == 0 and nxt.w % 2 == 0
            and out_h == nxt.h // 2 and out_w == nxt.w // 2)


# TPU kind -> where conv3x3_pool_q16 takes the pool's max for it
POOL_ORDER = {"entry_sdmm": "acc", "entry_sd": "acc", "entry_s2d": "acc",
              "sd_pool": "acc", "entryf": "acc_h", "entry8": "acc_h",
              "conv3p2": "out"}


def _regular(l: ConvSpec) -> bool:
    return (l.stride == 1 and l.groups == 1 and l.pad == l.size // 2
            and l.activation in ("leaky", "linear"))


def refusal(l: ConvSpec) -> str | None:
    """Why no integer kernel runs conv ``l``, or None: the JAX package's
    integer convs take a linear or leaky activation only (the int16, w8a16
    and int8 ones raise NotImplementedError for any other) and pass no
    ``feature_group_count``, so they have no grouped form."""
    if l.activation not in ("leaky", "linear"):
        return (f"conv{l.idx}: the integer tiers take a linear or leaky "
                f"activation, not {l.activation!r} (yolotpu's conv_int16, "
                "conv_w8a16 and conv_int8 raise the same)")
    if l.groups != 1:
        return (f"conv{l.idx}: groups={l.groups}; the integer tiers have no "
                "grouped conv (yolotpu's integer convs pass no "
                "feature_group_count)")
    return None


def _requirement(kind: str, l: ConvSpec,
                 spec: NetworkSpec) -> tuple[bool, str]:
    """Whether ``kind`` may run conv ``l``, and what it requires: the checks
    of ``_prep_engine`` in yolotpu's models/yolov2.py, one for one."""
    regular = _regular(l)
    pool = next_is_pool22(spec, l.idx)
    even = l.h % 2 == 0 and l.w % 2 == 0
    first = l.idx == spec.conv_layers()[0].idx
    entry = (l.size == 3 and regular and l.c <= 4 and even and pool,
             "3x3/s1 C<=4 entry followed by a darknet 2x2/s2 pool")
    entry8 = (l.size == 3 and regular and l.c <= 4 and l.w % 8 == 0
              and l.h % 2 == 0 and pool,
              "3x3/s1 C<=4 entry, W%8==0, followed by 2x2/s2 pool")
    return {
        "mm": (l.size == 1 and regular, "1x1/s1, simple act, darknet pad"),
        "conv3": (l.size == 3 and regular and l.c >= 8,
                  "3x3/s1 C>=8, simple act, darknet pad"),
        "entry_sd": entry, "entry_s2d": entry, "entry_sdmm": entry,
        "sd_pool": (l.size == 3 and regular and even and pool,
                    "3x3/s1 conv followed by a darknet 2x2/s2 pool"),
        "entryf": entry8, "entry8": entry8,
        "conv3p2": (l.size == 3 and regular and l.c < 128
                    and (4 * l.c) % 128 == 0 and l.n % 64 == 0 and even,
                    "3x3/s1, 4C%128==0, N%64==0, even H/W"),
        "mm_pairs": (l.size == 3 and regular and first and l.n % 32 == 0
                     and l.w % 2 == 0, "first conv, 3x3/s1, N%32==0, even W"),
        "mm_patches": (l.size == 3 and regular,
                       "3x3/s1, simple act, darknet pad"),
        "nchw": (first, "first conv"),
        "xla8": (l.size > 1 and l.activation in ("leaky", "linear"),
                 "KxK (K>1), simple act"),
        "xla": (True, ""),
    }[kind]


def select_engine(l: ConvSpec, spec: NetworkSpec | None = None,
                  overrides: dict[int, str] | None = None) -> str:
    """One conv layer -> its kind: the override for it, checked as
    ``yolotpu`` checks it (ValueError when illegal), or the default rule;
    NotImplementedError for a conv no integer kernel runs (``refusal``)."""
    kind = None
    if overrides and l.idx in overrides:
        kind = overrides[l.idx]
        if kind not in ALL_KINDS:
            raise ValueError(f"unknown engine kind {kind!r} for conv{l.idx}")
        ok, what = _requirement(kind, l, spec)
        if not ok:
            raise ValueError(
                f"engine {kind!r} is not applicable to conv{l.idx} "
                f"({l.size}x{l.size}/{l.stride} {l.c}->{l.n} "
                f"{l.activation}): requires {what}")
    why = refusal(l)
    if why:
        raise NotImplementedError(why)
    if kind is not None:
        return kind
    if _regular(l) and l.size == 1:
        return "mm"
    if _regular(l) and l.size == 3:
        return "conv3"
    return "xla"


def plan(spec: NetworkSpec, overrides: dict[int, str] | None = None,
         full: NetworkSpec | None = None) -> dict[int, str]:
    """conv layer idx -> kind, for every conv of the graph; ``full``, the
    network ``spec`` is a prefix of, is what the kinds are checked on."""
    return {l.idx: select_engine(l, full or spec, overrides)
            for l in spec.conv_layers()}


# tier -> the order in which its conv fused with the 2x2/s2 pool after it
# takes the pool's max (None: darknet's, the int8 kernel's only one); a tier
# not named folds no pool
FOLD_ORDER = {"int16": "acc", "int8": None}


def kernels(spec: NetworkSpec, tier: str,
            overrides: dict[int, str] | None = None,
            full: NetworkSpec | None = None
            ) -> dict[int, tuple[str, str | None]]:
    """conv layer idx -> (kernel, pool order) in ``tier``: ("mm", None) and
    ("conv3", None) for a regular 1x1 and 3x3, ("conv3_pool", order) where
    the conv also computes the 2x2/s2 pool after it, which then does not
    run, and ("conv", None) for any other conv (the kinds "xla", "xla8" and
    "nchw", the only ones ``_requirement`` lets run it); NotImplementedError
    for a conv no integer kernel runs. A conv of ``overrides`` (the lever)
    folds where its kind folds (POOL_ORDER); any other folds by the rule of
    the module's docstring: a regular 3x3 that a darknet 2x2/s2 pool
    follows and whose own output no route reads, in FOLD_ORDER's order.
    ``full`` is the network ``spec`` is a prefix of (the profiler's
    prefixes): its route, less a fold whose pool ``spec`` does not hold."""
    net = full or spec
    overrides = overrides or {}
    kinds = plan(spec, overrides, net)
    routed = {s for l in net.layers if isinstance(l, RouteSpec)
              for s in l.layers}
    held = {l.idx for l in spec.layers}
    out = {}
    for l in spec.conv_layers():
        pool = (next_is_pool22(net, l.idx) and l.idx + 1 in held
                and l.idx not in routed)
        if l.idx in overrides:
            kind = kinds[l.idx]
            fold, order = kind in POOL_ORDER, POOL_ORDER.get(kind)
        else:
            fold = tier in FOLD_ORDER and _regular(l) and l.size == 3
            order = FOLD_ORDER.get(tier)
        if fold and pool:
            out[l.idx] = ("conv3_pool", order)
        elif _regular(l) and l.size in (1, 3):
            out[l.idx] = ("mm" if l.size == 1 else "conv3", None)
        else:
            out[l.idx] = ("conv", None)
    return out
