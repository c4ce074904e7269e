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

The int16 tier also takes the TPU plan's per-layer overrides, in its format
(``YOLO2_Q16_PLAN="0:entry_sdmm,2:sd_pool"``, parsed by ``plan_overrides``,
which with ``ALL_KINDS`` and ``next_is_pool22`` mirrors
``yolotpu/models/engine_plan.py``), with every kind of ``ALL_KINDS`` accepted where ``yolotpu``'s
``params_q16`` accepts it and refused with the same ``ValueError`` where it
does not. A kind that folds the following 2x2/s2 pool into the conv runs
``ops.q16.conv3x3_pool_q16`` (conv3x3_q16's tensor-core body with the pool in
its epilogue) in the order where the TPU kind takes the pool's max; the
orders differ once acc + 2^(shift-1) wraps:

  | TPU kind                                       | port kernel       | pool order |
  |------------------------------------------------|-------------------|------------|
  | entry_sdmm (K8), entry_sd, entry_s2d, sd_pool  | conv3x3_pool_q16  | "acc": max of the 4 accumulators, then requant |
  | entryf (K9), entry8 (K10)                      | conv3x3_pool_q16  | "acc_h": max of each horizontal pair on the accumulator, requant, max of the vertical pair |
  | conv3p2 (K11; K12 is its flat-band form) when  | conv3x3_pool_q16  | "out": requant each of the 4, then max |
  |   a 2x2/s2 pool follows                        |                   |            |
  | conv3p2 with no pool after; xla, xla8,         | conv3x3_q16 (K2)  | - (a following pool runs as its own op) |
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

The plan of a card (``resolve_knobs``), in the order of precedence of
``yolotpu``'s ``resolve_knobs``: the env lever, then the card's plan file,
then the rule above. ``YOLO2_Q16_PLAN`` wins per layer. The plan file is
``<plan_dir()>/<device_kind_slug(name)>.json`` for a CUDA device of that
name, written by ``python -m yolotpu_torch.tools.plan_search --emit-plan``;
``plan_dir()`` is ``yolotpu_torch/plans/`` unless ``YOLO2_PLAN_DIR`` names
another, never the JAX package's ``plans/``, whose files were measured on a
TPU. A file's ``plan`` ({conv idx: kind}) applies only to the network it
was measured on: the one whose ``plan_key`` the file stores (a kind that
folds a pool at one network's conv may be illegal at the same index of
another). A CUDA device with no file runs the rule and logs it once per
device name; on the CPU no file is read. ``yolotpu``'s other knobs do not
carry over. Its ``entry`` ("sd" runs a C<=4 entry conv as "entry_sd") is
a per-layer kind here (``YOLO2_Q16_PLAN="0:entry_sd"``), since the search
measures kinds per layer. ``max_hw`` and ``xla_min_c``
(``YOLO2_Q16_PALLAS_MAX_HW``, ``YOLO2_Q16_XLA_MIN_C``,
``YOLO2_Q16_XLA_DEC8``) only send a regular 3x3 to "xla" or "xla8", which
run the same ``conv3x3_q16`` here as "conv3" does (the table above): they
cannot change a launch.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

import torch

from ..graph import ConvSpec, MaxPoolSpec, NetworkSpec, RouteSpec
from ..runtime import logging as ylog

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


# ---------------------------------------------------------------------------
# The card's plan file: <plan_dir()>/<device_kind_slug(name)>.json
# ---------------------------------------------------------------------------

_warned_kinds: set[str] = set()


def device_kind_slug(kind: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", kind.lower()).strip("_")


def plan_dir() -> str:
    """The port's plans/ directory: YOLO2_PLAN_DIR overrides; the default is
    ``yolotpu_torch/plans/``."""
    env = os.environ.get("YOLO2_PLAN_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "plans")


def current_device_kind(device: torch.device | str) -> str:
    """The name a plan file is keyed by: the card's for a CUDA device,
    "cpu" for any other."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def plan_key(spec: NetworkSpec) -> str:
    """A digest of what a per-layer plan depends on: each conv's and pool's
    index, shape, stride, padding and activation, and every route's
    sources."""
    rows = []
    for l in spec.layers:
        if isinstance(l, ConvSpec):
            rows.append(("conv", l.idx, l.size, l.stride, l.pad, l.c, l.n,
                         l.h, l.w, l.activation, l.groups))
        elif isinstance(l, MaxPoolSpec):
            rows.append(("maxpool", l.idx, l.size, l.stride, l.padding, l.c,
                         l.h, l.w))
        elif isinstance(l, RouteSpec):
            rows.append(("route", l.idx, *l.layers))
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]


def load_chip_plan(device_kind: str, spec: NetworkSpec) -> dict | None:
    """The knobs of the plan file of ``device_kind`` for ``spec`` ({"plan",
    "source": the file}), or None where there is no file; the file's
    per-layer plan only where its ``plan_key`` is ``spec``'s."""
    path = os.path.join(plan_dir(), f"{device_kind_slug(device_kind)}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    plan = {int(i): k for i, k in doc.get("plan", {}).items()}
    for k in plan.values():
        if k not in ALL_KINDS:
            raise ValueError(f"{path}: unknown engine kind {k!r}")
    return {"plan": plan if doc.get("plan_key") == plan_key(spec) else {},
            "source": path}


def resolve_knobs(spec: NetworkSpec, device: torch.device | str) -> dict:
    """The plan of ``spec`` on ``device``: the env lever > the card's plan
    file > the rule (logged once per device name on a card with no
    file)."""
    kind = current_device_kind(device)
    knobs = None if kind == "cpu" else load_chip_plan(kind, spec)
    if knobs is None:
        knobs = {"plan": {}, "source": None}
        if kind != "cpu" and kind not in _warned_kinds:
            _warned_kinds.add(kind)
            ylog.info(
                f"engine_plan: no measured plan for device kind {kind!r} in "
                f"{plan_dir()}; using the default rule (run python -m "
                "yolotpu_torch.tools.plan_search --emit-plan to derive one)")
    knobs["plan"] = {**knobs["plan"], **plan_overrides()}   # env wins
    return knobs


def tier_overrides(spec: NetworkSpec, precision: str,
                   device: torch.device | str = "cpu",
                   full: NetworkSpec | None = None) -> dict[int, str] | None:
    """The overrides of a tier's model over ``spec`` on ``device``: for
    int16 the per-layer plan of ``resolve_knobs``, less a kind that folds
    the pool after ``spec``'s last layer, which ``spec`` does not hold (a
    prefix of the network ending at that conv); None for the other tiers.
    ``full`` is the network ``spec`` is a prefix of, whose plan it takes
    (``spec`` itself by default)."""
    if precision != "int16":
        return None
    knobs = resolve_knobs(spec if full is None else full, device)
    last = spec.layers[-1].idx
    return {i: k for i, k in knobs["plan"].items()
            if i != last or k not in POOL_ORDER}


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


def plan(spec: NetworkSpec,
         overrides: dict[int, str] | None = None) -> dict[int, str]:
    """conv layer idx -> kind, for every conv of the graph."""
    return {l.idx: select_engine(l, spec, overrides)
            for l in spec.conv_layers()}


def kernels(spec: NetworkSpec,
            kinds: dict[int, str]) -> dict[int, tuple[str, str | None]]:
    """conv layer idx -> (kernel, pool order) for a plan's kinds: ("mm",
    None) and ("conv3", None) for a regular 1x1 and 3x3, ("conv3_pool",
    order) where the conv also computes the 2x2/s2 pool after it, which
    then does not run, and ("conv", None) for any other conv (the kinds
    "xla", "xla8" and "nchw", the only ones ``_requirement`` lets run it);
    NotImplementedError for a conv no integer kernel runs."""
    routed = {s for l in spec.layers if isinstance(l, RouteSpec)
              for s in l.layers}
    out = {}
    for l in spec.conv_layers():
        kind = kinds[l.idx]
        order = POOL_ORDER.get(kind)
        if (order and l.idx not in routed
                and (kind != "conv3p2" or next_is_pool22(spec, l.idx))):
            out[l.idx] = ("conv3_pool", order)
        elif refusal(l):
            raise NotImplementedError(refusal(l))
        elif _regular(l) and l.size in (1, 3):
            out[l.idx] = ("mm" if l.size == 1 else "conv3", None)
        else:
            out[l.idx] = ("conv", None)
    return out
