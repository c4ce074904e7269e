"""YOLOv2-family forward in PyTorch: the fp32 tier and the int16-exact, int8
(w8a8, with the head16 epilogue) and w8a16 tiers.

The counterpart of ``build_forward`` in ``yolotpu/models/yolov2.py``. The
graph walk, the Q routing (``Int16Plan``) and the parameter trees are the
JAX package's; what differs is how the convs run. Activations stay NHWC at
their exact channel width throughout (fp32, int16, or int8 in the int8
tier). In the integer tiers every conv goes through one of the tier's
kernels as ``engine_plan`` assigns it; the fp32 tier's convs are
``convops.conv_fp32`` (cuDNN on the card, TF32 off). One walk serves the
four tiers. On CPU tensors the kernels' plain versions run, so the same
module is the CPU reference. With the ``detections`` output the decode and
the class-wise NMS run too (``ops.nms``), and only a top-K table need leave
the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ..graph import (ConvSpec, MaxPoolSpec, NetworkSpec, RegionSpec,
                     ReorgSpec, RouteSpec)
from ..ops import convops, nms, pool, q16, q8, region, reorg
from ..parallel import comm
from ..parallel.mesh import tp_sharded
from ..weights import QTables, WeightStore
from . import engine_plan

# ---------------------------------------------------------------------------
# Static INT16 scale plan (graph-derived Q routing)
# ---------------------------------------------------------------------------


@dataclass
class Int16Plan:
    """Per-layer quantization routing, resolved at build time: conv
    input/output Qs, the reorg branch realignment shift, and the pending
    route Q for the conv after a concat. With per-channel weight Qs, a
    conv's ``conv_shift_out`` is an (N,) array."""

    conv_qa_in: dict[int, int] = field(default_factory=dict)
    conv_qa_out: dict[int, int] = field(default_factory=dict)
    conv_shift_out: dict[int, int] = field(default_factory=dict)
    reorg_realign: dict[int, int] = field(default_factory=dict)  # idx -> shift
    layer_q: dict[int, int] = field(default_factory=dict)        # output q per layer
    input_q: int = 0
    output_q: int = 0

    @classmethod
    def build(cls, spec: NetworkSpec, qt: QTables) -> "Int16Plan":
        plan = cls(input_q=qt.act_q[0])
        cur_q = qt.act_q[0]
        conv_i = 0
        pending: int | None = None
        for l in spec.layers:
            if isinstance(l, ConvSpec):
                qa_in = qt.act_q[conv_i] if pending is None else pending
                qa_out = qt.act_q[conv_i + 1]
                plan.conv_qa_in[l.idx] = qa_in
                plan.conv_qa_out[l.idx] = qa_out
                plan.conv_shift_out[l.idx] = qa_in + qt.weight_q[conv_i] - qa_out
                cur_q = qa_out
                conv_i += 1
                pending = None
            elif isinstance(l, ReorgSpec):
                sib_q = _sibling_route_q(spec, l.idx, plan.layer_q)
                if sib_q is not None and sib_q > 0:
                    target = min(sib_q, cur_q)
                    plan.reorg_realign[l.idx] = cur_q - target
                    cur_q = target
                    pending = cur_q
            elif isinstance(l, RouteSpec):
                if len(l.layers) == 1:
                    cur_q = plan.layer_q[l.layers[0]]
                elif pending is None:
                    cur_q = plan.layer_q[l.layers[0]]
                    pending = cur_q
                else:
                    cur_q = pending
            plan.layer_q[l.idx] = cur_q
        plan.output_q = cur_q
        return plan


def _sibling_route_q(spec: NetworkSpec, reorg_idx: int,
                     layer_q: dict[int, int]) -> int | None:
    for l in spec.layers:
        if isinstance(l, RouteSpec) and reorg_idx in l.layers and len(l.layers) > 1:
            for s in l.layers:
                if s != reorg_idx and s in layer_q:
                    return layer_q[s]
    return None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _round_shift_np(v: np.ndarray, shift) -> np.ndarray:
    """Bias shift into the layer's output Q (round-half-up, capped at 30);
    ``shift`` is an int or, for per-channel bias Qs, one per channel."""
    if np.ndim(shift) == 0:
        shift = int(shift)
        if shift > 0:
            mag = min(shift, 30)
            return (v + (1 << (mag - 1))) >> mag
        if shift < 0:
            return v << min(-shift, 30)
        return v
    s = np.clip(np.asarray(shift, np.int64), -30, 30)
    half = np.where(s > 0, np.int64(1) << np.maximum(s - 1, 0), np.int64(0))
    return np.where(s > 0, (v + half) >> np.maximum(s, 0),
                    v << np.maximum(-s, 0))


def params_fp32(spec: NetworkSpec, store: WeightStore,
                device: torch.device | str = "cpu") -> dict:
    """The fp32 tier's parameters: {"conv{idx}": {"w": HWIO fp32 weights,
    "b": fp32 bias}} as device tensors, from the store's darknet
    (n, c, k, k) weights."""
    p = {}
    for l in spec.conv_layers():
        w, b = store.fp32[l.idx]
        p[f"conv{l.idx}"] = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                             "b": b}
    return params_from_jax(p, device)


def _params_quantized(spec: NetworkSpec, wdict: dict, qt: QTables,
                      device: torch.device | str) -> dict:
    """{"conv{idx}": {"w": HWIO weights, "b": int32 bias pre-shifted into the
    layer's Qa_out domain}} as device tensors, straight from the store."""
    plan = Int16Plan.build(spec, qt)
    p = {}
    for ci, l in enumerate(spec.conv_layers()):
        w, b = wdict[l.idx]
        shift_bias = qt.bias_q[ci] - plan.conv_qa_out[l.idx]
        bias_shifted = _round_shift_np(b.astype(np.int64), shift_bias)
        p[f"conv{l.idx}"] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "b": bias_shifted.astype(np.int32),
        }
    return params_from_jax(p, device)


def params_int16(spec: NetworkSpec, store: WeightStore,
                 device: torch.device | str = "cpu") -> dict:
    """The int16 tier's parameters: int16 weights."""
    if store.qtables is None:
        raise ValueError("int16 params require Q tables")
    return _params_quantized(spec, store.int16, store.qtables, device)


def params_int8(spec: NetworkSpec, store: WeightStore,
                device: torch.device | str = "cpu") -> dict:
    """The int8 (w8a8) tier's parameters: int8 weights, per-layer or
    per-channel Qs."""
    if store.qtables8 is None:
        raise ValueError("int8 params require Q tables (quantize_weights_int8)")
    return _params_quantized(spec, store.int8, store.qtables8, device)


def params_w8a16(spec: NetworkSpec, store: WeightStore,
                 device: torch.device | str = "cpu") -> dict:
    """The w8a16 tier's parameters: per-channel int8 weights and int16-Q
    biases."""
    if store.qtables_w8 is None:
        raise ValueError("w8a16 params require Q tables "
                         "(quant.quantize_weights_w8a16)")
    return _params_quantized(spec, store.w8a16, store.qtables_w8, device)


def _bias(b) -> np.ndarray:
    """A bias as the port keeps it: fp32 for the fp32 tier, int32 for the
    integer tiers."""
    b = np.array(b)
    return b.astype(np.float32 if b.dtype.kind == "f" else np.int32)


def params_from_jax(jax_params: dict, device: torch.device | str = "cpu") -> dict:
    """Any of ``yolotpu``'s ``params_fp32``, ``params_int16``,
    ``params_int8`` and ``params_w8a16`` trees, as numpy arrays, -> the
    port's parameters: the same {"w", "b"} tree of device tensors, each
    weight in its own dtype, each bias fp32 or int32. The TPU-only entries
    (``cw``, ``wp8``) are dropped."""
    return {name: {"w": torch.from_numpy(np.array(pw["w"])).to(device),
                   "b": torch.from_numpy(_bias(pw["b"])).to(device)}
            for name, pw in jax_params.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def head_fp32(spec: NetworkSpec, params: dict, x: torch.Tensor,
              mesh=None, tally: dict | None = None) -> torch.Tensor:
    """The fp32 head of a parameter tree, differentiable: ``build_forward(
    spec, "fp32", outputs=("head",))``'s ``head``, for training. params
    {"conv{idx}": {"w": HWIO, "b"}} fp32 tensors (``params_fp32``'s tree;
    leaves that require grad get their gradients), x (B, H, W, 3) uint8 or
    float NHWC letterboxed to the network size -> (B, h, w, n*(5+C)) fp32,
    the region layer's input. The walk of ``YoloV2Q``'s fp32 tier:
    ``convops.conv_fp32`` (TF32 off, the backward too), ``pool.maxpool``
    (JAX's gradient on ties), ``reorg.reorg`` and the route concats.

    With a ``parallel.mesh.Mesh``, params are this rank's blocks
    (``shard_params``) and x its frames: each tp-sharded conv runs between
    ``comm.copy_to_tp`` and ``comm.gather_from_tp`` (their bytes added to
    ``tally``), the rest replicated over tp."""
    cur = convops.normalize_u8(x) if x.dtype == torch.uint8 else x.float()
    needed = {s for l in spec.layers if isinstance(l, RouteSpec)
              for s in l.layers}
    acts: dict[int, torch.Tensor] = {}
    for l in spec.layers:
        if isinstance(l, RegionSpec):
            return cur
        if isinstance(l, ConvSpec):
            p = params[f"conv{l.idx}"]
            sharded = mesh is not None and tp_sharded(l.n, mesh)
            if sharded:
                cur = comm.copy_to_tp(cur, mesh, tally)
            cur = convops.conv_fp32(cur, p["w"], p["b"], l.stride, l.pad,
                                    l.activation)
            if sharded:
                cur = comm.gather_from_tp(cur, mesh, tally)
        elif isinstance(l, MaxPoolSpec):
            cur = pool.maxpool(cur, l.size, l.stride, l.padding)
        elif isinstance(l, ReorgSpec):
            cur = reorg.reorg(cur, l.stride)
        elif isinstance(l, RouteSpec):
            cur = (acts[l.layers[0]] if len(l.layers) == 1 else
                   torch.cat([acts[s] for s in l.layers], dim=-1))
        if l.idx in needed:
            acts[l.idx] = cur
    return cur   # headless graph


def unfused(route: dict[int, tuple[str, str | None]]) -> dict:
    """``route`` with each conv that computes the pool after it run as
    "conv3" instead (on the same planes), so that pool runs as its own
    op."""
    return {i: ("conv3", None) if k == "conv3_pool" else (k, o)
            for i, (k, o) in route.items()}


class YoloV2Q(nn.Module):
    """The network of one precision tier ("fp32", "int16", "int8" or
    "w8a16"). ``forward(x)`` takes (B, H, W, 3) uint8 frames (normalised by
    /255 in fp32 on the device, ``convops.normalize_u8``) or float NHWC
    already letterboxed to the network size, and returns what ``outputs``
    names, as ``build_forward`` does: ``"head"``, the raw region input
    (B, h, w, oc) fp32 (dequantized in the integer tiers); ``"boxes"``, the
    decoded ``boxes``, ``obj`` and ``probs``; ``"detections"``, the top-K
    table of ``nms.topk_decode_nms`` at ``thresh``, ``nms_thresh`` and
    ``topk`` (``det_boxes``, ``det_scores``, ``det_classes``,
    ``det_valid``, ``det_saturated``); ``"acts"``, every layer's output,
    {layer idx: (B, h, w, c)}, in the tier's own dtype (int16; int8, with
    int16 for the head16 conv; fp32 in the fp32 tier and at the region
    layer, which holds the dequantized head). Under ``"acts"`` no conv
    computes its pool: a conv that folds its pool runs as its tier's
    unfused 3x3 (the same planes) and the pool as its own op, so the conv's
    own output is recorded, as ``yolotpu``'s debug build does (it falls
    back to the unfused conv for dumps). ``folded`` holds the pools a conv
    computes.

    In the int8 tier the conv feeding the region runs the head16 epilogue:
    int16 output at an 8-bits-finer scale, dequantized at ``output_q + 8``,
    on ``mm_s8``'s int16 output for a 1x1 head conv and on ``conv_s8``'s
    for any other. The int8 and w8a16 kernels take one shift per output
    channel; a per-layer shift is broadcast to that vector here, once.

    A conv that is not a regular 1x1 or 3x3/s1 (strided, another size,
    VALID or an explicit padding) runs on its tier's general conv (route
    "conv": ``conv_q16``, ``conv_s8``, ``conv_w8a16``) with the layer's
    stride and padding; its weight stays HWIO (k, k, C, N).

    On the card the weights of the integer tiers' convs, which all run on
    the tensor cores (every tier's mm, conv3 and conv, and the int16 and
    int8 tiers' convs fused with their pool), are also packed here, once
    (buffers ``p{idx}``, by ``packers``). The fp32 tier keeps each weight as a
    contiguous (Cout, k, k, Cin) tensor and hands ``conv_fp32`` its HWIO
    view, which cuDNN reads as a channels-last filter with no copy.

    Each conv's kernel is ``engine_plan.kernels``' route for the tier: the
    int16 and int8 tiers fold, by the graph, each darknet 2x2/s2 pool after
    a regular 3x3 whose own output no route reads, in
    ``engine_plan.FOLD_ORDER``'s order. ``overrides``
    ({conv idx: TPU engine kind}, the ``YOLO2_Q16_PLAN`` lever) is taken by
    the int16 tier only, as ``yolotpu`` plans only its int16 Pallas path,
    and decides each conv it names. ``full`` is the network ``spec`` is a
    prefix of (the profiler's prefixes), whose route the model takes."""

    # precision -> the conv functions of the routes (mm, conv3, conv)
    kernels = {"int16": (q16.mm_q16, q16.conv3x3_q16, q16.conv_q16),
               "int8": (q8.mm_s8, q8.conv3x3_s8, q8.conv_s8),
               "w8a16": (q8.mm_w8a16, q8.conv3x3_w8a16, q8.conv_w8a16)}
    precisions = ("fp32", *kernels)
    # precision -> the conv fused with the 2x2/s2 pool after it (int16's
    # takes the route's pool order; int8's has darknet's alone); the tiers
    # that fold are engine_plan.FOLD_ORDER's
    pooled = {"int16": q16.conv3x3_pool_q16, "int8": q8.conv3x3_pool_s8}
    # precision -> route -> what packs that route's weights for the tensor
    # cores, on the card (the kernels' planes= operand)
    packers = {"int16": {"mm": q16.pack_q16, "conv3": q16.pack_q16,
                         "conv3_pool": q16.pack_q16, "conv": q16.pack_q16},
               "int8": dict.fromkeys(("mm", "conv3", "conv3_pool", "conv"),
                                     q8.pack_s8),
               "w8a16": dict.fromkeys(("mm", "conv3", "conv"),
                                      q8.pack_w8a16)}

    def __init__(self, spec: NetworkSpec, qtables: QTables | None,
                 params: dict, device: torch.device | str = "cuda",
                 precision: str = "int16",
                 overrides: dict[int, str] | None = None,
                 outputs: tuple[str, ...] = ("head", "boxes"),
                 thresh: float = 0.25, nms_thresh: float = 0.45,
                 topk: int = 256, full: NetworkSpec | None = None):
        super().__init__()
        if precision not in self.precisions:
            raise ValueError(f"precision {precision!r} (one of "
                             f"{', '.join(self.precisions)})")
        if overrides and precision != "int16":
            raise ValueError(f"engine plan overrides {overrides} apply to the "
                             f"int16 tier only, not {precision!r}")
        if qtables is None and precision != "fp32":
            raise ValueError(f"the {precision} forward requires Q tables")
        self.spec = spec
        self.precision = precision
        self.outputs = tuple(outputs)
        self.thresh, self.nms_thresh, self.topk = thresh, nms_thresh, topk
        fp32 = precision == "fp32"
        self.plan = None if fp32 else Int16Plan.build(spec, qtables)
        self.kinds = {} if fp32 else engine_plan.plan(spec, overrides, full)
        self.route = {} if fp32 else engine_plan.kernels(
            spec, precision, overrides, full)
        if "acts" in self.outputs:
            self.route = unfused(self.route)
        region_idx = spec.region.idx if spec.region is not None else None
        head = None if region_idx is None else region_idx - 1
        if precision == "int8" and self.route.get(head, ("",))[0] == "conv3":
            # head16 writes int16: a 3x3 head conv runs on conv_s8's int16
            # output, as a head conv of any size but 1x1 does
            self.route[head] = ("conv", None)
        self.folded = {idx + 1 for idx, (k, _) in self.route.items()
                       if k == "conv3_pool"}   # pools a conv computes
        self._needed = {s for l in spec.layers if isinstance(l, RouteSpec)
                        for s in l.layers}
        if region_idx is not None:
            self.register_buffer("anchors", region.anchors(spec.region, device))
        self.head16 = None   # the conv with the head16 epilogue (int8 tier)
        for l in spec.conv_layers():
            pw = params[f"conv{l.idx}"]
            if fp32:
                self.register_buffer(f"w{l.idx}", pw["w"].to(
                    device=device, dtype=torch.float32).permute(3, 0, 1, 2)
                    .contiguous())
                self.register_buffer(f"b{l.idx}", pw["b"].to(
                    device=device, dtype=torch.float32))
                continue
            b = pw["b"].to(device=device, dtype=torch.int32)
            if precision != "int16":
                s = torch.from_numpy(np.broadcast_to(
                    np.asarray(self.plan.conv_shift_out[l.idx], np.int64),
                    (l.n,)).astype(np.int32)).to(device)
                if precision == "int8" and l.idx + 1 == region_idx:
                    self.head16 = l.idx
                    b, s = convops.head16(b, s)
                self.register_buffer(f"s{l.idx}", s)
            kernel = self.route[l.idx][0]
            w = pw["w"].to(device).contiguous()
            if kernel != "conv":   # a general conv keeps its HWIO weight
                w = q16.prep_weights(w)
            self.register_buffer(f"w{l.idx}", w)
            self.register_buffer(f"b{l.idx}", b)
            pack = self.packers[precision].get(kernel)
            if torch.device(device).type != "cpu" and pack is not None:
                self.register_buffer(f"p{l.idx}", pack(w))
        self._head_q = (None if fp32 else self.plan.output_q
                        + (8 if precision == "int8" else 0))

    def _conv(self, l: ConvSpec, x: torch.Tensor) -> torch.Tensor:
        w, b = getattr(self, f"w{l.idx}"), getattr(self, f"b{l.idx}")
        if self.plan is None:
            return convops.conv_fp32(x, w.permute(1, 2, 3, 0), b, l.stride,
                                     l.pad, l.activation)
        shift = (self.plan.conv_shift_out[l.idx] if self.precision == "int16"
                 else getattr(self, f"s{l.idx}"))
        leaky = l.activation == "leaky"
        mm, conv3, conv = self.kernels[self.precision]
        kernel, order = self.route[l.idx]
        planes = getattr(self, f"p{l.idx}", None)
        kw = {} if planes is None else {"planes": planes}
        if l.idx == self.head16:
            kw["out_dtype"] = torch.int16
        if kernel == "mm":
            bsz, h, wd, c = x.shape
            y = mm(x.reshape(-1, c), w, b, shift, leaky, **kw)
            return y.reshape(bsz, h, wd, w.shape[-1])   # a tp block's
        if kernel == "conv":
            return conv(x, w, b, shift, leaky, l.stride, l.pad, **kw)
        if kernel == "conv3_pool":
            pooled = self.pooled[self.precision]
            return (pooled(x, w, b, shift, leaky, **kw) if order is None
                    else pooled(x, w, b, shift, leaky, order, **kw))
        return conv3(x, w, b, shift, leaky, **kw)

    def _dequantize(self, x: torch.Tensor, q: int | None) -> torch.Tensor:
        return x if self.plan is None else convops.dequantize_int16(x, q)

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """Frames as the first layer takes them: uint8 /255, then the
        tier's input quantization (fp32: as they are)."""
        plan = self.plan
        if x.dtype == torch.uint8:
            x = convops.normalize_u8(x)
        if plan is None:
            return x.to(torch.float32)
        if self.precision == "int8":
            return convops.quantize_input_int8(x, plan.input_q)
        return convops.quantize_input_int16(x, plan.input_q)

    def step(self, l, cur: torch.Tensor,
             acts: dict[int, torch.Tensor]) -> torch.Tensor:
        """Layer ``l`` of the walk: its output from ``cur``, the previous
        layer's output, and ``acts``, the outputs that routes read (a pool
        that a conv computes passes ``cur`` on; the region layer
        dequantizes the head)."""
        if isinstance(l, ConvSpec):
            return self._conv(l, cur)
        if isinstance(l, MaxPoolSpec):
            return (cur if l.idx in self.folded
                    else pool.maxpool(cur, l.size, l.stride, l.padding))
        if isinstance(l, ReorgSpec):
            cur = reorg.reorg(cur, l.stride)
            sh = 0 if self.plan is None else self.plan.reorg_realign.get(l.idx, 0)
            return convops.realign_int16(cur, sh) if sh else cur
        if isinstance(l, RouteSpec):
            return (acts[l.layers[0]] if len(l.layers) == 1 else
                    torch.cat([acts[s] for s in l.layers], dim=-1))
        if isinstance(l, RegionSpec):
            return self._dequantize(cur, self._head_q)
        return cur

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> dict:
        cur = self.quantize_input(x)
        acts: dict[int, torch.Tensor] = {}
        every = {} if "acts" in self.outputs else None
        head = None
        for l in self.spec.layers:
            cur = self.step(l, cur, acts)
            if isinstance(l, RegionSpec):
                head = cur
            if l.idx in self._needed:
                acts[l.idx] = cur
            if every is not None:
                every[l.idx] = cur
        if head is None:   # headless graph
            head = self._dequantize(cur, self.plan and self.plan.output_q)
        return self.outputs_of(head, every)

    def outputs_of(self, head: torch.Tensor, every: dict | None = None) -> dict:
        """What ``outputs`` names, from the dequantized head (and, under
        ``"acts"``, every layer's output): the tail of ``forward``."""
        out = {} if every is None else {"acts": every}
        if "head" in self.outputs:
            out["head"] = head
        if self.spec.region is not None and (
                "boxes" in self.outputs or "detections" in self.outputs):
            boxes, obj, probs = region.decode_region(head, self.spec.region,
                                                     self.anchors)
            if "boxes" in self.outputs:
                out["boxes"], out["obj"], out["probs"] = boxes, obj, probs
            if "detections" in self.outputs:
                (out["det_boxes"], out["det_scores"], out["det_classes"],
                 out["det_valid"], out["det_saturated"]) = nms.topk_decode_nms(
                    boxes, obj, probs, self.thresh, self.nms_thresh, self.topk)
        return out
