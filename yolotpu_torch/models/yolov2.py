"""YOLOv2-family int16-exact forward in PyTorch.

The counterpart of the int16 tier of ``yolotpu/models/yolov2.py``. The graph
walk, the Q routing (``Int16Plan``) and the parameter tree are the JAX
package's; what differs is how the convs run. Activations stay int16 NHWC at
their exact channel width throughout, and every conv goes through one of the
two kernels of ``ops.q16`` as ``engine_plan`` assigns it. On CPU tensors the
kernels' plain versions run, so the same module is the CPU reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from yolotpu.graph import (ConvSpec, MaxPoolSpec, NetworkSpec, RegionSpec,
                           ReorgSpec, RouteSpec)
from yolotpu.weights import QTables, WeightStore

from ..ops import convops, pool, q16, region, reorg
from . import engine_plan

# ---------------------------------------------------------------------------
# Static INT16 scale plan (graph-derived Q routing)
# ---------------------------------------------------------------------------


@dataclass
class Int16Plan:
    """Per-layer quantization routing, resolved at build time: conv
    input/output Qs, the reorg branch realignment shift, and the pending
    route Q for the conv after a concat."""

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

def _round_shift_np(v: np.ndarray, shift: int) -> np.ndarray:
    """Bias shift into the layer's output Q (round-half-up, capped at 30)."""
    shift = int(shift)
    if shift > 0:
        mag = min(shift, 30)
        return (v + (1 << (mag - 1))) >> mag
    if shift < 0:
        return v << min(-shift, 30)
    return v


def params_int16(spec: NetworkSpec, store: WeightStore,
                 device: torch.device | str = "cpu") -> dict:
    """{"conv{idx}": {"w": HWIO int16, "b": int32 bias pre-shifted into the
    layer's Qa_out domain}} as device tensors, straight from the store."""
    if store.qtables is None:
        raise ValueError("int16 params require Q tables")
    qt = store.qtables
    plan = Int16Plan.build(spec, qt)
    p = {}
    for ci, l in enumerate(spec.conv_layers()):
        w, b = store.int16[l.idx]
        shift_bias = qt.bias_q[ci] - plan.conv_qa_out[l.idx]
        bias_shifted = _round_shift_np(b.astype(np.int64), shift_bias)
        p[f"conv{l.idx}"] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "b": bias_shifted.astype(np.int32),
        }
    return params_from_jax(p, device)


def params_from_jax(jax_params: dict, device: torch.device | str = "cpu") -> dict:
    """``yolotpu``'s ``params_int16`` tree, as numpy arrays, -> the port's
    parameters (the same tree of device tensors)."""
    return {name: {"w": torch.from_numpy(np.array(pw["w"], np.int16)).to(device),
                   "b": torch.from_numpy(np.array(pw["b"], np.int32)).to(device)}
            for name, pw in jax_params.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

class YoloV2Int16(nn.Module):
    """The int16-exact network. ``forward(x)`` takes (B, H, W, 3) uint8
    frames (normalised by /255 in fp32 on the device) or float NHWC already
    letterboxed to the network size, and returns ``{"head", "boxes", "obj",
    "probs"}``: the dequantized raw region input (B, h, w, oc) fp32 and the
    decoded region tensors."""

    # the conv functions, by engine kind
    mm = staticmethod(q16.mm_q16)
    conv3 = staticmethod(q16.conv3x3_q16)

    def __init__(self, spec: NetworkSpec, qtables: QTables, params: dict,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.spec = spec
        self.plan = Int16Plan.build(spec, qtables)
        self.kinds = engine_plan.plan(spec)
        self._needed = {s for l in spec.layers if isinstance(l, RouteSpec)
                        for s in l.layers}
        for l in spec.conv_layers():
            pw = params[f"conv{l.idx}"]
            self.register_buffer(f"w{l.idx}", q16.prep_weights(pw["w"].to(device)))
            self.register_buffer(f"b{l.idx}",
                                 pw["b"].to(device=device, dtype=torch.int32))

    def _conv(self, l: ConvSpec, x: torch.Tensor) -> torch.Tensor:
        w, b = getattr(self, f"w{l.idx}"), getattr(self, f"b{l.idx}")
        shift = self.plan.conv_shift_out[l.idx]
        leaky = l.activation == "leaky"
        if self.kinds[l.idx] == "mm":
            bsz, h, wd, c = x.shape
            y = self.mm(x.reshape(-1, c), w, b, shift, leaky)
            return y.reshape(bsz, h, wd, l.n)
        return self.conv3(x, w, b, shift, leaky)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> dict:
        plan = self.plan
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        cur = convops.quantize_input_int16(x, plan.input_q)
        acts: dict[int, torch.Tensor] = {}
        head = None
        for l in self.spec.layers:
            if isinstance(l, ConvSpec):
                cur = self._conv(l, cur)
            elif isinstance(l, MaxPoolSpec):
                cur = pool.maxpool(cur, l.size, l.stride, l.padding)
            elif isinstance(l, ReorgSpec):
                cur = reorg.reorg(cur, l.stride)
                sh = plan.reorg_realign.get(l.idx, 0)
                if sh:
                    cur = convops.realign_int16(cur, sh)
            elif isinstance(l, RouteSpec):
                cur = (acts[l.layers[0]] if len(l.layers) == 1 else
                       torch.cat([acts[s] for s in l.layers], dim=-1))
            elif isinstance(l, RegionSpec):
                head = convops.dequantize_int16(cur, plan.output_q)
                cur = head
            if l.idx in self._needed:
                acts[l.idx] = cur
        if head is None:   # headless graph
            head = convops.dequantize_int16(cur, plan.output_q)
        out = {"head": head}
        if self.spec.region is not None:
            out["boxes"], out["obj"], out["probs"] = region.decode_region(
                head, self.spec.region)
        return out
