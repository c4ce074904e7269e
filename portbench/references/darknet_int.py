"""The plain reference of the darknet detectors in the integer tiers.

Written for the benchmark from darknet's and the tiers' published arithmetic,
in plain PyTorch (float64 and int64 tensors) and NumPy; it imports nothing of
the system under test and takes nothing that the system made. From the fp32
weights, the calibration image and the frames it works out again:

- calibration: a float64 forward of the calibration image; each conv's
  output scale is the largest power of two at which the layer's absolute
  maximum, times the margin, fits 16 bits; convs whose outputs one tensor
  carries or a route concatenates share the least of their scales; the
  8-bit (4-bit) tier's scales are the 16-bit ones at margin 1, less 8 (12);
- weight and bias scales (the largest power of two at which the absolute
  maximum fits the tier's width, the weight's capped so that the requant
  shift stays at most 12 (16)), rounding half away from zero, saturation;
- the letterbox (darknet's bilinear resize, the horizontal pass first, each
  float32 operation rounded, a 0.5 gray canvas) of raw frames;
- input quantization (float32 scale and clamp, rounding half away from
  zero);
- every conv as the exact integer sum over its taps (float64 products of
  integers, exact below 2^53), kept modulo 2^32, then the requant: a
  rounding (half up) right shift capped at 30, the bias pre-shifted into
  the output scale, saturation to the tier's width, the integer leaky v/10
  truncated toward zero; maxpools, darknet's reorg with its branch
  realigned by a plain right shift, routes; the head dequantized (the 8-bit
  tier's head conv written in 16 bits at a scale 8 bits finer);
- the region decode in float64, darknet's threshold rule on the top-K
  candidates by objectness, the class-wise greedy NMS, and the final table
  ordered by score.

Tiers: "int16", "int8", and "int4", the control below "int8" (4-bit
activations and weights, the head written in 16 bits at a scale 12 bits
finer).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..netcfg import Layer, convs, layers_of, region

# tier -> activation bits, weight bits, calibration margin, scale offset
# from the 16-bit scales, weight-scale cap on the requant shift, head bits
# finer than the activations
TIERS = {"int16": (16, 16, 2.0, 0, 12, 0),
         "int8": (8, 8, 1.0, 8, 16, 8),
         "int4": (4, 4, 1.0, 12, 16, 12)}


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def scale_for(absmax: float, bits: int, margin: float = 1.0) -> int:
    """The largest q in [-15, 15] with absmax * margin * 2^q at most
    2^(bits-1) - 1."""
    if absmax <= 0:
        return 15
    q = int(np.floor(np.log2(_qmax(bits) / (absmax * margin))))
    return int(np.clip(q, -15, 15))


def quantize(x: torch.Tensor, q: int, bits: int) -> torch.Tensor:
    """round(x * 2^q), half away from zero, saturated to ``bits``: float64
    integers."""
    v = x.to(torch.float64) * 2.0 ** q
    r = torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))
    return r.clamp(-_qmax(bits) - 1, _qmax(bits))


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 kept modulo 2^32, as a signed 32-bit value (still int64); a
    tensor already within 32 bits is returned as it is."""
    if not bool((v.abs() >= 1 << 31).any()):
        return v
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def round_shift(v: torch.Tensor, shift: int) -> torch.Tensor:
    """A right shift rounding half up, or a left shift; magnitude at most
    30; in 32 bits."""
    if shift > 0:
        mag = min(shift, 30)
        return wrap32(v + (1 << (mag - 1))) >> mag
    if shift < 0:
        return wrap32(v << min(-shift, 30))
    return v


# ---------------------------------------------------------------------------
# the float forward and the calibration
# ---------------------------------------------------------------------------

def _conv_sum(x: torch.Tensor, w: torch.Tensor, l: Layer) -> torch.Tensor:
    """x (B, H, W, C) against w (N, C, k, k), both float64: (B, Ho, Wo, N),
    zero padding, darknet's stride; one matrix product over the taps'
    columns (exact for integers while every sum stays below 2^53)."""
    x = x.to(torch.float64)
    if l.size > 1 or l.stride > 1:
        xp = torch.nn.functional.pad(x, (0, 0, l.pad, l.pad, l.pad, l.pad))
        s = l.stride
        x = torch.cat([xp[:, i:i + (l.out_h - 1) * s + 1:s,
                          j:j + (l.out_w - 1) * s + 1:s]
                       for i in range(l.size) for j in range(l.size)], dim=-1)
    return x @ w.permute(2, 3, 1, 0).reshape(-1, l.out_c)


def _maxpool(x: torch.Tensor, l: Layer, fill) -> torch.Tensor:
    b, h, w, c = x.shape
    need_h = (l.out_h - 1) * l.stride + l.size
    need_w = (l.out_w - 1) * l.stride + l.size
    xp = x.new_full((b, max(h, need_h), max(w, need_w), c), fill)
    xp[:, :h, :w] = x
    out = None
    for i in range(l.size):
        for j in range(l.size):
            v = xp[:, i:i + (l.out_h - 1) * l.stride + 1:l.stride,
                   j:j + (l.out_w - 1) * l.stride + 1:l.stride]
            out = v if out is None else torch.maximum(out, v)
    return out


def _reorg(x: torch.Tensor, s: int) -> torch.Tensor:
    """darknet's reorg, NHWC: its flat CHW buffer read as (C/s^2, H*s,
    W*s)."""
    b, h, w, c = x.shape
    chw = x.permute(0, 3, 1, 2).reshape(b, c // (s * s), h, s, w, s)
    out = chw.permute(0, 3, 5, 1, 2, 4).reshape(b, c * s * s, h // s, w // s)
    return out.permute(0, 2, 3, 1)


def _needed(layers: list[Layer]) -> set[int]:
    return {s for l in layers if l.kind == "route" for s in l.srcs}


def float_forward(layers: list[Layer], weights: dict, x: torch.Tensor,
                  every: bool = False) -> dict[int, torch.Tensor]:
    """The float64 forward of (B, H, W, 3) frames: {layer idx: output} for
    the layers routes read, or every layer."""
    dev = x.device
    need = _needed(layers)
    acts, cur = {}, x.to(torch.float64)
    for l in layers:
        if l.kind == "conv":
            w, b = weights[l.idx]
            cur = _conv_sum(cur, torch.from_numpy(w).to(dev, torch.float64),
                            l)
            cur = cur + torch.from_numpy(b).to(dev, torch.float64)
            if l.leaky:
                cur = torch.where(cur > 0, cur, 0.1 * cur)
        elif l.kind == "maxpool":
            cur = _maxpool(cur, l, float("-inf"))
        elif l.kind == "reorg":
            cur = _reorg(cur, l.stride)
        elif l.kind == "route":
            cur = torch.cat([acts[s] for s in l.srcs], dim=-1)
        if every or l.idx in need:
            acts[l.idx] = cur
    return acts


def _producer(layers: list[Layer], idx: int) -> int:
    """The conv whose output scale the tensor of layer idx carries (through
    pools, reorgs and one-source routes); a many-source route is its own;
    -1 for the network's input."""
    while idx >= 0:
        l = layers[idx]
        if l.kind == "conv":
            return idx
        if l.kind == "route":
            if len(l.srcs) != 1:
                return idx
            idx = l.srcs[0]
        else:
            idx -= 1
    return -1


def calibrate(layers: list[Layer], weights: dict, image: np.ndarray,
              margin: float, device: torch.device) -> list[int]:
    """The activation scales, one per conv input and the last conv's output,
    from one calibration image (3, H, W) in [0, 1]."""
    x = torch.from_numpy(image).to(device).permute(1, 2, 0)[None]
    acts = float_forward(layers, weights, x, every=True)
    absmax = {i: float(a.abs().max()) for i, a in acts.items()}
    absmax_in = float(np.abs(image).max())
    cs = convs(layers)
    nat = {l.idx: scale_for(absmax[l.idx], 16, margin) for l in cs}
    parent = {l.idx: l.idx for l in cs}

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def join(a: int, b: int) -> None:
        if a >= 0 and b >= 0:
            parent[find(a)] = find(b)

    for i in range(len(cs) - 1):
        prod = _producer(layers, cs[i + 1].idx - 1)
        if prod >= 0 and layers[prod].kind != "route":
            join(cs[i].idx, prod)
    for l in layers:
        if l.kind == "route" and len(l.srcs) > 1:
            prods = [p for p in (_producer(layers, s) for s in l.srcs)
                     if p >= 0 and layers[p].kind == "conv"]
            for p in prods[1:]:
                join(prods[0], p)
    group: dict[int, int] = {}
    for l in cs:
        group[find(l.idx)] = min(group.get(find(l.idx), 99), nat[l.idx])
    q_in = scale_for(absmax_in, 16, margin)
    out_q: dict[int, int] = {}
    for l in layers:
        if l.kind == "conv":
            out_q[l.idx] = group[find(l.idx)]
        elif l.kind == "route":
            out_q[l.idx] = min(out_q[s] for s in l.srcs)
        else:
            out_q[l.idx] = out_q[l.idx - 1] if l.idx > 0 else q_in
    act_q = [out_q[l.idx - 1] if l.idx > 0 else q_in for l in cs]
    return act_q + [out_q[cs[-1].idx]]


# ---------------------------------------------------------------------------
# the integer forward
# ---------------------------------------------------------------------------

class IntNet:
    """One tier's integer network from fp32 weights and a calibration
    image: scales, quantized weights and pre-shifted biases, and the scale
    routing of every layer."""

    def __init__(self, layers: list[Layer], weights: dict, calib: np.ndarray,
                 tier: str, device: torch.device):
        abits, wbits, margin, offset, cap, head_extra = TIERS[tier]
        self.layers, self.device, self.abits = layers, device, abits
        act_q = [q - offset for q in
                 calibrate(layers, weights, calib, margin, device)]
        head = region(layers).idx - 1
        self.params, self.shift = {}, {}
        wq = {}
        for ci, l in enumerate(convs(layers)):
            w, b = weights[l.idx]
            w = torch.from_numpy(w).to(device, torch.float64)
            qw = min(scale_for(float(w.abs().max()), wbits),
                     cap - act_q[ci] + act_q[ci + 1])
            qb = scale_for(float(np.abs(b).max()) if b.size else 1.0, wbits)
            wq[l.idx] = qw
            # the bias pre-shifted into the conv's output scale, in 32 bits
            bias = round_shift(quantize(torch.from_numpy(b), qb, wbits)
                               .to(torch.int64), qb - act_q[ci + 1])
            if l.idx == head:
                bias = wrap32(bias << head_extra)
            self.params[l.idx] = (quantize(w, qw, wbits), bias.to(device))
        # the scale routing: each conv's input and output scale, the reorg
        # branch's realignment, the pending scale after a concat
        self.realign: dict[int, int] = {}
        layer_q: dict[int, int] = {}
        cur_q, ci, pending = act_q[0], 0, None
        self.input_q = act_q[0]
        for l in layers:
            if l.kind == "conv":
                qa_in = act_q[ci] if pending is None else pending
                qa_out = act_q[ci + 1]
                self.shift[l.idx] = (qa_in + wq[l.idx] - qa_out
                                     - (head_extra if l.idx == head else 0))
                cur_q, ci, pending = qa_out, ci + 1, None
            elif l.kind == "reorg":
                sib = self._sibling_q(l.idx, layer_q)
                if sib is not None and sib > 0:
                    target = min(sib, cur_q)
                    self.realign[l.idx] = cur_q - target
                    cur_q = pending = target
            elif l.kind == "route":
                if len(l.srcs) == 1 or pending is None:
                    cur_q = layer_q[l.srcs[0]]
                    if len(l.srcs) > 1:
                        pending = cur_q
                else:
                    cur_q = pending
            layer_q[l.idx] = cur_q
        self.head, self.head_extra = head, head_extra
        self.head_q = cur_q + head_extra

    def _sibling_q(self, reorg_idx: int, layer_q: dict) -> int | None:
        for l in self.layers:
            if l.kind == "route" and reorg_idx in l.srcs and len(l.srcs) > 1:
                for s in l.srcs:
                    if s != reorg_idx and s in layer_q:
                        return layer_q[s]
        return None

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """float32 frames in [0, 1] -> the first conv's integers (int64):
        the float32 scale and clamp, then rounding half away from zero."""
        lim = float(_qmax(self.abits))
        v = (x.to(torch.float32) * (2.0 ** self.input_q)).clamp(-lim - 1, lim)
        return torch.where(v >= 0, torch.floor(v + 0.5),
                           torch.ceil(v - 0.5)).to(torch.int32)

    def conv(self, l: Layer, x: torch.Tensor) -> torch.Tensor:
        w, bias = self.params[l.idx]
        acc = wrap32(_conv_sum(x, w, l).to(torch.int64))
        bits = 16 if l.idx == self.head and self.head_extra else self.abits
        lo, hi = -_qmax(bits) - 1, _qmax(bits)
        v = wrap32(round_shift(acc, self.shift[l.idx]) + bias).clamp(lo, hi)
        if l.leaky:
            v = torch.where(v < 0, torch.div(v, 10, rounding_mode="trunc"),
                            v).clamp(lo, hi)
        return v.to(torch.int32)

    def head_of(self, x: torch.Tensor) -> torch.Tensor:
        """float32 (B, H, W, 3) frames in [0, 1] -> the dequantized head
        (B, h, w, n * (5 + classes)), float64."""
        need = _needed(self.layers)
        lim = _qmax(self.abits)
        acts, cur = {}, self.quantize_input(x)
        for l in self.layers:
            if l.kind == "conv":
                cur = self.conv(l, cur)
            elif l.kind == "maxpool":
                cur = _maxpool(cur, l, -1 << 31)
            elif l.kind == "reorg":
                cur = _reorg(cur, l.stride)
                sh = self.realign.get(l.idx, 0)
                if sh:
                    cur = (cur >> sh).clamp(-lim - 1, lim)
            elif l.kind == "route":
                cur = torch.cat([acts[s] for s in l.srcs], dim=-1)
            elif l.kind == "region":
                return cur.to(torch.float64) * 2.0 ** (-self.head_q)
            if l.idx in need:
                acts[l.idx] = cur
        raise ValueError("no region layer")


# ---------------------------------------------------------------------------
# letterbox, decode, top-K and NMS
# ---------------------------------------------------------------------------

def _taps(dst: int, src: int, vertical: bool):
    """darknet's bilinear taps of one axis, in float32: the last column
    copies the last source column; the last row keeps its (1 - dy) term."""
    ix0, ix1 = np.zeros(dst, np.int64), np.zeros(dst, np.int64)
    w0, w1 = np.zeros(dst, np.float32), np.zeros(dst, np.float32)
    one = np.float32(1.0)
    if dst == 1:
        ix0[0] = ix1[0] = 0 if vertical else src - 1
        w0[0] = one
        return ix0, ix1, w0, w1
    scale = np.float32(src - 1) / np.float32(dst - 1)
    for i in range(dst):
        if not vertical and (i == dst - 1 or src == 1):
            ix0[i] = ix1[i] = src - 1
            w0[i] = one
            continue
        s = np.float32(np.float32(i) * scale)
        j = int(s)
        d = np.float32(s - np.float32(j))
        if vertical and (i == dst - 1 or src == 1):
            ix0[i] = ix1[i] = min(j, src - 1)
            w0[i] = one - d
            continue
        ix0[i], ix1[i] = j, min(j + 1, src - 1)
        w0[i], w1[i] = one - d, d
    return ix0, ix1, w0, w1


def to_unit(frames: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 / 255, a true division (by a tensor: PyTorch's
    CUDA division by a Python number multiplies by its reciprocal)."""
    return frames.to(torch.float32) / torch.full((), 255.0,
                                                 device=frames.device)


def letterbox(frames: torch.Tensor, net_w: int, net_h: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 raw frames -> (B, net_h, net_w, 3) float32,
    darknet's letterbox: /255, the resize keeping the aspect ratio, a 0.5
    canvas. Each float32 product and sum is its own operation, rounded."""
    x = to_unit(frames)
    b, src_h, src_w, c = x.shape
    if net_w / src_w < net_h / src_h:
        new_w, new_h = net_w, (src_h * net_w) // src_w
    else:
        new_h, new_w = net_h, (src_w * net_h) // src_h
    dev = x.device
    ix0, ix1, w0, w1 = (torch.from_numpy(t).to(dev)
                        for t in _taps(new_w, src_w, False))
    part = w0[:, None] * x[:, :, ix0] + w1[:, None] * x[:, :, ix1]
    iy0, iy1, v0, v1 = (torch.from_numpy(t).to(dev)
                        for t in _taps(new_h, src_h, True))
    resized = (v0[:, None, None] * part[:, iy0]
               + v1[:, None, None] * part[:, iy1])
    canvas = torch.full((b, net_h, net_w, c), 0.5, dtype=torch.float32,
                        device=dev)
    dy, dx = (net_h - new_h) // 2, (net_w - new_w) // 2
    canvas[:, dy:dy + new_h, dx:dx + new_w] = resized
    return canvas


def decode(head: torch.Tensor, reg: Layer):
    """(B, h, w, n * (5 + C)) float64 -> boxes (B, N, 4) center format,
    objectness (B, N), class probabilities (B, N, C); cells row-major,
    anchors minor."""
    b, lh, lw, _ = head.shape
    x = head.reshape(b, lh, lw, reg.num, reg.coords + 1 + reg.classes)
    dev = head.device
    f64 = torch.float64
    col = torch.arange(lw, dtype=f64, device=dev)[None, None, :, None]
    row = torch.arange(lh, dtype=f64, device=dev)[None, :, None, None]
    anc = torch.tensor(reg.anchors, dtype=torch.float64,
                       device=dev).reshape(reg.num, 2)
    boxes = torch.stack([(col + torch.sigmoid(x[..., 0])) / lw,
                         (row + torch.sigmoid(x[..., 1])) / lh,
                         torch.exp(x[..., 2]) * anc[:, 0] / lw,
                         torch.exp(x[..., 3]) * anc[:, 1] / lh], dim=-1)
    obj = torch.sigmoid(x[..., reg.coords])
    probs = torch.softmax(x[..., reg.coords + 1:], dim=-1)
    n = lh * lw * reg.num
    return (boxes.reshape(b, n, 4), obj.reshape(b, n),
            probs.reshape(b, n, reg.classes))


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax0, ay0 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax1, ay1 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.clip(np.minimum(ax1[:, None], bx1) - np.maximum(ax0[:, None], bx0),
                 0, None)
    ih = np.clip(np.minimum(ay1[:, None], by1) - np.maximum(ay0[:, None], by0),
                 0, None)
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + b[:, 2] * b[:, 3] - inter
    return inter / np.maximum(union, 1e-12)


def detections(boxes: np.ndarray, obj: np.ndarray, probs: np.ndarray,
               thresh: float, nms: float, topk: int):
    """One frame's valid detections as the top-K table holds them, in its
    order: darknet's threshold rule on the top-K candidates by objectness
    (a stable descending sort), each class's greedy NMS (IoU > nms
    suppresses), each box's best class, kept where its score > thresh.
    Returns boxes (D, 4), scores (D,), classes (D,)."""
    k = min(topk, obj.shape[0])
    gated = np.where(obj > thresh, obj, 0.0)
    idx = np.argsort(-gated, kind="stable")[:k]
    cboxes = boxes[idx]
    cprob = probs[idx] * gated[idx][:, None]
    cprob = np.where(cprob > thresh, cprob, 0.0)
    live = np.flatnonzero(cprob.any(axis=1))
    out = np.zeros_like(cprob)
    if live.size:
        iou = _iou(cboxes[live], cboxes[live])
        for c in np.flatnonzero(cprob[live].any(axis=0)):
            s = cprob[live, c]
            kept: list[int] = []
            for i in np.argsort(-s, kind="stable"):
                if s[i] <= 0:
                    break
                if not any(iou[j, i] > nms for j in kept):
                    kept.append(i)
            out[live[kept], c] = s[kept]
    best_c = out.argmax(axis=1)
    best_p = out[np.arange(k), best_c]
    order = np.argsort(-best_p, kind="stable")
    order = order[best_p[order] > thresh]
    return cboxes[order], best_p[order], best_c[order]


class Reference:
    """A configuration's detector in one tier, from the run's inputs: the
    valid detections of frames as the system's top-K tables hold them."""

    def __init__(self, config: dict, weights: dict, calib: np.ndarray,
                 tier: str, device: torch.device):
        self.layers = layers_of(config)
        self.reg = region(self.layers)
        self.engine = config["engine"]
        self.net = IntNet(self.layers, weights, calib, tier, device)
        self.device = device
        self.seconds = {"heads": 0.0, "tables": 0.0}

    def detect(self, frames: np.ndarray, raw: bool, block: int = 32) -> list:
        """(B, H, W, 3) uint8 frames (raw: any size, letterboxed here; else
        the network's size) -> per frame (boxes, scores, classes)."""
        net_h, net_w = self.layers[0].h, self.layers[0].w
        out = []
        for i in range(0, len(frames), block):
            t0 = time.perf_counter()
            part = torch.from_numpy(frames[i:i + block]).to(self.device)
            x = letterbox(part, net_w, net_h) if raw else to_unit(part)
            head = self.net.head_of(x)
            boxes, obj, probs = (t.cpu().numpy() for t in
                                 decode(head, self.reg))
            t1 = time.perf_counter()
            e = self.engine
            out += [detections(boxes[f], obj[f], probs[f], e["thresh"],
                               e["nms"], e["topk"]) for f in range(len(part))]
            self.seconds["heads"] += t1 - t0
            self.seconds["tables"] += time.perf_counter() - t1
        return out
