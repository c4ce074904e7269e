"""The float64 darknet of the benchmark's own code: the forward of a
network's layers, darknet's letterbox, the decode of its detection heads,
and the detector's top-K and NMS on the decoded candidates.

Written for the benchmark from darknet's published arithmetic, in plain
PyTorch (float64 tensors) and NumPy; it imports nothing of the system under
test. ``synth.py`` fits the seeded inputs with it, and the integer
references (``references/``) take its layers' plumbing, its letterbox, its
decode and its top-K and NMS.

Layers: convs (leaky or linear), maxpools, darknet's reorg, routes,
shortcuts (the previous layer's output plus the source's) and nearest
upsamples; a head, region or yolo, passes its conv's output on unchanged.
"""

from __future__ import annotations

from collections.abc import Collection

import numpy as np
import torch

from .netcfg import Layer


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
    return {s for l in layers if l.kind in ("route", "shortcut")
            for s in l.srcs}


def float_forward(layers: list[Layer], weights: dict, x: torch.Tensor,
                  every: bool = False,
                  keep: Collection[int] = ()) -> dict[int, torch.Tensor]:
    """The float64 forward of (B, H, W, 3) frames: {layer idx: output} for
    the layers routes and shortcuts read and those in ``keep``, or every
    layer. A head passes its conv's output on."""
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
        elif l.kind == "shortcut":
            cur = cur + acts[l.srcs[0]]
        elif l.kind == "upsample":   # nearest: each value s x s times
            cur = cur.repeat_interleave(l.stride, dim=1).repeat_interleave(
                l.stride, dim=2)
        if every or l.idx in need or l.idx in keep:
            acts[l.idx] = cur
    return acts



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
    anchors minor. A region: darknet's softmax region, its anchors in grid
    cells. A yolo head: darknet's ``get_yolo_box``, its anchors in the
    network's pixels (w = e^tw * anchor_w / net_w), and each class's
    probability logistic."""
    b, lh, lw, _ = head.shape
    x = head.reshape(b, lh, lw, reg.num, reg.coords + 1 + reg.classes)
    dev = head.device
    f64 = torch.float64
    col = torch.arange(lw, dtype=f64, device=dev)[None, None, :, None]
    row = torch.arange(lh, dtype=f64, device=dev)[None, :, None, None]
    anc = torch.tensor(reg.anchors, dtype=torch.float64,
                       device=dev).reshape(reg.num, 2)
    yolo = reg.kind == "yolo"
    per_h, per_w = reg.net if yolo else (lh, lw)
    boxes = torch.stack([(col + torch.sigmoid(x[..., 0])) / lw,
                         (row + torch.sigmoid(x[..., 1])) / lh,
                         torch.exp(x[..., 2]) * anc[:, 0] / per_w,
                         torch.exp(x[..., 3]) * anc[:, 1] / per_h], dim=-1)
    obj = torch.sigmoid(x[..., reg.coords])
    cls = x[..., reg.coords + 1:]
    probs = torch.sigmoid(cls) if yolo else torch.softmax(cls, dim=-1)
    n = lh * lw * reg.num
    return (boxes.reshape(b, n, 4), obj.reshape(b, n),
            probs.reshape(b, n, reg.classes))


def decode_heads(outs: list[torch.Tensor], heads: list[Layer]):
    """Every head's candidates, decoded and concatenated in layer order
    (within a head: cells row-major, anchors minor), darknet's order, which
    the top-K's stable sort keeps: boxes (B, N, 4), objectness (B, N),
    class probabilities (B, N, C)."""
    parts = [decode(o, h) for o, h in zip(outs, heads, strict=True)]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


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

