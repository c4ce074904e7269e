"""Region-head activation, box decode and correction, and class-wise NMS
(numpy host path).

Behavioral targets (reference):
- ``forward_region_layer``    src/core/yolo_region.cpp:123-141
  (logistic on x,y and objectness; softmax over classes from the *raw* input)
- ``correct_region_boxes``    yolo_region.cpp:28-53 (letterbox inverse,
  integer new_w/new_h math)
- ``get_region_detections``   yolo_region.cpp:169-195
- ``do_nms_sort``             src/core/yolo_post.cpp:54-85 (objectness
  compaction, per-class stable-by-score sort, greedy IoU suppression)

Tensor layout for the head is darknet CHW flat: per anchor n the entries are
[x, y, w, h, obj, class0..classN) each as a (h*w,) plane
(``entry_index``, yolo_region.cpp:11-16).

Mirrors ``yolotpu/postprocess.py`` (only what the port uses); the port keeps
its own copy and imports nothing of ``yolotpu``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import RegionSpec


@dataclass
class Detection:
    # box is center-format, relative to original image (x, y, w, h)
    bbox: tuple[float, float, float, float]
    objectness: float
    prob: np.ndarray          # (classes,) class probabilities (post-threshold)
    classes: int = 0
    sort_class: int = -1

    def best_class(self) -> tuple[int, float]:
        j = int(np.argmax(self.prob))
        return j, float(self.prob[j])


def logistic(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def forward_region(raw_chw_flat: np.ndarray, spec: RegionSpec) -> np.ndarray:
    """Apply region-layer activations; input/output are flat CHW fp32.

    Mirrors forward_region_layer: logistic on the x,y planes and the
    objectness plane; softmax over classes computed from the RAW input
    (the softmax source is ``net_input``, not the partially-activated
    output — yolo_region.cpp:135-139).
    """
    lw, lh, n = spec.w, spec.h, spec.num
    coords, classes = spec.coords, spec.classes
    stride = lw * lh
    per_anchor = (coords + classes + 1) * stride
    out = raw_chw_flat.astype(np.float32).copy()
    for a in range(n):
        base = a * per_anchor
        out[base:base + 2 * stride] = logistic(out[base:base + 2 * stride])
        if not spec.background:
            ob = base + coords * stride
            out[ob:ob + stride] = logistic(out[ob:ob + stride])
    if spec.softmax:
        src = raw_chw_flat.reshape(n, coords + classes + 1, stride)
        cls = src[:, coords + (0 if spec.background else 1):, :].astype(np.float64)
        m = cls.max(axis=1, keepdims=True)
        e = np.exp(cls - m)
        sm = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
        o = out.reshape(n, coords + classes + 1, stride)
        o[:, coords + (0 if spec.background else 1):, :] = sm
        out = o.reshape(-1)
    return out


def correct_region_boxes(boxes: np.ndarray, im_w: int, im_h: int,
                         net_w: int, net_h: int, relative: bool = True) -> np.ndarray:
    """Inverse letterbox mapping (yolo_region.cpp:28-53). boxes (N,4) xywh."""
    if net_w / im_w < net_h / im_h:
        new_w = net_w
        new_h = (im_h * net_w) // im_w
    else:
        new_h = net_h
        new_w = (im_w * net_h) // im_h
    b = boxes.astype(np.float64).copy()
    b[:, 0] = (b[:, 0] - (net_w - new_w) / 2.0 / net_w) / (new_w / net_w)
    b[:, 1] = (b[:, 1] - (net_h - new_h) / 2.0 / net_h) / (new_h / net_h)
    b[:, 2] *= net_w / new_w
    b[:, 3] *= net_h / new_h
    if not relative:
        b[:, [0, 2]] *= im_w
        b[:, [1, 3]] *= im_h
    return b.astype(np.float32)


def get_region_detections(activated: np.ndarray, spec: RegionSpec,
                          im_w: int, im_h: int, net_w: int, net_h: int,
                          thresh: float, relative: bool = True) -> list[Detection]:
    """Decode all h*w*n candidate boxes (yolo_region.cpp:169-195).

    Note the reference allocates l.w*l.h*l.n detections but only fills ones
    above threshold and box-corrects just those; we return the filled list.
    """
    lw, lh, n = spec.w, spec.h, spec.num
    coords, classes = spec.coords, spec.classes
    stride = lw * lh
    x = activated.reshape(n, coords + classes + 1, stride)
    biases = np.asarray(spec.biases, np.float32)

    # vectorized decode over all (cell, anchor) pairs, iterated in darknet's
    # order (cell-major, anchor-minor) for identical NMS tie-breaking
    obj = x[:, coords, :]                               # (n, stride)
    keep_a, keep_i = np.nonzero(obj > thresh)
    order = np.argsort(keep_i * n + keep_a, kind="stable")
    keep_a, keep_i = keep_a[order], keep_i[order]
    if keep_a.size == 0:
        return []
    col = (keep_i % lw).astype(np.float32)
    row = (keep_i // lw).astype(np.float32)
    bx = (col + x[keep_a, 0, keep_i]) / lw
    by = (row + x[keep_a, 1, keep_i]) / lh
    bw = np.exp(x[keep_a, 2, keep_i]) * biases[2 * keep_a] / lw
    bh = np.exp(x[keep_a, 3, keep_i]) * biases[2 * keep_a + 1] / lh
    objs = obj[keep_a, keep_i]
    probs = objs[:, None] * x[keep_a, coords + 1:, keep_i]
    probs = np.where(probs > thresh, probs, 0.0).astype(np.float32)
    corrected = correct_region_boxes(
        np.stack([bx, by, bw, bh], axis=1).astype(np.float32),
        im_w, im_h, net_w, net_h, relative)
    return [Detection(bbox=tuple(float(v) for v in corrected[k]),
                      objectness=float(objs[k]), prob=probs[k],
                      classes=classes)
            for k in range(keep_a.size)]


def box_iou(a, b) -> float:
    def overlap(x1, w1, x2, w2):
        l1, l2 = x1 - w1 / 2, x2 - w2 / 2
        r1, r2 = x1 + w1 / 2, x2 + w2 / 2
        return min(r1, r2) - max(l1, l2)

    w = overlap(a[0], a[2], b[0], b[2])
    h = overlap(a[1], a[3], b[1], b[3])
    if w < 0 or h < 0:
        return 0.0
    inter = w * h
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union else 0.0


def do_nms_sort(dets: list[Detection], classes: int, thresh: float) -> list[Detection]:
    """Class-wise greedy NMS, exactly do_nms_sort (yolo_post.cpp:54-85):
    compact zero-objectness entries away, then per class sort by that class's
    prob (descending) and zero the prob of any lower box with IoU > thresh.

    Vectorized: one IoU matrix over all surviving boxes, then per class a
    sequential greedy pass whose suppression step is a numpy row operation
    (identical results to the reference's scalar pair loops).
    """
    dets = [d for d in dets if d.objectness != 0]
    n = len(dets)
    if n == 0:
        return dets
    boxes = np.asarray([d.bbox for d in dets], np.float32)
    probs = np.stack([d.prob for d in dets])          # (n, classes)
    for k in range(classes):
        # only boxes with a nonzero class-k prob can suppress or be
        # suppressed (zero-prob boxes are skipped by both loops in the
        # reference); restrict the quadratic work to those candidates
        cand = np.nonzero(probs[:, k] > 0)[0]
        if cand.size <= 1:
            continue
        order = cand[np.argsort(-probs[cand, k], kind="stable")]
        pk = probs[order, k].copy()
        iou_o = _iou_matrix(boxes[order])
        for i in range(order.size):
            if pk[i] == 0:
                continue
            pk[i + 1:][iou_o[i, i + 1:] > thresh] = 0
        probs[order, k] = pk
    for d, p in zip(dets, probs):
        d.prob = p.astype(np.float32)
    return dets


def _iou_matrix(b: np.ndarray) -> np.ndarray:
    x0, y0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    x1, y1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.minimum(x1[:, None], x1) - np.maximum(x0[:, None], x0)
    ih = np.minimum(y1[:, None], y1) - np.maximum(y0[:, None], y0)
    inter = np.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    union = (b[:, 2] * b[:, 3])[:, None] + b[:, 2] * b[:, 3] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union != 0, inter / union, 0.0)
    return out.astype(np.float32)
