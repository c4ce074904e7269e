"""Region-head decode (batched, fixed shapes), in PyTorch fp32.

The counterpart of ``yolotpu/ops/region.py``:

    boxes  (B, h*w*n, 4)        center format, relative to the network input
    obj    (B, h*w*n)           objectness
    probs  (B, h*w*n, classes)  class probabilities (not yet multiplied by
                                objectness or thresholded)
"""

from __future__ import annotations

import torch

from ..graph import RegionSpec


def _activate_obj_cls(x: torch.Tensor, spec: RegionSpec):
    """Objectness and class activation honouring the cfg's ``softmax`` and
    ``background`` options as darknet's ``forward_region_layer`` does: obj
    is logistic unless background=1; the softmax (when softmax=1) runs over
    the classes (and the background entry) from the raw tensor."""
    coords = spec.coords
    tobj = x[..., coords]
    if spec.background:
        if spec.softmax:
            sm = torch.softmax(x[..., coords:], dim=-1)
            return sm[..., 0], sm[..., 1:]
        return tobj, x[..., coords + 1:]
    obj = torch.sigmoid(tobj)
    tcls = x[..., coords + 1:]
    probs = torch.softmax(tcls, dim=-1) if spec.softmax else tcls
    return obj, probs


def anchors(spec: RegionSpec, device: torch.device | str = "cpu") -> torch.Tensor:
    """The region's anchor (w, h) pairs, (n, 2) fp32 on ``device``: made
    once, at model build, since a copy from the host cannot run inside a
    captured CUDA graph."""
    return torch.tensor(spec.biases, dtype=torch.float32,
                        device=device).reshape(spec.num, 2)


def decode_region(head: torch.Tensor, spec: RegionSpec, biases: torch.Tensor):
    """head (B, h, w, n*(coords+classes+1)) fp32 raw conv output; biases the
    region's ``anchors`` on head's device."""
    bsz, lh, lw, _ = head.shape
    n, coords, classes = spec.num, spec.coords, spec.classes
    x = head.reshape(bsz, lh, lw, n, coords + classes + 1)
    tx, ty, tw, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]

    col = torch.arange(lw, dtype=torch.float32,
                       device=head.device)[None, None, :, None]
    row = torch.arange(lh, dtype=torch.float32,
                       device=head.device)[None, :, None, None]

    bx = (col + torch.sigmoid(tx)) / lw
    by = (row + torch.sigmoid(ty)) / lh
    bw = torch.exp(tw) * biases[:, 0] / lw
    bh = torch.exp(th) * biases[:, 1] / lh
    obj, probs = _activate_obj_cls(x, spec)

    # darknet's detection order: cell-major, anchor-minor
    boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(bsz, lh * lw * n, 4)
    return (boxes, obj.reshape(bsz, -1),
            probs.reshape(bsz, lh * lw * n, classes))


def activated_head(head: torch.Tensor, spec: RegionSpec) -> torch.Tensor:
    """forward_region_layer equivalent: the full activated tensor in NHWC
    (sigmoid x/y/obj, softmax classes, w/h raw), for dump parity."""
    bsz, lh, lw, _ = head.shape
    n, coords, classes = spec.num, spec.coords, spec.classes
    x = head.reshape(bsz, lh, lw, n, coords + classes + 1)
    xy = torch.sigmoid(x[..., :2])
    wh = x[..., 2:coords]
    obj, cls = _activate_obj_cls(x, spec)
    out = torch.cat([xy, wh, obj[..., None], cls], dim=-1)
    return out.reshape(bsz, lh, lw, n * (coords + classes + 1))
