"""Region-head decode (batched, fixed shapes), in PyTorch fp32.

The counterpart of ``yolotpu/ops/region.py``:

    boxes  (B, h*w*n, 4)        center format, relative to the network input
    obj    (B, h*w*n)           objectness
    probs  (B, h*w*n, classes)  class probabilities (not yet multiplied by
                                objectness or thresholded)
"""

from __future__ import annotations

import torch

from yolotpu.graph import RegionSpec


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


def decode_region(head: torch.Tensor, spec: RegionSpec):
    """head (B, h, w, n*(coords+classes+1)) fp32 raw conv output."""
    bsz, lh, lw, _ = head.shape
    n, coords, classes = spec.num, spec.coords, spec.classes
    x = head.reshape(bsz, lh, lw, n, coords + classes + 1)
    tx, ty, tw, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]

    col = torch.arange(lw, dtype=torch.float32,
                       device=head.device)[None, None, :, None]
    row = torch.arange(lh, dtype=torch.float32,
                       device=head.device)[None, :, None, None]
    biases = torch.tensor(spec.biases, dtype=torch.float32,
                          device=head.device).reshape(n, 2)

    bx = (col + torch.sigmoid(tx)) / lw
    by = (row + torch.sigmoid(ty)) / lh
    bw = torch.exp(tw) * biases[:, 0] / lw
    bh = torch.exp(th) * biases[:, 1] / lh
    obj, probs = _activate_obj_cls(x, spec)

    # darknet's detection order: cell-major, anchor-minor
    boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(bsz, lh * lw * n, 4)
    return (boxes, obj.reshape(bsz, -1),
            probs.reshape(bsz, lh * lw * n, classes))
