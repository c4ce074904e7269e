"""Maxpool with darknet window anchoring, in PyTorch (NHWC).

The counterpart of ``yolotpu/ops/pool.py``: windows anchor at
(r*stride, c*stride); padding goes only at the bottom/right, filled with a
value that never wins the max (-32768 for int16, -inf for floats); output
size (in + padding - size)//stride + 1. The gradient is JAX's, ties
included (a tie splits it evenly at each max taken, in JAX's order).
"""

from __future__ import annotations

import torch


def maxpool(x: torch.Tensor, size: int, stride: int,
            padding: int) -> torch.Tensor:
    """x (B,H,W,C) -> (B, (H+padding-size)//stride+1, ..., C)."""
    b, h, w, c = x.shape
    out_h = (h + padding - size) // stride + 1
    out_w = (w + padding - size) // stride + 1
    pad_h = max(0, (out_h - 1) * stride + size - h)
    pad_w = max(0, (out_w - 1) * stride + size - w)
    if pad_h or pad_w:
        neg = (float("-inf") if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        xp = x.new_full((b, h + pad_h, w + pad_w, c), neg)
        xp[:, :h, :w] = x
        x = xp
    if stride == size and not (pad_h or pad_w) and h % size == 0 \
            and w % size == 0:
        # non-overlapping windows: one reshape and a max over the window.
        # Where autograd records, the max over each window's columns and
        # then its rows, in JAX's order: the same values, but each max
        # splits the gradient evenly over its ties, so a 3-way tie gives
        # 1/4, 1/4 and 1/2 as JAX's does, where one max gives 1/3 each.
        # Serving keeps the one max: the two cost a b=8 yolov2 forward
        # about 0.14 ms more on the card
        v = x.reshape(b, out_h, size, out_w, size, c)
        if x.requires_grad and torch.is_grad_enabled():
            return v.amax(dim=4).amax(dim=2)
        return v.amax(dim=(2, 4))
    out = None
    for i in range(size):
        for j in range(size):
            v = x[:, i:i + (out_h - 1) * stride + 1:stride,
                  j:j + (out_w - 1) * stride + 1:stride]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()
