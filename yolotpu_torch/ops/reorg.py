"""Darknet reorg as permute/reshape, in PyTorch (NHWC).

The counterpart of ``yolotpu/ops/reorg.py``: darknet applies ``reorg_cpu``
to the flat CHW buffer, and that permutation is this flat reinterpretation.
"""

from __future__ import annotations

import torch


def reorg(x: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B,H,W,C) -> (B, H//s, W//s, C*s*s), contiguous, with darknet's
    value placement."""
    b, h, w, c = x.shape
    s = stride
    oc = c // (s * s)
    chw = x.permute(0, 3, 1, 2).reshape(b, oc, h, s, w, s)
    out = chw.permute(0, 3, 5, 1, 2, 4).reshape(b, c * s * s, h // s, w // s)
    return out.permute(0, 2, 3, 1).contiguous()
