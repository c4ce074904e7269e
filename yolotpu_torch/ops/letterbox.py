"""On-device darknet letterbox: static-gather bilinear resize, in PyTorch.

The counterpart of ``yolotpu/ops/letterbox.py``. Darknet's separable
bilinear resize (``src/core/yolo_image.cpp:84-127``) takes at most two
source taps per output pixel, with weights fixed by the source and target
sizes. The tap tables are computed on the host with the float32 index math
of ``image.resize_image`` (numpy, cached per shape) and the resize is two
gather + lerp stages written as the same float32 expressions, each step
rounded (eager ops; a fused form would contract ``w0*a + w1*b`` into an FMA
and move the last bit). The result is bit-equal to the host
``image.letterbox_image`` and to the JAX package's ``device_letterbox``.

So a raw uint8 camera frame of any size crosses to the card as it is:
u8 -> /255 -> resize -> 0.5-gray canvas -> network, inside one captured
CUDA graph per source shape (``runtime.engine``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .convops import normalize_u8


@functools.lru_cache(maxsize=64)
def _axis_taps(dst: int, src: int, vertical: bool):
    """Static (ix0, ix1, w0, w1) tap tables for one axis (darknet edge
    rules): the horizontal last column copies the last source column; the
    vertical last row keeps only its (1-dy) term."""
    ix0 = np.zeros(dst, np.int32)
    ix1 = np.zeros(dst, np.int32)
    w0 = np.zeros(dst, np.float32)
    w1 = np.zeros(dst, np.float32)
    one = np.float32(1.0)
    if dst == 1:
        ix0[0] = ix1[0] = (0 if vertical else src - 1)
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
            w0[i] = one - d          # (1-dy) term only
            continue
        ix0[i], ix1[i] = j, min(j + 1, src - 1)
        w0[i], w1[i] = one - d, d
    return ix0, ix1, w0, w1


@functools.lru_cache(maxsize=64)
def _device_taps(dst: int, src: int, vertical: bool, device: torch.device):
    """``_axis_taps`` on ``device``: int64 indices and fp32 weights, copied
    once per shape (a first call before a graph's capture puts them there,
    as the capture cannot copy from the host)."""
    ix0, ix1, w0, w1 = _axis_taps(dst, src, vertical)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dt)
                 for a, dt in ((ix0, torch.int64), (ix1, torch.int64),
                               (w0, torch.float32), (w1, torch.float32)))


def device_letterbox(frames: torch.Tensor, net_w: int,
                     net_h: int) -> torch.Tensor:
    """(B, H, W, C) uint8 or float frames -> (B, net_h, net_w, C) f32
    letterboxed, on the frames' device.

    Integer new_w/new_h math and the 0.5-gray fill of yolo_image.cpp:148-165;
    darknet's order, horizontal pass first, then vertical."""
    b, src_h, src_w, c = frames.shape
    x = (normalize_u8(frames) if frames.dtype == torch.uint8
         else frames.to(torch.float32))
    if net_w / src_w < net_h / src_h:
        new_w = net_w
        new_h = (src_h * net_w) // src_w
    else:
        new_h = net_h
        new_w = (src_w * net_h) // src_h

    ix0, ix1, w0, w1 = _device_taps(new_w, src_w, False, x.device)
    part = (w0[:, None] * x.index_select(2, ix0)
            + w1[:, None] * x.index_select(2, ix1))
    iy0, iy1, v0, v1 = _device_taps(new_h, src_h, True, x.device)
    resized = (v0[:, None, None] * part.index_select(1, iy0)
               + v1[:, None, None] * part.index_select(1, iy1))
    canvas = torch.full((b, net_h, net_w, c), 0.5, dtype=torch.float32,
                        device=x.device)
    dy, dx = (net_h - new_h) // 2, (net_w - new_w) // 2
    canvas[:, dy:dy + new_h, dx:dx + new_w] = resized
    return canvas
