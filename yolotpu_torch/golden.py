"""Pure-numpy fp32 forward (darknet semantics), the activation statistics
that calibration (``quant.calibrate_activations``) reads. All tensors are
CHW (darknet layout) numpy arrays.

Mirrors ``yolotpu/golden.py`` (only what the port uses); the port keeps
its own copy and imports nothing of ``yolotpu``.
"""

from __future__ import annotations

import numpy as np

from .graph import (ConvSpec, MaxPoolSpec, NetworkSpec, RegionSpec,
                    ReorgSpec, RouteSpec)


def activate_fp32(x: np.ndarray, activation: str) -> np.ndarray:
    if activation == "linear":
        return x
    if activation == "leaky":
        return np.where(x > 0, x, 0.1 * x).astype(np.float32)
    if activation == "relu":
        return np.maximum(x, 0).astype(np.float32)
    if activation == "logistic":
        return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    if activation == "tanh":
        return np.tanh(x).astype(np.float32)
    if activation == "elu":
        return np.where(x >= 0, x, np.expm1(x)).astype(np.float32)
    if activation == "ramp":
        return (x * (x > 0) + 0.1 * x).astype(np.float32)
    if activation == "relie":
        return np.where(x > 0, x, 0.01 * x).astype(np.float32)
    if activation == "loggy":
        return (2.0 / (1.0 + np.exp(-x)) - 1.0).astype(np.float32)
    if activation == "plse":
        # piecewise-linear sigmoid-ish (yolo_math.cpp plse_activate)
        return np.where(x < -4, 0.01 * (x + 4),
                        np.where(x > 4, 0.01 * (x - 4) + 1,
                                 0.125 * x + 0.5)).astype(np.float32)
    if activation == "stair":
        # int n = floor(x); n%2==0 ? floor(x/2) : (x-n) + floor(x/2)
        # (C remainder: negative odd n gives n%2 == -1, i.e. the else branch)
        nf = np.floor(x)
        half = np.floor(x / 2.0)
        return np.where(np.fmod(nf, 2.0) == 0, half,
                        (x - nf) + half).astype(np.float32)
    if activation == "hardtan":
        return np.clip(x, -1.0, 1.0).astype(np.float32)
    if activation == "lhtan":
        return np.where(x < 0, 0.001 * x,
                        np.where(x > 1, 0.001 * (x - 1) + 1, x)
                        ).astype(np.float32)
    raise NotImplementedError(f"activation {activation}")


def im2col(x: np.ndarray, size: int, stride: int, pad: int) -> np.ndarray:
    """CHW image -> (c*size*size, out_h*out_w) column matrix, zero padded."""
    c, h, w = x.shape
    out_h = (h + 2 * pad - size) // stride + 1
    out_w = (w + 2 * pad - size) // stride + 1
    xp = np.zeros((c, h + 2 * pad, w + 2 * pad), dtype=x.dtype)
    xp[:, pad:pad + h, pad:pad + w] = x
    cols = np.empty((c, size, size, out_h, out_w), dtype=x.dtype)
    for i in range(size):
        for j in range(size):
            cols[:, i, j] = xp[:, i:i + out_h * stride:stride,
                               j:j + out_w * stride:stride]
    return cols.reshape(c * size * size, out_h * out_w)


def conv_fp32(x: np.ndarray, weights: np.ndarray, bias: np.ndarray,
              spec: ConvSpec) -> np.ndarray:
    """Darknet conv: weights (n, c, k, k), x CHW, zero padding, bias add."""
    cols = im2col(x, spec.size, spec.stride, spec.pad)
    wmat = weights.reshape(spec.n, -1).astype(np.float32)
    out = wmat @ cols.astype(np.float32)
    out += bias.reshape(-1, 1).astype(np.float32)
    out = out.reshape(spec.n, spec.out_h, spec.out_w)
    return activate_fp32(out, spec.activation)


def maxpool(x: np.ndarray, spec: MaxPoolSpec, pad_value: float) -> np.ndarray:
    """Windows anchored at (r*stride, c*stride); bottom/right padding only."""
    c, h, w = x.shape
    size, stride = spec.size, spec.stride
    out_h, out_w = spec.out_h, spec.out_w
    need_h = (out_h - 1) * stride + size
    need_w = (out_w - 1) * stride + size
    xp = np.full((c, max(h, need_h), max(w, need_w)), pad_value, dtype=x.dtype)
    xp[:, :h, :w] = x
    out = np.full((c, out_h, out_w), pad_value, dtype=x.dtype)
    for i in range(size):
        for j in range(size):
            out = np.maximum(out, xp[:, i:i + out_h * stride:stride,
                                     j:j + out_w * stride:stride])
    return out


def reorg_darknet(x: np.ndarray, stride: int) -> np.ndarray:
    """Darknet's (in)famous reorg, exactly as the reference computes it.

    The reference runs ``reorg_cpu(buf, w, h*c/4, 4, stride)`` on the flat CHW
    buffer (``yolo2_model.cpp:112-129,358-377``); that index math is
    equivalent to the flat reinterpretation below (verified bit-exactly by
    tests/test_reorg.py against the literal index formula).

    Input CHW (c, h, w) -> output CHW (c*stride^2, h//stride, w//stride),
    where the *values* are gathered by reinterpreting the input buffer as
    (c//s^2, h*s, w*s).
    """
    c, h, w = x.shape
    s = stride
    oc = c // (s * s)
    flat = np.ascontiguousarray(x).reshape(-1)
    xv = flat.reshape(oc, h, s, w, s)
    out = xv.transpose(2, 4, 0, 1, 3)  # (s, s, oc, h, w)
    return np.ascontiguousarray(out).reshape(c * s * s, h // s, w // s)


class GoldenNet:
    """Numpy fp32 executor over a NetworkSpec.

    ``weights``: dict conv_layer_idx -> (w (n,c,k,k), b (n,)) fp32 arrays.
    """

    def __init__(self, spec: NetworkSpec):
        self.spec = spec

    def forward_fp32(self, x: np.ndarray, weights: dict[int, tuple[np.ndarray, np.ndarray]],
                     keep_all: bool = False) -> dict[int, np.ndarray]:
        """Run fp32 inference; returns {layer_idx: CHW output}. The region
        layer output is the *raw* head tensor (decode happens in
        postprocess.py, matching ``forward_region_layer`` usage)."""
        acts: dict[int, np.ndarray] = {}
        cur = x.astype(np.float32)
        needed = _needed_indices(self.spec) if not keep_all else set(range(self.spec.n))
        for l in self.spec.layers:
            if isinstance(l, ConvSpec):
                w, b = weights[l.idx]
                cur = conv_fp32(cur, w, b, l)
            elif isinstance(l, MaxPoolSpec):
                cur = maxpool(cur, l, pad_value=np.float32(-np.inf))
            elif isinstance(l, ReorgSpec):
                cur = reorg_darknet(cur, l.stride)
            elif isinstance(l, RouteSpec):
                cur = np.concatenate([acts[s] for s in l.layers], axis=0)
            elif isinstance(l, RegionSpec):
                pass  # raw passthrough
            if keep_all or l.idx in needed:
                acts[l.idx] = cur
        acts[self.spec.n - 1] = cur
        return acts


def _needed_indices(spec: NetworkSpec) -> set[int]:
    """Layer outputs that must be retained for later route layers."""
    needed: set[int] = set()
    for l in spec.layers:
        if isinstance(l, RouteSpec):
            needed.update(l.layers)
    return needed
