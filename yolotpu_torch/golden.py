"""Pure-numpy golden model: the fp32 forward (darknet semantics) and the
INT16 forward in its four modes, the oracle of the engine's ``golden``
backend and of calibration (``quant.calibrate_activations`` reads the fp32
activations). All tensors are CHW (darknet layout) numpy arrays.

The INT16 path reproduces the reference accelerator's arithmetic bit
exactly in ``exact`` mode, order-dependent quirks included: the running
accumulator lives in int16 in the Qa_out domain and is updated once per
(input-channel group of Tn, kernel tap), each group's partial sum shifted by
``Qa_in + Qw - Qa_out`` with round-half-up, added and saturated at once
(``hls/core/core_compute.cpp:86-118``); the bias is pre-shifted and is the
accumulator's first value (``:49-63,86-96``); leaky is integer ``v/10``
truncating toward zero (``:192-198``); maxpool pads with -32768
(``:289-295``); the reorg branch is realigned to ``min(route_q,
current_q)`` before the concat (``yolo2_model.cpp:379-399``); the region
input is dequantized by ``2**-Qa`` (``:406-425``). ``int32`` is the
production contract the port's kernels compute (one int32 sum, one shift);
``int8`` and ``w8a16`` are the 8-bit-weight tiers'.

Mirrors ``yolotpu/golden.py``; the port keeps its own copy and imports
nothing of ``yolotpu``.
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


# ---------------------------------------------------------------------------
# INT16 fixed-point primitives (bit-exact vs. hls/core/core_compute.cpp)
# ---------------------------------------------------------------------------

def reorg_index_math(x: np.ndarray, w: int, h: int, c: int, stride: int) -> np.ndarray:
    """Literal transcription of the reference index formula
    (``yolo2_model.cpp:112-129``) for cross-checking ``reorg_darknet``."""
    xf = np.ascontiguousarray(x).reshape(-1)
    out = np.empty_like(xf)
    out_c = c // (stride * stride)
    for k in range(c):
        c2 = k % out_c
        offset = k // out_c
        for j in range(h):
            h2 = j * stride + offset // stride
            for i in range(w):
                in_index = i + w * (j + h * k)
                w2 = i * stride + offset % stride
                out_index = w2 + w * stride * (h2 + h * stride * c2)
                out[in_index] = xf[out_index]
    return out


def sat16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767)


def shift_round_half_up(v: np.ndarray, shift) -> np.ndarray:
    """Arithmetic shift with round-half-up on right shifts, magnitude capped
    at 30 (``core_compute.cpp:49-63``). Works on int64 arrays. ``shift``
    may be an array (broadcast against ``v``) — the per-channel int8
    requant path."""
    if np.ndim(shift) == 0:
        shift = int(shift)
        if shift > 0:
            mag = min(shift, 30)
            return (v + (1 << (mag - 1))) >> mag
        if shift < 0:
            mag = min(-shift, 30)
            return v << mag
        return v
    s = np.clip(np.asarray(shift, np.int64), -30, 30)
    half = np.where(s > 0, np.int64(1) << np.maximum(s - 1, 0), np.int64(0))
    return np.where(s > 0, (v + half) >> np.maximum(s, 0),
                    v << np.maximum(-s, 0))


def leaky_int16(v: np.ndarray) -> np.ndarray:
    """Integer leaky: negative values divided by 10 with C truncation toward
    zero (``core_compute.cpp:192-198``)."""
    v = v.astype(np.int32)
    neg = np.where(v < 0, -((-v) // 10), v)   # trunc-toward-zero div
    return sat16(neg).astype(np.int16)


def quantize_fp32_to_int16(x: np.ndarray, q: int) -> np.ndarray:
    """Input quantization: round(x * 2^q) with fp32 pre-clamp then int clamp
    (``yolo2_model.cpp:257-273``). llround = round-half-away-from-zero."""
    v = x.astype(np.float32) * np.float32(np.ldexp(1.0, q))
    v = np.clip(v, -32768.0, 32767.0)
    q64 = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(np.int64)
    return sat16(q64).astype(np.int16)


def conv_int16_exact(x: np.ndarray, weights: np.ndarray, bias: np.ndarray,
                     spec: ConvSpec, qw: int, qa_in: int, qa_out: int,
                     qb: int, tn: int = 4) -> np.ndarray:
    """Bit-exact int16 conv mirroring ``core_compute.cpp:22-119``.

    x: int16 CHW. weights: int16 (n, c, k, k). bias: int16 (n,).
    Accumulation order: for each group of `tn` input channels (ascending),
    for each kernel tap (row-major), shift-round the group partial sum into
    the Qa_out domain and saturating-add into an int16 accumulator that was
    initialized with the shifted bias.
    """
    n, cin, k, _ = weights.shape
    assert x.shape[0] == cin
    shift_out = qa_in + qw - qa_out
    shift_bias = qb - qa_out

    bias_shifted = shift_round_half_up(bias.astype(np.int64), shift_bias)
    # NOTE: the HLS core does NOT saturate the shifted bias itself; it is
    # int32 (Acc_Dtype) and enters the first saturating add as `base`.
    acc = np.broadcast_to(bias_shifted.reshape(-1, 1, 1),
                          (n, spec.out_h, spec.out_w)).astype(np.int64).copy()

    cols = im2col(x.astype(np.int64), spec.size, spec.stride, spec.pad)
    cols = cols.reshape(cin, k * k, spec.out_h * spec.out_w)
    wmat = weights.astype(np.int64)  # (n, cin, k, k)

    first = True
    for n0 in range(0, cin, tn):
        n1 = min(n0 + tn, cin)
        for i in range(k):
            for j in range(k):
                tap = i * k + j
                # partial sum over this channel group at this tap
                part = np.einsum("nc,cp->np", wmat[:, n0:n1, i, j],
                                 cols[n0:n1, tap, :], optimize=True)
                scaled = shift_round_half_up(part, shift_out)
                scaled = scaled.reshape(n, spec.out_h, spec.out_w)
                if first:
                    acc = sat16(acc + scaled)
                    first = False
                else:
                    acc = sat16(acc.astype(np.int64) + scaled)
    out = acc.astype(np.int16)
    if spec.activation == "leaky":
        out = leaky_int16(out)
    return out


def conv_int16_int32acc(x: np.ndarray, weights: np.ndarray, bias: np.ndarray,
                        spec: ConvSpec, qw: int, qa_in: int, qa_out: int,
                        qb: int) -> np.ndarray:
    """Production int16 semantics: exact int32 accumulation over the whole
    receptive field, then ONE round-half-up shift + pre-shifted bias +
    saturation + integer leaky. The numpy twin of the port's int16 kernels
    (``ops.q16``) and of ``yolotpu.ops.convops.conv_int16``; it must match
    both bit for bit.
    """
    cols = im2col(x.astype(np.int64), spec.size, spec.stride, spec.pad)
    wmat = weights.reshape(spec.n, -1).astype(np.int64)
    acc = wmat @ cols
    acc = acc.reshape(spec.n, spec.out_h, spec.out_w)
    bias_shifted = shift_round_half_up(bias.astype(np.int64), qb - qa_out)
    v = shift_round_half_up(acc, qa_in + qw - qa_out) + bias_shifted.reshape(-1, 1, 1)
    v = sat16(v)
    if spec.activation == "leaky":
        return leaky_int16(v.astype(np.int16)).astype(np.int16)
    return v.astype(np.int16)


def conv_w8a16_int32acc(x: np.ndarray, weights: np.ndarray, bias: np.ndarray,
                        spec: ConvSpec, qw, qa_in: int, qa_out: int,
                        qb) -> np.ndarray:
    """numpy twin of the w8a16 tier conv (``ops.q8.mm_w8a16`` and
    ``conv3x3_w8a16``): int16 activations x per-channel int8 weights, int32
    accumulation, int16 output. The kernels recombine the accumulation from
    byte-plane sums mod 2^32; the true value fits int32 (shift cap), so
    plain int64 accumulation here is the same number."""
    cols = im2col(x.astype(np.int64), spec.size, spec.stride, spec.pad)
    acc = weights.reshape(spec.n, -1).astype(np.int64) @ cols
    acc = acc.reshape(spec.n, spec.out_h, spec.out_w)
    bias_shifted = shift_round_half_up(bias.astype(np.int64),
                                       np.asarray(qb) - qa_out)
    shift = qa_in + np.asarray(qw) - qa_out
    if shift.ndim:
        shift = shift.reshape(-1, 1, 1)
    v = sat16(shift_round_half_up(acc, shift) + bias_shifted.reshape(-1, 1, 1))
    if spec.activation == "leaky":
        return leaky_int16(v.astype(np.int16)).astype(np.int16)
    return v.astype(np.int16)


def conv_int8_int32acc(x: np.ndarray, weights: np.ndarray, bias: np.ndarray,
                       spec: ConvSpec, qw, qa_in: int, qa_out: int,
                       qb, head16: bool = False) -> np.ndarray:
    """numpy twin of the w8a8 turbo conv (``ops.q8.mm_s8`` and
    ``conv3x3_s8``). ``qw``
    and ``qb`` may be per-output-channel (n,) arrays (per-channel tier).

    ``head16``: detection-head epilogue — requant to int16 at an
    8-bits-finer scale (Qa_out + 8), constructed exactly like the device
    path (bias rounded at Qa_out, THEN << 8, so both sides share the
    same rounding; ``ops.convops.head16``)."""
    cols = im2col(x.astype(np.int64), spec.size, spec.stride, spec.pad)
    acc = weights.reshape(spec.n, -1).astype(np.int64) @ cols
    acc = acc.reshape(spec.n, spec.out_h, spec.out_w)
    bias_shifted = shift_round_half_up(bias.astype(np.int64),
                                       np.asarray(qb) - qa_out)
    shift = qa_in + np.asarray(qw) - qa_out
    if head16:
        bias_shifted = bias_shifted << 8
        shift = shift - 8
        lim = 32767
    else:
        lim = 127
    if np.ndim(shift):
        shift = np.reshape(shift, (-1, 1, 1))
    v = shift_round_half_up(acc, shift) + bias_shifted.reshape(-1, 1, 1)
    v = np.clip(v, -lim - 1, lim)
    if spec.activation == "leaky":
        v32 = v.astype(np.int32)
        v = np.clip(np.where(v32 < 0, -((-v32) // 10), v32), -lim - 1, lim)
    return v.astype(np.int16 if head16 else np.int8)


# ---------------------------------------------------------------------------
# Whole-network golden forward
# ---------------------------------------------------------------------------

class GoldenNet:
    """Numpy reference executor over a NetworkSpec.

    ``weights``: dict conv_layer_idx -> (w (n,c,k,k), b (n,)) fp32 arrays.
    For int16, pass int16 arrays plus per-conv Q tables (see quant.py).
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

    def _region_idx(self):
        for l in self.spec.layers:
            if isinstance(l, RegionSpec):
                return l.idx
        return None

    def forward_int16(self, x_fp32: np.ndarray,
                      weights_q: dict[int, tuple[np.ndarray, np.ndarray]],
                      qtab, keep_all: bool = False,
                      mode: str = "exact") -> dict[int, np.ndarray]:
        """Bit-exact int16 inference following the reference sequencer's Q
        routing (``yolo2_model.cpp:294-446``):

        - conv i uses Qa_in = act_q[conv_index], Qa_out = act_q[conv_index+1]
          (overridden by a pending route realignment),
        - after a reorg, the branch is shifted to min(route_q, current_q)
          where route_q was captured at the conv feeding the *other* route
          input; the next conv's Qa_in becomes that value.

        mode: "exact" (bit-exact reference semantics), "int32" (production
        int16 tier), "int8" (w8a8 turbo tier; pass int8 weights + q8
        tables), or "w8a16" (int8 per-channel weights, int16 activations;
        pass w8a16 weights + qtables_w8). Returns {layer_idx: quantized
        CHW}, plus the final region layer's dequantized fp32 tensor under
        key ``self.spec.n - 1``.
        """
        acts: dict[int, np.ndarray] = {}
        act_q: dict[int, int] = {}
        if mode == "int8":
            v = x_fp32.astype(np.float64) * np.ldexp(1.0, qtab.act_q[0])
            r = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5))
            cur = np.clip(r, -128, 127).astype(np.int8)
            sat = lambda a: np.clip(a, -128, 127)
        else:
            cur = quantize_fp32_to_int16(x_fp32, qtab.act_q[0])
            sat = sat16
        cur_q = qtab.act_q[0]

        conv_i = 0
        pending_route_q: int | None = None
        # graph-derived route plan: for each route with >1 inputs, the branch
        # scales must agree; we realign the *later-computed* branch (the reorg
        # path in yolov2) to min of branch Qs, like yolo2_model.cpp:379-399.
        needed = _needed_indices(self.spec) if not keep_all else set(range(self.spec.n))
        for l in self.spec.layers:
            if isinstance(l, ConvSpec):
                qa_in = qtab.act_q[conv_i] if pending_route_q is None else pending_route_q
                qa_out = qtab.act_q[conv_i + 1]
                w, b = weights_q[l.idx]
                conv_fn = {"exact": conv_int16_exact,
                           "int32": conv_int16_int32acc,
                           "int8": conv_int8_int32acc,
                           "w8a16": conv_w8a16_int32acc}[mode]
                kw = {}
                if mode == "int8" and self._region_idx() == l.idx + 1:
                    kw["head16"] = True      # 16-bit region logits (jax twin)
                cur = conv_fn(cur, w, b, l, qtab.weight_q[conv_i],
                              qa_in, qa_out, qtab.bias_q[conv_i], **kw)
                cur_q = qa_out + (8 if kw.get("head16") else 0)
                conv_i += 1
                pending_route_q = None
            elif isinstance(l, MaxPoolSpec):
                cur = maxpool(cur, l, pad_value=cur.dtype.type(
                    np.iinfo(cur.dtype).min))
            elif isinstance(l, ReorgSpec):
                cur = reorg_darknet(cur, l.stride)
                # realign to the sibling route branch if one exists
                sib_q = _sibling_route_q(self.spec, l.idx, act_q)
                if sib_q is not None and sib_q > 0:
                    target = min(sib_q, cur_q)
                    shift = cur_q - target
                    if shift != 0:
                        v = cur.astype(np.int32)
                        v = (v >> shift) if shift > 0 else (v << -shift)
                        cur = sat(v).astype(cur.dtype)
                        cur_q = target
                    pending_route_q = cur_q
            elif isinstance(l, RouteSpec):
                if len(l.layers) == 1:
                    cur = acts[l.layers[0]]
                    cur_q = act_q[l.layers[0]]
                else:
                    # The reference treats multi-input routes as memory-plan
                    # no-ops and never re-verifies branch scales
                    # (yolo2_model.cpp:404-405); the preceding reorg already
                    # realigned its branch and set the pending input Q.
                    cur = np.concatenate([acts[s] for s in l.layers], axis=0)
                    if pending_route_q is None:
                        cur_q = act_q[l.layers[0]]
                        pending_route_q = cur_q
                    else:
                        cur_q = pending_route_q
            elif isinstance(l, RegionSpec):
                acts[l.idx] = cur.astype(np.float32) * np.float32(np.ldexp(1.0, -cur_q))
                act_q[l.idx] = cur_q
                continue
            if keep_all or l.idx in needed:
                acts[l.idx] = cur
            act_q[l.idx] = cur_q
        return acts


def _needed_indices(spec: NetworkSpec) -> set[int]:
    """Layer outputs that must be retained for later route layers."""
    needed: set[int] = set()
    for l in spec.layers:
        if isinstance(l, RouteSpec):
            needed.update(l.layers)
    return needed


def _sibling_route_q(spec: NetworkSpec, reorg_idx: int,
                     act_q: dict[int, int]) -> int | None:
    """Find the Q of the other branch of the route that consumes this reorg
    (generalizes the reference's hard-coded ``route24_q``,
    ``yolo2_model.cpp:331-334,379-399``)."""
    for l in spec.layers:
        if isinstance(l, RouteSpec) and reorg_idx in l.layers and len(l.layers) > 1:
            for s in l.layers:
                if s != reorg_idx and s in act_q:
                    return act_q[s]
    return None
