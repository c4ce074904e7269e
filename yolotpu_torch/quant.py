"""Quantization: activation calibration and weight quantization for the
int16, int8 (w8a8) and w8a16 tiers.

Per-conv-layer power-of-two Q exponents for weights and biases, and an
activation table ``iofm_Q`` with n_convs+1 entries derived from running
calibration images through the fp32 forward (``golden``). Convention (the
reference artifact contract): ``x_int = round(x * 2**q)`` with q chosen as
the largest exponent such that the observed absmax still fits the type.

Mirrors ``yolotpu/quant.py`` (only what the port uses); the port keeps
its own copy and imports nothing of ``yolotpu``.
"""

from __future__ import annotations

import numpy as np

from .golden import GoldenNet
from .graph import ConvSpec, NetworkSpec, RouteSpec
from .weights import QTables, WeightStore


def q_for_absmax(absmax: float, margin: float = 1.0, limit: int = 15) -> int:
    """Largest q with absmax * margin * 2**q <= 32767 (clamped to ±limit)."""
    if absmax <= 0:
        return limit
    q = int(np.floor(np.log2(32767.0 / (absmax * margin))))
    return int(np.clip(q, -limit, limit))


def quantize_tensor(x: np.ndarray, q: int) -> np.ndarray:
    """round-half-away-from-zero to int16 at scale 2**q with saturation."""
    v = x.astype(np.float64) * np.ldexp(1.0, q)
    r = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5))
    return np.clip(r, -32768, 32767).astype(np.int16)


def dequantize_tensor(x: np.ndarray, q: int) -> np.ndarray:
    return x.astype(np.float32) * np.float32(np.ldexp(1.0, -q))


def quantize_weights(store: WeightStore, act_q: list[int],
                     margin: float = 1.0,
                     max_shift_out: int = 12) -> WeightStore:
    """Quantize fp32 weights/biases to int16 with per-layer Qs.

    ``max_shift_out`` caps Qw so each conv's requantization shift
    (Qa_in + Qw - Qa_out) stays <= 12: a calibrated layer's int32
    accumulator then peaks around 2**(15+12) = 2**27, leaving 16x headroom
    against int32 overflow in XLA's exact int16xint16->int32 convolution.
    (The reference never hits this because it saturates the running int16
    accumulator after every 4-channel group, core_compute.cpp:115-118 — a
    behavior that costs precision; capping Qw costs ~2 weight LSBs instead.)

    Bias Q is chosen by absmax; the bias shift (Qb - Qa_out) is bounded
    (|b| <= 2**15, |shift| <= 30) so the pre-shifted int32 bias is safe.
    """
    spec = store.spec
    wq: list[int] = []
    bq: list[int] = []
    for ci, l in enumerate(spec.conv_layers()):
        w, b = store.fp32[l.idx]
        qw = q_for_absmax(float(np.abs(w).max()), margin)
        qw = min(qw, max_shift_out - act_q[ci] + act_q[ci + 1])
        qb = q_for_absmax(float(np.abs(b).max()) if b.size else 1.0, margin)
        wq.append(qw)
        bq.append(qb)
        store.int16[l.idx] = (quantize_tensor(w, qw), quantize_tensor(b, qb))
    store.qtables = QTables(weight_q=wq, bias_q=bq, act_q=list(act_q))
    return store


def quantize_tensor_int8(x: np.ndarray, q: int) -> np.ndarray:
    v = x.astype(np.float64) * np.ldexp(1.0, q)
    r = np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5))
    return np.clip(r, -128, 127).astype(np.int8)


def q8_for_absmax(absmax: float, margin: float = 1.0, limit: int = 15) -> int:
    if absmax <= 0:
        return limit
    q = int(np.floor(np.log2(127.0 / (absmax * margin))))
    return int(np.clip(q, -limit, limit))


def quantize_weights_int8(store: WeightStore, act_q8: list[int],
                          margin: float = 1.0,
                          max_shift_out: int = 16,
                          per_channel: bool = False) -> WeightStore:
    """w8a8 turbo tier: int8 weights/biases at 8-bit scales. Products <=
    2^14 and sums <= ~2^28, so int32 accumulation is always safe; the
    shift cap only bounds the requant rounding path.

    ``per_channel=True``: each OUTPUT CHANNEL gets its own power-of-two
    weight/bias exponent (requant shift becomes a lane-broadcast vector
    in every int8 engine). Measured at flagship depth
    (tools/int8_accuracy_sweep.py): NOT reliably better for w8a8 — the
    8-bit per-layer ACTIVATION scales dominate the error (per-channel
    0.06/0.19/0.28 vs per-layer 0.16/0.28/0.26 across calibration
    margins) — so the default stays the uniform per-layer scales that
    mirror the reference artifact contract (``yolo2_model.cpp:311-321``).
    Per-channel is where it IS load-bearing in ``quantize_weights_w8a16``
    (16-bit activations: weights are the only noise source).
    """
    spec = store.spec
    wq: list = []
    bq: list = []
    for ci, l in enumerate(spec.conv_layers()):
        w, b = store.fp32[l.idx]
        cap = max_shift_out - act_q8[ci] + act_q8[ci + 1]
        if per_channel:
            wmax = np.abs(w).reshape(w.shape[0], -1).max(axis=1)
            bmax = np.abs(b) if b.size else np.ones(w.shape[0])
            qw = np.array([min(q8_for_absmax(float(a), margin), cap)
                           for a in wmax], np.int32)
            qb = np.array([q8_for_absmax(float(a), margin) for a in bmax],
                          np.int32)
            store.int8[l.idx] = (
                quantize_tensor_int8(w, qw.reshape(-1, 1, 1, 1)),
                quantize_tensor_int8(b, qb))
        else:
            qw = min(q8_for_absmax(float(np.abs(w).max()), margin), cap)
            qb = q8_for_absmax(float(np.abs(b).max()) if b.size else 1.0,
                               margin)
            store.int8[l.idx] = (quantize_tensor_int8(w, qw),
                                 quantize_tensor_int8(b, qb))
        wq.append(qw)
        bq.append(qb)
    store.qtables8 = QTables(weight_q=wq, bias_q=bq, act_q=list(act_q8))
    return store


def quantize_weights_w8a16(store: WeightStore, act_q: list[int],
                           margin: float = 1.0,
                           max_shift_out: int = 12) -> WeightStore:
    """w8a16 tier: per-output-channel int8 weights against the INT16
    activation iofm table (the same ``act_q`` the exact tier uses).

    Activations keep full 16-bit precision, so the only quantization noise
    added over the int16 tier is ~1 weight LSB — recovered almost entirely
    by the per-channel exponents. The shift cap mirrors the int16 tier's
    Qw cap (quantize_weights max_shift_out=12): the true accumulation
    peaks near 2**(15+12), keeping the w8a16 engine's int32-wraparound
    reconstruction exact (ops.convops.conv_w8a16).

    Bias stays 16-bit (per-channel Q): it is added post-requant in the
    output scale domain, so its precision is free.
    """
    spec = store.spec
    wq: list = []
    bq: list = []
    for ci, l in enumerate(spec.conv_layers()):
        w, b = store.fp32[l.idx]
        cap = max_shift_out - act_q[ci] + act_q[ci + 1]
        wmax = np.abs(w).reshape(w.shape[0], -1).max(axis=1)
        bmax = np.abs(b) if b.size else np.ones(w.shape[0])
        qw = np.array([min(q8_for_absmax(float(a), margin), cap)
                       for a in wmax], np.int32)
        qb = np.array([q_for_absmax(float(a), margin) for a in bmax],
                      np.int32)
        store.w8a16[l.idx] = (
            quantize_tensor_int8(w, qw.reshape(-1, 1, 1, 1)),
            quantize_tensor(b, qb))
        wq.append(qw)
        bq.append(qb)
    store.qtables_w8 = QTables(weight_q=wq, bias_q=bq, act_q=list(act_q))
    return store


def calibrate_activations_int8(spec: NetworkSpec, store: WeightStore,
                               images_chw: list[np.ndarray],
                               margin: float = 1.0) -> list[int]:
    """iofm table at int8 scales (same graph-consistency rules).

    Default margin 1.0, NOT the int16 tier's 2.0: at 8 bits every bit of
    headroom costs real signal. With the 16-bit detection-head epilogue
    (conv_int8 head16) the flagship-depth sweep reads mAP 0.369 at margin
    1.0 vs 0.286 at 1.4 vs 0.138 at 2.0, against fp32's 0.375 — within
    0.006 of fp32 (tools/int8_accuracy_sweep.py, 2026-08-19; saturation
    from the tighter margin is the lesser evil)."""
    act_q16 = calibrate_activations(spec, store, images_chw, margin)
    # identical absmax statistics, 8-bit headroom: q8 = q16 - 8
    return [q - 8 for q in act_q16]


def _producer_conv(spec: NetworkSpec, idx: int) -> int:
    """Walk back from layer ``idx`` through Q-preserving layers (maxpool,
    reorg, single-input route) to the conv whose output scale the tensor
    carries. Returns -1 for the network input."""
    while idx >= 0:
        l = spec.layers[idx]
        if isinstance(l, ConvSpec):
            return idx
        if isinstance(l, RouteSpec):
            if len(l.layers) != 1:
                return idx          # multi-route: scale decided at the route
            idx = l.layers[0]
        else:
            idx -= 1
    return -1


def calibrate_activations(spec: NetworkSpec, store: WeightStore,
                          images_chw: list[np.ndarray],
                          margin: float = 2.0) -> list[int]:
    """Produce ``iofm_Q`` (n_convs+1 entries) from fp32 activations.

    Entry i is conv i's *input* Q, entry n_convs the last conv's output Q.

    The table must be valid under the reference's LINEAR Q walk
    (``yolo2_model.cpp:290-337``): conv ordinal i's output is stored at
    scale entry[i+1], which is simultaneously conv ordinal i+1's input
    scale — at a branch those are DIFFERENT tensors (conv24's output vs
    conv16's, aliased through entry 20), and the runtime realigns only the
    reorg branch, down to ``min(route_sibling_q, current_Qa)``
    (``yolo2_model.cpp:379-399``). A table that gives route branches
    incompatible stored scales therefore concatenates mismatched
    magnitudes with no error anywhere — measured r5 at 416² as int16 mAP
    0.07 vs fp32 0.37 (one branch exactly 2x off). The reference's
    external calibrator satisfied the constraint implicitly; this one
    enforces it: convs whose stored scales are aliased by the walk or
    concatenated by a multi-input route are grouped, and each group gets
    the MIN of its members' natural scales (reorg realign then degenerates
    to shift 0). Costs at most one headroom bit on the shared tensors;
    removes the misalignment class entirely.
    """
    golden = GoldenNet(spec)
    convs = spec.conv_layers()
    n_convs = len(convs)

    # absmax per layer output + network input, across calibration images
    absmax_in = 0.0
    absmax: dict[int, float] = {l.idx: 0.0 for l in spec.layers}
    for img in images_chw:
        absmax_in = max(absmax_in, float(np.abs(img).max()))
        acts = golden.forward_fp32(img, store.fp32, keep_all=True)
        for idx, a in acts.items():
            absmax[idx] = max(absmax[idx], float(np.abs(a).max()))

    # natural (unconstrained) per-conv output scale
    nat_q = {l.idx: q_for_absmax(absmax[l.idx], margin) for l in convs}

    # ---- scale groups (union-find over conv idx) ------------------------
    parent = {l.idx: l.idx for l in convs}

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: int, b: int) -> None:
        if a >= 0 and b >= 0:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

    # 1) walk aliasing: conv ordinal i's stored scale IS entry i+1 = conv
    #    ordinal i+1's input scale = its input tensor's producer scale
    for i in range(n_convs - 1):
        nxt = convs[i + 1]
        prod = _producer_conv(spec, nxt.idx - 1)
        if prod >= 0 and not isinstance(spec.layers[prod], RouteSpec):
            union(convs[i].idx, prod)
    # 2) multi-route branches concatenate: all producing convs share scale
    #    (the runtime's reorg realign then has shift 0 by construction)
    for l in spec.layers:
        if isinstance(l, RouteSpec) and len(l.layers) > 1:
            prods = [_producer_conv(spec, s) for s in l.layers]
            prods = [p for p in prods
                     if p >= 0 and isinstance(spec.layers[p], ConvSpec)]
            for p in prods[1:]:
                union(prods[0], p)

    group_q: dict[int, int] = {}
    for l in convs:
        r = find(l.idx)
        group_q[r] = min(group_q.get(r, 99), nat_q[l.idx])

    # layer-output Q, propagated through Q-preserving layers
    out_q: dict[int, int] = {}
    for l in spec.layers:
        if isinstance(l, ConvSpec):
            out_q[l.idx] = group_q[find(l.idx)]
        elif isinstance(l, RouteSpec):
            # min over branches: realignment shifts the hotter branch down
            # (with grouped branch scales this is the shared group scale)
            out_q[l.idx] = min(out_q[s] for s in l.layers)
        else:
            prev = l.idx - 1
            out_q[l.idx] = out_q[prev] if prev >= 0 else q_for_absmax(absmax_in, margin)

    act_q: list[int] = []
    ci = 0
    for l in spec.layers:
        if isinstance(l, ConvSpec):
            act_q.append(out_q[l.idx - 1] if l.idx > 0 else q_for_absmax(absmax_in, margin))
            ci += 1
    act_q.append(out_q[convs[-1].idx])
    assert len(act_q) == n_convs + 1
    return act_q
