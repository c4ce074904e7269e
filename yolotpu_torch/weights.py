"""Weight artifacts: per-conv weights and biases, Q tables, the reference's
``weights/*.bin`` contract.

Formats (reference ``weights/README.md:193-221``, ``yolo2_model.cpp:158-227``):

- ``weights.bin``            fp32, per conv layer, darknet (n, c, k, k) order
- ``bias.bin``               fp32, per conv layer, (n,) (BN already folded)
- ``weights_reorg[_int16].bin``  tile-reorganized for the FPGA engine:
      per (Tm output-block, Tn input-block): [k*k taps][tm][tn]
- ``weight_int16.bin`` / ``bias_int16.bin``  int16 with per-layer *odd-count
      padding*: a layer whose element count is odd is followed by 1 pad
      element in the file (``yolo2_model.cpp:216-223``)
- ``weight_int16_Q.bin`` / ``bias_int16_Q.bin``  int32 Q per conv layer
- ``iofm_Q.bin``             int32, n_convs+1 activation Qs (in/out per conv)

The reorg format is supported both ways (read via the inverse transform,
written via the forward transform), so artifacts made for the FPGA flow
stay usable. Mirrors ``yolotpu/weights.py``; the port keeps its own copy
and imports nothing of ``yolotpu``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .graph import NetworkSpec


# Default FPGA tile geometry (reference scripts/hw_params_gen.py:16-23).
DEFAULT_TM = 32
DEFAULT_TN = 4


@dataclass
class QTables:
    """Per-conv-layer power-of-two quantization exponents.

    value_int16 = round(value_fp32 * 2**q). ``act_q`` has n_convs+1 entries:
    entry i is conv i's input scale, entry i+1 its output scale
    (reference ``yolo2_model.cpp:311-321``).
    """

    weight_q: list[int] = field(default_factory=list)
    bias_q: list[int] = field(default_factory=list)
    act_q: list[int] = field(default_factory=list)

    def save(self, dirpath: str) -> None:
        np.asarray(self.weight_q, np.int32).tofile(os.path.join(dirpath, "weight_int16_Q.bin"))
        np.asarray(self.bias_q, np.int32).tofile(os.path.join(dirpath, "bias_int16_Q.bin"))
        np.asarray(self.act_q, np.int32).tofile(os.path.join(dirpath, "iofm_Q.bin"))

    @classmethod
    def load(cls, dirpath: str) -> "QTables":
        return cls(
            weight_q=np.fromfile(os.path.join(dirpath, "weight_int16_Q.bin"), np.int32).tolist(),
            bias_q=np.fromfile(os.path.join(dirpath, "bias_int16_Q.bin"), np.int32).tolist(),
            act_q=np.fromfile(os.path.join(dirpath, "iofm_Q.bin"), np.int32).tolist(),
        )


def weight_reorg(w: np.ndarray, tm: int = DEFAULT_TM, tn: int = DEFAULT_TN) -> np.ndarray:
    """Darknet (n, c, k, k) -> FPGA streaming order, one flat array.

    Per (m-block of tm, n-block of tn): kk-major, then tm, then tn
    (``yolov2_weight_gen.cpp:43-67``). Ragged edge blocks keep their reduced
    TM_MIN/TN_MIN extents.
    """
    n, c, k, _ = w.shape
    out = np.empty(w.size, dtype=w.dtype)
    pos = 0
    wk = w.reshape(n, c, k * k)
    for m0 in range(0, n, tm):
        m1 = min(m0 + tm, n)
        for c0 in range(0, c, tn):
            c1 = min(c0 + tn, c)
            block = wk[m0:m1, c0:c1, :].transpose(2, 0, 1)   # (kk, tm, tn)
            out[pos:pos + block.size] = block.reshape(-1)
            pos += block.size
    return out


def weight_unreorg(flat: np.ndarray, n: int, c: int, k: int,
                   tm: int = DEFAULT_TM, tn: int = DEFAULT_TN) -> np.ndarray:
    """Inverse of ``weight_reorg``: flat streaming order -> (n, c, k, k)."""
    w = np.empty((n, c, k * k), dtype=flat.dtype)
    pos = 0
    for m0 in range(0, n, tm):
        m1 = min(m0 + tm, n)
        for c0 in range(0, c, tn):
            c1 = min(c0 + tn, c)
            cnt = (m1 - m0) * (c1 - c0) * k * k
            block = flat[pos:pos + cnt].reshape(k * k, m1 - m0, c1 - c0)
            w[m0:m1, c0:c1, :] = block.transpose(1, 2, 0)
            pos += cnt
    return w.reshape(n, c, k, k)


@dataclass
class WeightStore:
    """Per-conv-layer weights/biases keyed by layer index, plus Q tables."""

    spec: NetworkSpec
    fp32: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    int16: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    int8: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    w8a16: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    qtables: QTables | None = None          # int16 tier
    qtables8: QTables | None = None         # w8a8 turbo tier
    qtables_w8: QTables | None = None       # w8a16 tier (int16 act iofm)

    # -- loading -----------------------------------------------------------
    @classmethod
    def load_fp32(cls, spec: NetworkSpec, weights_path: str, bias_path: str,
                  reorg: bool = False, tm: int = DEFAULT_TM,
                  tn: int = DEFAULT_TN) -> "WeightStore":
        wflat = np.fromfile(weights_path, np.float32)
        bflat = np.fromfile(bias_path, np.float32)
        store = cls(spec=spec)
        store.fp32 = _slice_layers(spec, wflat, bflat, reorg, tm, tn, pad_odd=False)
        return store

    @classmethod
    def load_int16(cls, spec: NetworkSpec, weights_path: str, bias_path: str,
                   q_dir: str, reorg: bool = False, tm: int = DEFAULT_TM,
                   tn: int = DEFAULT_TN) -> "WeightStore":
        wflat = np.fromfile(weights_path, np.int16)
        bflat = np.fromfile(bias_path, np.int16)
        store = cls(spec=spec)
        store.int16 = _slice_layers(spec, wflat, bflat, reorg, tm, tn, pad_odd=True)
        store.qtables = QTables.load(q_dir)
        n_convs = len(spec.conv_layers())
        if len(store.qtables.weight_q) < n_convs or len(store.qtables.bias_q) < n_convs:
            raise ValueError("Q tables too small for conv layers")
        if len(store.qtables.act_q) < n_convs + 1:
            raise ValueError("iofm_Q.bin must have n_convs+1 entries")
        return store

    # -- saving (reference-compatible artifacts) ----------------------------
    def save_fp32(self, dirpath: str, reorg: bool = False,
                  tm: int = DEFAULT_TM, tn: int = DEFAULT_TN) -> None:
        os.makedirs(dirpath, exist_ok=True)
        ws, bs = [], []
        for l in self.spec.conv_layers():
            w, b = self.fp32[l.idx]
            ws.append(weight_reorg(w, tm, tn) if reorg else w.reshape(-1))
            bs.append(b)
        name = "weights_reorg.bin" if reorg else "weights.bin"
        np.concatenate(ws).astype(np.float32).tofile(os.path.join(dirpath, name))
        np.concatenate(bs).astype(np.float32).tofile(os.path.join(dirpath, "bias.bin"))

    def save_int16(self, dirpath: str, reorg: bool = False,
                   tm: int = DEFAULT_TM, tn: int = DEFAULT_TN) -> None:
        """Write int16 artifacts with the reference's odd-count padding."""
        os.makedirs(dirpath, exist_ok=True)
        ws, bs = [], []
        for l in self.spec.conv_layers():
            w, b = self.int16[l.idx]
            wf = weight_reorg(w, tm, tn) if reorg else w.reshape(-1)
            ws.append(wf)
            if wf.size & 1:
                ws.append(np.zeros(1, np.int16))
            bs.append(b)
            if b.size & 1:
                bs.append(np.zeros(1, np.int16))
        wname = "weights_reorg_int16.bin" if reorg else "weight_int16.bin"
        np.concatenate(ws).astype(np.int16).tofile(os.path.join(dirpath, wname))
        np.concatenate(bs).astype(np.int16).tofile(os.path.join(dirpath, "bias_int16.bin"))
        if self.qtables is not None:
            self.qtables.save(dirpath)

    # -- synthetic weights ---------------------------------------------------
    @classmethod
    def synthetic(cls, spec: NetworkSpec, seed: int = 0) -> "WeightStore":
        """He-scaled random weights so activations stay in a trained-like
        range; lets the full pipeline run without the 194 MB darknet blob."""
        rng = np.random.default_rng(seed)
        store = cls(spec=spec)
        for l in spec.conv_layers():
            fan_in = l.c * l.size * l.size
            scale = np.sqrt(2.0 / fan_in)
            w = (rng.standard_normal((l.n, l.c, l.size, l.size)) * scale).astype(np.float32)
            b = (rng.standard_normal(l.n) * 0.05).astype(np.float32)
            store.fp32[l.idx] = (w, b)
        return store


def _slice_layers(spec: NetworkSpec, wflat: np.ndarray, bflat: np.ndarray,
                  reorg: bool, tm: int, tn: int,
                  pad_odd: bool) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    wpos = bpos = 0
    for l in spec.conv_layers():
        nw, nb = l.nweights, l.nbiases
        if wpos + nw > wflat.size:
            raise ValueError(f"weights file truncated at conv layer {l.idx}")
        if bpos + nb > bflat.size:
            raise ValueError(f"bias file truncated at conv layer {l.idx}")
        wl = wflat[wpos:wpos + nw]
        w = (weight_unreorg(wl, l.n, l.c, l.size, tm, tn) if reorg
             else wl.reshape(l.n, l.c, l.size, l.size))
        b = bflat[bpos:bpos + nb]
        out[l.idx] = (np.ascontiguousarray(w), np.ascontiguousarray(b))
        wpos += nw + ((nw & 1) if pad_odd else 0)
        bpos += nb + ((nb & 1) if pad_odd else 0)
    return out
