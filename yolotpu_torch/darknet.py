"""Darknet ``.weights`` blob ingestion: the nn-weight-extractor role, native.

The reference's artifact flow starts from the official ``yolov2.weights``
darknet blob, converted by an external repo into the ``weights/*.bin``
contract (reference ``weights/README.md:33-67``). This module performs that
conversion natively: parse the darknet binary header, read each convolutional
layer's parameters in file order, fold batch-norm into the weights/bias, and
hand back a :class:`~yolotpu_torch.weights.WeightStore` ready for the existing
artifact writers and quantizers.

Darknet binary layout (darknet ``src/parser.c`` load_weights_upto — public
format, stable since YOLOv2):

    int32 major, int32 minor, int32 revision
    seen: uint64 if major*10+minor >= 2 else uint32
    per [convolutional] layer, in network order:
        float32 biases[n]
        if batch_normalize:
            float32 scales[n]
            float32 rolling_mean[n]
            float32 rolling_variance[n]
        float32 weights[n * c/groups * k * k]

BN folding (darknet ``blas.c`` normalize_cpu + scale/bias add):

    y = scale * (conv - mean) / (sqrt(var) + eps) + bias
      => w' = w * scale / (sqrt(var) + eps)
         b' = bias - scale * mean / (sqrt(var) + eps)

pjreddie's darknet puts eps *outside* the sqrt with eps=1e-6; AlexeyAB's fork
uses sqrt(var + 1e-5). Both are supported via ``eps``/``eps_inside``.

A writer is included so tests can fabricate format-exact fixtures and so
trained models can be exported back to darknet-consumable blobs.

Mirrors ``yolotpu/darknet.py``; the port keeps its own copy and imports
nothing of ``yolotpu``. Host code in numpy, as there: ``fold_batchnorm``
keeps its float32 operation order, so the folded weights are bit-equal to
the JAX package's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from .graph import ConvSpec, NetworkSpec
from .weights import WeightStore


@dataclass
class DarknetHeader:
    major: int = 0
    minor: int = 2
    revision: int = 0
    seen: int = 32013312      # the official yolov2.weights 'images seen'

    @property
    def seen_is_u64(self) -> bool:
        return self.major * 10 + self.minor >= 2

    @property
    def transpose(self) -> bool:
        # affects only fully-connected layers (none in the supported graphs)
        return self.major > 1000 or self.minor > 1000


@dataclass
class ConvParams:
    """Raw (pre-folding) per-layer parameters as stored in the blob."""
    weights: np.ndarray                 # (n, c/groups, k, k) float32
    biases: np.ndarray                  # (n,) float32
    scales: np.ndarray | None = None    # BN gamma
    rolling_mean: np.ndarray | None = None
    rolling_variance: np.ndarray | None = None


@dataclass
class DarknetBlob:
    header: DarknetHeader
    layers: dict[int, ConvParams] = field(default_factory=dict)


def read_darknet(spec: NetworkSpec, path: str) -> DarknetBlob:
    """Parse a darknet ``.weights`` blob against ``spec`` (cfg-driven)."""
    raw = np.fromfile(path, np.uint8)
    if raw.size < 16:
        raise ValueError(f"{path}: too small for a darknet weights header")
    major, minor, revision = struct.unpack("<iii", raw[:12].tobytes())
    hdr = DarknetHeader(major, minor, revision, 0)
    pos = 12
    if hdr.seen_is_u64:
        (hdr.seen,) = struct.unpack("<Q", raw[pos:pos + 8].tobytes())
        pos += 8
    else:
        (hdr.seen,) = struct.unpack("<I", raw[pos:pos + 4].tobytes())
        pos += 4

    f32 = raw[pos:].view(np.float32)
    fpos = 0

    def take(count: int, what: str, idx: int) -> np.ndarray:
        nonlocal fpos
        if fpos + count > f32.size:
            raise ValueError(
                f"{path}: truncated reading {what} of conv layer {idx} "
                f"(need {count} floats at offset {fpos}, have {f32.size})")
        out = f32[fpos:fpos + count].copy()
        fpos += count
        return out

    blob = DarknetBlob(header=hdr)
    for l in spec.layers:
        if not isinstance(l, ConvSpec):
            continue
        b = take(l.n, "biases", l.idx)
        scales = mean = var = None
        if l.batch_normalize:
            scales = take(l.n, "bn scales", l.idx)
            mean = take(l.n, "bn rolling_mean", l.idx)
            var = take(l.n, "bn rolling_variance", l.idx)
        w = take(l.nweights, "weights", l.idx).reshape(
            l.n, l.c // l.groups, l.size, l.size)
        blob.layers[l.idx] = ConvParams(w, b, scales, mean, var)
    if fpos != f32.size:
        # trailing floats indicate a cfg/blob mismatch; fail loudly like the
        # size checks in the reference loader (yolo2_model.cpp:170-195)
        raise ValueError(f"{path}: {f32.size - fpos} unread trailing floats "
                         "(cfg does not match this blob)")
    return blob


def fold_batchnorm(p: ConvParams, eps: float = 1e-6,
                   eps_inside: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Return (w, b) float32 with BN folded (identity if no BN stored)."""
    if p.scales is None:
        return p.weights.astype(np.float32), p.biases.astype(np.float32)
    var = p.rolling_variance.astype(np.float32)
    if eps_inside:
        denom = np.sqrt(var + np.float32(eps), dtype=np.float32)
    else:
        denom = np.sqrt(var, dtype=np.float32) + np.float32(eps)
    g = (p.scales.astype(np.float32) / denom).astype(np.float32)
    w = (p.weights.astype(np.float32) * g[:, None, None, None]).astype(np.float32)
    b = (p.biases.astype(np.float32)
         - g * p.rolling_mean.astype(np.float32)).astype(np.float32)
    return w, b


def load_darknet_weights(spec: NetworkSpec, path: str, eps: float = 1e-6,
                         eps_inside: bool = False) -> WeightStore:
    """Darknet blob -> fp32 WeightStore with BN folded (extractor parity)."""
    blob = read_darknet(spec, path)
    store = WeightStore(spec=spec)
    for idx, p in blob.layers.items():
        store.fp32[idx] = fold_batchnorm(p, eps, eps_inside)
    return store


def write_darknet(path: str, spec: NetworkSpec,
                  layers: dict[int, ConvParams],
                  header: DarknetHeader | None = None) -> None:
    """Write a format-exact darknet ``.weights`` blob."""
    hdr = header or DarknetHeader()
    parts = [struct.pack("<iii", hdr.major, hdr.minor, hdr.revision)]
    parts.append(struct.pack("<Q" if hdr.seen_is_u64 else "<I", hdr.seen))
    for l in spec.layers:
        if not isinstance(l, ConvSpec):
            continue
        p = layers[l.idx]
        parts.append(np.asarray(p.biases, np.float32).tobytes())
        if l.batch_normalize:
            if p.scales is None:
                raise ValueError(f"conv {l.idx}: cfg says batch_normalize "
                                 "but no BN params given")
            parts.append(np.asarray(p.scales, np.float32).tobytes())
            parts.append(np.asarray(p.rolling_mean, np.float32).tobytes())
            parts.append(np.asarray(p.rolling_variance, np.float32).tobytes())
        parts.append(np.ascontiguousarray(
            np.asarray(p.weights, np.float32)).tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))
