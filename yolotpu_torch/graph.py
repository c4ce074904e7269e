"""Typed network graph built from darknet cfg files.

This replaces the reference's ``parse_network_cfg`` / layer factories
(``src/core/yolo_net.cpp:218-291``, ``src/core/yolo_layers.cpp``) with an
immutable spec per layer plus exact darknet shape inference:

- conv:   out = (in + 2*pad - size)//stride + 1, pad = size//2 when ``pad=1``
          (``yolo_layers.cpp:19-27,92-99``)
- maxpool: padding default size-1; out = (in + padding - size)//stride + 1
          (``yolo_layers.cpp:299-316``); windows anchor at (r*stride, c*stride)
          and padding is implicit at the bottom/right with -inf fill
          (HLS ``pool_yolo2``, ``hls/core/core_compute.cpp:266-305``)
- route:  concat along channels; negative indices relative to current layer
          (``yolo_layers.cpp:119-157``)
- reorg:  out = (w//s, h//s, c*s*s) for reverse=0 (``yolo_layers.cpp:234-270``)
- region: passthrough head; anchors default to 0.5 (``yolo_layers.cpp:159-186``)

Unlike the reference sequencer (``yolo2_model.cpp:79-110``) nothing here
hard-codes layer indices — route/reorg plumbing is derived from the graph, so
yolov2, yolov2-voc and yolov2-tiny all parse with the same code.

Mirrors ``yolotpu/graph.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

from .cfg import Section, read_cfg

ACTIVATIONS = (
    "logistic", "relu", "relie", "linear", "ramp", "tanh", "plse", "leaky",
    "elu", "loggy", "stair", "hardtan", "lhtan",
)


@dataclass(frozen=True)
class LayerSpec:
    idx: int
    # input feature-map dims (darknet order: h, w, c)
    h: int
    w: int
    c: int
    out_h: int
    out_w: int
    out_c: int

    @property
    def type(self) -> str:
        raise NotImplementedError

    @property
    def outputs(self) -> int:
        return self.out_h * self.out_w * self.out_c

    @property
    def inputs(self) -> int:
        return self.h * self.w * self.c


@dataclass(frozen=True)
class ConvSpec(LayerSpec):
    n: int = 0            # output channels (filters)
    size: int = 1
    stride: int = 1
    pad: int = 0          # resolved padding in pixels
    activation: str = "linear"
    batch_normalize: bool = False
    groups: int = 1

    @property
    def type(self) -> str:
        return "convolutional"

    @property
    def nweights(self) -> int:
        return self.c // self.groups * self.n * self.size * self.size

    @property
    def nbiases(self) -> int:
        return self.n

    @property
    def bflops(self) -> float:
        return (2.0 * self.n * self.size * self.size * self.c / self.groups
                * self.out_h * self.out_w) / 1e9


@dataclass(frozen=True)
class MaxPoolSpec(LayerSpec):
    size: int = 2
    stride: int = 2
    padding: int = 1      # darknet default: size-1

    @property
    def type(self) -> str:
        return "maxpool"


@dataclass(frozen=True)
class RouteSpec(LayerSpec):
    layers: tuple[int, ...] = ()   # absolute source layer indices

    @property
    def type(self) -> str:
        return "route"


@dataclass(frozen=True)
class ReorgSpec(LayerSpec):
    stride: int = 2
    reverse: bool = False

    @property
    def type(self) -> str:
        return "reorg"


@dataclass(frozen=True)
class RegionSpec(LayerSpec):
    num: int = 5              # anchors per cell (l.n)
    classes: int = 80
    coords: int = 4
    softmax: bool = True
    background: bool = False
    biases: tuple[float, ...] = ()   # 2*num anchor sizes
    thresh: float = 0.5
    max_boxes: int = 30

    @property
    def type(self) -> str:
        return "region"


@dataclass
class NetOptions:
    """[net] section values relevant to inference/training."""

    batch: int = 1
    width: int = 416
    height: int = 416
    channels: int = 3
    momentum: float = 0.9
    decay: float = 0.0005
    learning_rate: float = 0.001


@dataclass
class NetworkSpec:
    net: NetOptions
    layers: list[LayerSpec]

    @property
    def n(self) -> int:
        return len(self.layers)

    def conv_layers(self) -> list[ConvSpec]:
        return [l for l in self.layers if isinstance(l, ConvSpec)]

    @property
    def region(self) -> RegionSpec | None:
        for l in self.layers:
            if isinstance(l, RegionSpec):
                return l
        return None

    # ------------------------------------------------------------------
    @classmethod
    def from_cfg(cls, path: str, batch: int | None = None,
                 quiet: bool = True) -> "NetworkSpec":
        sections = read_cfg(path)
        if not sections or sections[0].type not in ("net", "network"):
            raise ValueError(f"{path}: first section must be [net]")
        return cls.from_sections(sections, batch=batch, quiet=quiet)

    @classmethod
    def from_sections(cls, sections: list[Section], batch: int | None = None,
                      quiet: bool = True) -> "NetworkSpec":
        netsec = sections[0]
        net = NetOptions(
            batch=batch if batch is not None else netsec.get_int("batch", 1),
            width=netsec.get_int("width", 0),
            height=netsec.get_int("height", 0),
            channels=netsec.get_int("channels", 0),
            momentum=netsec.get_float("momentum", 0.9),
            decay=netsec.get_float("decay", 0.0005),
            learning_rate=netsec.get_float("learning_rate", 0.001),
        )
        # consume remaining [net] keys silently (training schedule etc.)
        for k in list(netsec.options):
            netsec.get_str(k)

        layers: list[LayerSpec] = []
        h, w, c = net.height, net.width, net.channels
        for idx, sec in enumerate(sections[1:]):
            l = _parse_layer(idx, sec, h, w, c, layers)
            layers.append(l)
            if l.out_h or l.out_w or l.out_c:
                h, w, c = l.out_h, l.out_w, l.out_c
            if not quiet:
                sec.warn_unused()
        return cls(net=net, layers=layers)

    # ------------------------------------------------------------------
    def describe(self, file=sys.stderr) -> None:
        """Darknet-style topology print (mirrors factory fprintf lines)."""
        print("layer     filters    size              input                output", file=file)
        for l in self.layers:
            if isinstance(l, ConvSpec):
                print(f"{l.idx:5d} conv  {l.n:5d} {l.size:2d} x{l.size:2d} /{l.stride:2d}  "
                      f"{l.w:4d} x{l.h:4d} x{l.c:4d}   ->  {l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}"
                      f"  {l.bflops:5.3f} BFLOPs", file=file)
            elif isinstance(l, MaxPoolSpec):
                print(f"{l.idx:5d} max        {l.size} x {l.size} / {l.stride}  "
                      f"{l.w:4d} x{l.h:4d} x{l.c:4d}   ->  {l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}",
                      file=file)
            elif isinstance(l, RouteSpec):
                print(f"{l.idx:5d} route " + " ".join(str(i) for i in l.layers), file=file)
            elif isinstance(l, ReorgSpec):
                print(f"{l.idx:5d} reorg             /{l.stride:2d}  "
                      f"{l.w:4d} x{l.h:4d} x{l.c:4d}   ->  {l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}",
                      file=file)
            elif isinstance(l, RegionSpec):
                print(f"{l.idx:5d} detection", file=file)


def _parse_layer(idx: int, sec: Section, h: int, w: int, c: int,
                 prev: list[LayerSpec]) -> LayerSpec:
    t = sec.type
    if t in ("convolutional", "conv"):
        n = sec.get_int("filters", 1)
        size = sec.get_int("size", 1)
        stride = sec.get_int("stride", 1)
        pad_flag = sec.get_int("pad", 0)
        padding = sec.get_int("padding", 0)
        groups = sec.get_int("groups", 1)
        if pad_flag:
            padding = size // 2
        activation = sec.get_str("activation", "logistic")
        if activation not in ACTIVATIONS:
            raise ValueError(f"layer {idx}: unknown activation {activation!r}")
        bn = bool(sec.get_int("batch_normalize", 0))
        if not (h and w and c):
            raise ValueError(f"layer {idx}: conv input has no image dims")
        out_h = (h + 2 * padding - size) // stride + 1
        out_w = (w + 2 * padding - size) // stride + 1
        return ConvSpec(idx=idx, h=h, w=w, c=c, out_h=out_h, out_w=out_w,
                        out_c=n, n=n, size=size, stride=stride, pad=padding,
                        activation=activation, batch_normalize=bn, groups=groups)

    if t in ("maxpool", "max"):
        stride = sec.get_int("stride", 1)
        size = sec.get_int("size", stride)
        padding = sec.get_int("padding", size - 1)
        out_h = (h + padding - size) // stride + 1
        out_w = (w + padding - size) // stride + 1
        return MaxPoolSpec(idx=idx, h=h, w=w, c=c, out_h=out_h, out_w=out_w,
                           out_c=c, size=size, stride=stride, padding=padding)

    if t == "route":
        srcs = sec.get_ints("layers")
        if not srcs:
            raise ValueError(f"layer {idx}: route needs 'layers'")
        abs_srcs = tuple(s if s >= 0 else idx + s for s in srcs)
        for s in abs_srcs:
            if not (0 <= s < idx):
                raise ValueError(f"layer {idx}: route source {s} out of range")
        first = prev[abs_srcs[0]]
        out_h, out_w, out_c = first.out_h, first.out_w, first.out_c
        for s in abs_srcs[1:]:
            nxt = prev[s]
            if nxt.out_w == first.out_w and nxt.out_h == first.out_h:
                out_c += nxt.out_c
            else:
                out_h = out_w = out_c = 0
        return RouteSpec(idx=idx, h=0, w=0, c=0, out_h=out_h, out_w=out_w,
                         out_c=out_c, layers=abs_srcs)

    if t == "reorg":
        stride = sec.get_int("stride", 1)
        reverse = bool(sec.get_int("reverse", 0))
        if not (h and w and c):
            raise ValueError(f"layer {idx}: reorg input has no image dims")
        if reverse:
            out_w, out_h, out_c = w * stride, h * stride, c // (stride * stride)
        else:
            out_w, out_h, out_c = w // stride, h // stride, c * (stride * stride)
        return ReorgSpec(idx=idx, h=h, w=w, c=c, out_h=out_h, out_w=out_w,
                         out_c=out_c, stride=stride, reverse=reverse)

    if t == "region":
        coords = sec.get_int("coords", 4)
        classes = sec.get_int("classes", 20)
        num = sec.get_int("num", 1)
        biases = sec.get_floats("anchors") or [0.5] * (2 * num)
        if len(biases) < 2 * num:
            biases = biases + [0.5] * (2 * num - len(biases))
        return RegionSpec(
            idx=idx, h=h, w=w, c=c, out_h=h, out_w=w,
            out_c=num * (classes + coords + 1),
            num=num, classes=classes, coords=coords,
            softmax=bool(sec.get_int("softmax", 0)),
            background=bool(sec.get_int("background", 0)),
            biases=tuple(biases[: 2 * num]),
            thresh=sec.get_float("thresh", 0.5),
            max_boxes=sec.get_int("max", 30),
        )

    raise ValueError(f"layer {idx}: unsupported section [{t}]")
