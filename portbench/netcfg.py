"""The network of a configuration file, as the benchmark's own code reads it.

A configuration holds darknet's ``[net]`` size and its layer sections
(``layers``: one object per section, darknet's keys and values). This module
works out each layer's shapes with darknet's rules, for the reference and for
the operation and byte counts; it shares no code with the system under test.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Layer:
    """One layer: its kind, input (h, w, c) and output (out_h, out_w, out_c)
    shapes, and what its kind needs. ``srcs`` are a route's absolute source
    layers; ``anchors`` the region's (w, h) pairs, flat."""
    idx: int
    kind: str            # conv, maxpool, route, reorg, region
    h: int
    w: int
    c: int
    out_h: int
    out_w: int
    out_c: int
    size: int = 1
    stride: int = 1
    pad: int = 0
    leaky: bool = False
    srcs: tuple[int, ...] = ()
    classes: int = 0
    coords: int = 4
    num: int = 0
    anchors: tuple[float, ...] = field(default=())

    @property
    def macs(self) -> int:
        """Multiply-accumulates of a conv for one frame (0 otherwise)."""
        if self.kind != "conv":
            return 0
        return self.out_h * self.out_w * self.out_c * self.c * self.size ** 2


def _int(sec: dict, key: str, default: int) -> int:
    return int(sec.get(key, default))


def layers_of(config: dict) -> list[Layer]:
    """The layers of a configuration, with their shapes. Raises on a section
    kind the benchmark does not know or an activation other than leaky and
    linear."""
    net = config["net"]
    h, w, c = int(net["height"]), int(net["width"]), int(net["channels"])
    out: list[Layer] = []
    for idx, sec in enumerate(config["layers"]):
        kind = sec["type"]
        if kind == "convolutional":
            size, stride = _int(sec, "size", 1), _int(sec, "stride", 1)
            pad = size // 2 if _int(sec, "pad", 0) else _int(sec, "padding", 0)
            act = sec.get("activation", "logistic")
            if act not in ("leaky", "linear") or _int(sec, "groups", 1) != 1:
                raise ValueError(f"layer {idx}: the benchmark knows leaky and "
                                 f"linear convs without groups, not {sec}")
            n = _int(sec, "filters", 1)
            layer = Layer(idx, "conv", h, w, c,
                          (h + 2 * pad - size) // stride + 1,
                          (w + 2 * pad - size) // stride + 1, n, size,
                          stride, pad, act == "leaky")
        elif kind == "maxpool":
            stride = _int(sec, "stride", 1)
            size = _int(sec, "size", stride)
            pad = _int(sec, "padding", size - 1)
            layer = Layer(idx, "maxpool", h, w, c,
                          (h + pad - size) // stride + 1,
                          (w + pad - size) // stride + 1, c, size, stride,
                          pad)
        elif kind == "route":
            srcs = tuple(int(s) if int(s) >= 0 else idx + int(s)
                         for s in str(sec["layers"]).split(","))
            first = out[srcs[0]]
            if any(out[s].out_h != first.out_h or out[s].out_w != first.out_w
                   for s in srcs):
                raise ValueError(f"layer {idx}: route of unequal sizes")
            layer = Layer(idx, "route", first.out_h, first.out_w, 0,
                          first.out_h, first.out_w,
                          sum(out[s].out_c for s in srcs), srcs=srcs)
        elif kind == "reorg":
            s = _int(sec, "stride", 1)
            layer = Layer(idx, "reorg", h, w, c, h // s, w // s, c * s * s,
                          stride=s)
        elif kind == "region":
            num, classes = _int(sec, "num", 1), _int(sec, "classes", 20)
            coords = _int(sec, "coords", 4)
            anchors = tuple(float(a) for a in str(sec["anchors"]).split(","))
            if _int(sec, "softmax", 0) != 1 or _int(sec, "background", 0):
                raise ValueError(f"layer {idx}: the benchmark knows the "
                                 "softmax region without background")
            layer = Layer(idx, "region", h, w, c, h, w, c, classes=classes,
                          coords=coords, num=num, anchors=anchors[:2 * num])
        else:
            raise ValueError(f"layer {idx}: unknown section [{kind}]")
        out.append(layer)
        h, w, c = layer.out_h, layer.out_w, layer.out_c
    return out


def convs(layers: list[Layer]) -> list[Layer]:
    return [l for l in layers if l.kind == "conv"]


def region(layers: list[Layer]) -> Layer:
    regs = [l for l in layers if l.kind == "region"]
    if len(regs) != 1 or regs[0].idx != len(layers) - 1:
        raise ValueError("the benchmark wants one region layer, the last")
    return regs[0]
