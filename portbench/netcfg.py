"""The network of a configuration file, as the benchmark's own code reads it.

A configuration holds darknet's ``[net]`` size and its layer sections
(``layers``: one object per section, darknet's keys and values). This module
works out each layer's shapes with darknet's rules, for the reference and for
the operation and byte counts; it shares no code with the system under test.

Sections: ``[convolutional]`` (leaky or linear, no groups), ``[maxpool]``,
``[route]``, ``[reorg]``, ``[shortcut]`` (linear, of equal shapes),
``[upsample]`` (nearest, a whole stride), and the detection heads:
``[region]`` (yolov2's softmax region, the one head and the last layer) or
any number of ``[yolo]`` heads (darknet's yolov3 decode). ``heads`` checks
that each head reads a conv of its own, which nothing else reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Layer:
    """One layer: its kind, input (h, w, c) and output (out_h, out_w, out_c)
    shapes, and what its kind needs. ``srcs`` are a route's or a shortcut's
    absolute source layers; ``anchors`` a head's (w, h) pairs, flat: a
    region's in grid cells, a yolo head's masked ones in pixels of the
    network's input, whose (height, width) it keeps in ``net``; ``stride``
    an upsample's factor."""
    idx: int
    kind: str   # conv, maxpool, route, reorg, shortcut, upsample, region, yolo
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
    net: tuple[int, ...] = ()

    @property
    def macs(self) -> int:
        """Multiply-accumulates of a conv for one frame (0 otherwise)."""
        if self.kind != "conv":
            return 0
        return self.out_h * self.out_w * self.out_c * self.c * self.size ** 2


def _int(sec: dict, key: str, default: int) -> int:
    return int(sec.get(key, default))


def _floats(v) -> tuple[float, ...]:
    return tuple(float(a) for a in str(v).split(","))


def layers_of(config: dict) -> list[Layer]:
    """The layers of a configuration, with their shapes. Raises on a section
    kind the benchmark does not know, on an activation other than leaky and
    linear (a shortcut's: linear), on shapes a shortcut cannot add, and on
    a key that would change what the benchmark's decode of a head does."""
    net = config["net"]
    h, w, c = int(net["height"]), int(net["width"]), int(net["channels"])
    size_in = (h, w)
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
        elif kind == "shortcut":
            src = int(sec["from"])
            src = src if src >= 0 else idx + src
            if not 0 <= src < idx:
                raise ValueError(f"layer {idx}: shortcut from layer {src}")
            if sec.get("activation", "linear") != "linear":
                raise ValueError(f"layer {idx}: the benchmark knows the "
                                 f"linear shortcut, not {sec}")
            a = out[src]
            if (a.out_h, a.out_w, a.out_c) != (h, w, c):
                raise ValueError(f"layer {idx}: shortcut of unequal shapes, "
                                 f"{(a.out_h, a.out_w, a.out_c)} from layer "
                                 f"{src} and {(h, w, c)}")
            layer = Layer(idx, "shortcut", h, w, c, h, w, c, srcs=(src,))
        elif kind == "upsample":
            s = _int(sec, "stride", 2)
            if s < 1 or float(sec.get("scale", 1)) != 1:
                raise ValueError(f"layer {idx}: the benchmark knows the "
                                 f"upsample by a whole stride, not {sec}")
            layer = Layer(idx, "upsample", h, w, c, h * s, w * s, c, stride=s)
        elif kind == "yolo":
            classes, total = _int(sec, "classes", 20), _int(sec, "num", 1)
            mask = ([int(m) for m in str(sec["mask"]).split(",")]
                    if "mask" in sec else list(range(total)))
            anchors = _floats(sec["anchors"])
            if len(anchors) < 2 * max(mask) + 2:
                raise ValueError(f"layer {idx}: mask {mask} of "
                                 f"{len(anchors) // 2} anchors")
            if (float(sec.get("scale_x_y", 1)) != 1
                    or _int(sec, "new_coords", 0) or "activation" in sec):
                raise ValueError(f"layer {idx}: the benchmark knows darknet's "
                                 "yolo decode, without scale_x_y, new_coords "
                                 "or an activation")
            if c != len(mask) * (5 + classes):
                raise ValueError(f"layer {idx}: a yolo head of {len(mask)} "
                                 f"anchors and {classes} classes reads "
                                 f"{len(mask) * (5 + classes)} channels, "
                                 f"not {c}")
            layer = Layer(idx, "yolo", h, w, c, h, w, c, classes=classes,
                          coords=4, num=len(mask),
                          anchors=sum((anchors[2 * m:2 * m + 2]
                                       for m in mask), ()),
                          net=size_in)
        elif kind == "region":
            num, classes = _int(sec, "num", 1), _int(sec, "classes", 20)
            coords = _int(sec, "coords", 4)
            anchors = _floats(sec["anchors"])
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


def _readers(layers: list[Layer], idx: int) -> list[int]:
    """The layers that read layer idx's output: the next one unless it is
    a route, and every route or shortcut that names it."""
    return [l.idx for l in layers
            if (l.idx == idx + 1 and l.kind != "route")
            or (l.kind in ("route", "shortcut") and idx in l.srcs)]


def heads(layers: list[Layer]) -> list[Layer]:
    """The network's detection heads, region or yolo, in layer order. Each
    directly follows its conv, which no other layer reads, and no layer
    reads the head; a region is the one head, and the last layer. All heads
    have the same classes. Raises otherwise."""
    hs = [l for l in layers if l.kind in ("region", "yolo")]
    if not hs:
        raise ValueError("the benchmark wants a region or yolo head")
    regs = [h for h in hs if h.kind == "region"]
    if regs and (len(hs) != 1 or hs[0].idx != len(layers) - 1):
        raise ValueError("the benchmark wants one region layer, the last, "
                         "and no other head beside it")
    for h in hs:
        conv = h.idx - 1
        if conv < 0 or layers[conv].kind != "conv":
            raise ValueError(f"layer {h.idx}: a head follows its conv")
        others = ([r for r in _readers(layers, conv) if r != h.idx]
                  + _readers(layers, h.idx))
        if others:
            raise ValueError(f"layer {h.idx}: its conv {conv} feeds the head "
                             f"alone, not also layers {others}")
    if len({h.classes for h in hs}) != 1:
        raise ValueError("the benchmark wants heads of the same classes")
    return hs
