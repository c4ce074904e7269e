"""Built-in model zoo: the YOLOv2 family's architectures as Python data
(yolov2, yolov2-voc, yolov2-tiny); ``build(name)`` constructs their
graphs. Architecture source: the YOLOv2 paper (Redmon & Farhadi, 2016)
and the public darknet configuration for yolov2/yolov2-voc/yolov2-tiny.

Mirrors ``yolotpu/models/zoo.py`` (only what the port uses); the port keeps
its own copy and imports nothing of ``yolotpu``.
"""

from __future__ import annotations

import io

from ..cfg import Section
from ..graph import NetworkSpec


COCO_ANCHORS = (0.57273, 0.677385, 1.87446, 2.06253, 3.33843, 5.47434,
                7.88282, 3.52778, 9.77052, 9.16828)
VOC_ANCHORS = (1.3221, 1.73145, 3.19275, 4.00944, 5.05587, 8.09892,
               9.47112, 4.84053, 11.2364, 10.0071)
TINY_ANCHORS = (1.08, 1.19, 3.42, 4.41, 6.63, 11.38, 9.42, 5.11, 16.62, 10.52)

_CONV = lambda f, s: ("convolutional", {"batch_normalize": "1", "filters": str(f),
                                        "size": str(s), "stride": "1", "pad": "1",
                                        "activation": "leaky"})
_POOL2 = ("maxpool", {"size": "2", "stride": "2"})


def _yolov2_body(head_filters: int, classes: int, anchors: tuple[float, ...]):
    """Darknet-19 backbone + YOLOv2 detection head (the reference's 32-layer
    graph: 23 conv + 5 maxpool + 2 route + 1 reorg + 1 region)."""
    layers = [
        _CONV(32, 3), _POOL2,
        _CONV(64, 3), _POOL2,
        _CONV(128, 3), _CONV(64, 1), _CONV(128, 3), _POOL2,
        _CONV(256, 3), _CONV(128, 1), _CONV(256, 3), _POOL2,
        _CONV(512, 3), _CONV(256, 1), _CONV(512, 3), _CONV(256, 1), _CONV(512, 3), _POOL2,
        _CONV(1024, 3), _CONV(512, 1), _CONV(1024, 3), _CONV(512, 1), _CONV(1024, 3),
        # detection head
        _CONV(1024, 3), _CONV(1024, 3),
        ("route", {"layers": "-9"}),
        _CONV(64, 1),
        ("reorg", {"stride": "2"}),
        ("route", {"layers": "-1,-4"}),
        _CONV(1024, 3),
        ("convolutional", {"size": "1", "stride": "1", "pad": "1",
                           "filters": str(head_filters), "activation": "linear"}),
        ("region", {"anchors": ",".join(str(a) for a in anchors),
                    "bias_match": "1", "classes": str(classes), "coords": "4",
                    "num": "5", "softmax": "1", "jitter": ".3", "rescore": "1",
                    "thresh": ".6"}),
    ]
    return layers


def _yolov2_tiny(classes: int, anchors: tuple[float, ...]):
    head_filters = 5 * (classes + 5)
    return [
        _CONV(16, 3), _POOL2,
        _CONV(32, 3), _POOL2,
        _CONV(64, 3), _POOL2,
        _CONV(128, 3), _POOL2,
        _CONV(256, 3), _POOL2,
        _CONV(512, 3), ("maxpool", {"size": "2", "stride": "1"}),
        _CONV(1024, 3), _CONV(512, 3),
        ("convolutional", {"size": "1", "stride": "1", "pad": "1",
                           "filters": str(head_filters), "activation": "linear"}),
        ("region", {"anchors": ",".join(str(a) for a in anchors),
                    "bias_match": "1", "classes": str(classes), "coords": "4",
                    "num": "5", "softmax": "1", "thresh": ".6"}),
    ]


MODELS: dict[str, dict] = {
    "yolov2": {"width": 416, "height": 416,
               "layers": _yolov2_body(425, 80, COCO_ANCHORS)},
    "yolov2-voc": {"width": 416, "height": 416,
                   "layers": _yolov2_body(125, 20, VOC_ANCHORS)},
    "yolov2-tiny": {"width": 416, "height": 416,
                    "layers": _yolov2_tiny(80, TINY_ANCHORS)},
}


def build(name: str, batch: int = 1, width: int | None = None,
          height: int | None = None) -> NetworkSpec:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    m = MODELS[name]
    sections = [Section(type="net", line=0, options={
        "batch": str(batch),
        "width": str(width or m["width"]),
        "height": str(height or m["height"]),
        "channels": "3",
    })]
    for i, (t, opts) in enumerate(m["layers"], start=1):
        sections.append(Section(type=t, line=i, options=dict(opts)))
    return NetworkSpec.from_sections(sections, batch=batch)


def to_cfg(name: str) -> str:
    """Emit a darknet-compatible cfg for interop with darknet tooling."""
    m = MODELS[name]
    buf = io.StringIO()
    buf.write(f"[net]\nbatch=1\nsubdivisions=1\nwidth={m['width']}\n"
              f"height={m['height']}\nchannels=3\n\n")
    for t, opts in m["layers"]:
        buf.write(f"[{t}]\n")
        for k, v in opts.items():
            buf.write(f"{k}={v}\n")
        buf.write("\n")
    return buf.getvalue()
