"""Detection drawing: boxes + class labels onto images.

Equivalent of ``draw_detections`` (``src/core/yolo_post.cpp:248-307``) and the
board-side ``yolo2_draw.c``: per-class deterministic colors from darknet's
6-color wheel (``yolo_post.cpp:87-97``), box thickness scaled by image size,
text labels (PIL default font replaces the alphabet-PNG compositing).

Mirrors ``yolotpu/runtime/drawing.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import numpy as np

_COLORS = np.array([[1, 0, 1], [0, 0, 1], [0, 1, 1],
                    [0, 1, 0], [1, 1, 0], [1, 0, 0]], np.float32)


def get_color(c: int, x: int, max_val: int) -> float:
    """darknet get_color: interpolate along the 6-color wheel."""
    ratio = (x / max_val) * 5
    i, j = int(np.floor(ratio)), int(np.ceil(ratio))
    ratio -= i
    return float((1 - ratio) * _COLORS[i][c] + ratio * _COLORS[j][c])


def class_rgb(cls: int, classes: int) -> tuple[int, int, int]:
    offset = cls * 123457 % classes if classes else 0
    return tuple(int(255 * get_color(c, offset, max(classes, 1)))
                 for c in (2, 1, 0))  # darknet draws (red,green,blue)=(2,1,0)


def draw_detections(chw: np.ndarray, dets, names: list[str],
                    thresh: float, use_alphabet: bool = True) -> np.ndarray:
    """Draw boxes for every class with prob > thresh (like draw_detections);
    input/output CHW float [0,1].

    Labels composite from the synthesized glyph alphabet by default
    (``yolo_post.cpp:248-307`` get_label/draw_label flow, tier picked by
    image height h*0.03 like the reference); ``use_alphabet=False`` falls
    back to PIL text rendering."""
    from PIL import Image, ImageDraw
    h, w = chw.shape[1], chw.shape[2]
    img = Image.fromarray(
        np.clip(chw.transpose(1, 2, 0) * 255 + 0.5, 0, 255).astype(np.uint8))
    drw = ImageDraw.Draw(img)
    width = max(1, int(h * 0.006))
    labels = []
    for d in dets:
        cls = -1
        label = []
        for j in range(d.classes):
            if d.prob[j] > thresh:
                if cls < 0:
                    cls = j
                label.append(names[j] if j < len(names) else str(j))
        if cls < 0:
            continue
        bx, by, bw, bh = d.bbox
        left = int((bx - bw / 2) * w)
        right = int((bx + bw / 2) * w)
        top = int((by - bh / 2) * h)
        bot = int((by + bh / 2) * h)
        left, right = max(0, left), min(w - 1, right)
        top, bot = max(0, top), min(h - 1, bot)
        color = class_rgb(cls, d.classes)
        drw.rectangle([left, top, right, bot], outline=color, width=width)
        text = ", ".join(label)
        if use_alphabet:
            labels.append((top + width, left, text, color))
        else:
            drw.text((left + width + 1, max(0, top - 12)), text, fill=color)
    out = np.asarray(img, np.uint8).astype(np.float32).transpose(2, 0, 1) / 255.0
    if use_alphabet and labels:
        from . import alphabet as alpha
        ab = alpha.load_alphabet()
        for top, left, text, color in labels:
            strip = alpha.get_label(ab, text, int(h * 0.03))
            alpha.draw_label(out, top, left, strip,
                             tuple(c / 255.0 for c in color))
    return out
