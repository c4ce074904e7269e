"""Alphabet-glyph label compositing, the darknet way.

The reference pre-renders ASCII glyph PNGs at 8 size tiers
(``data/labels/make_labels.py:1-30``) and composites labels from them:
``get_label`` picks a tier from the requested pixel height, hstacks the
glyph images with a border, and ``draw_label`` blends ``glyph * rgb`` onto
the frame above the box (``src/core/yolo_post.cpp:248-307``,
``yolo_image.cpp:207-221`` load_alphabet).

No PNG data ships with this package: glyphs are synthesized once per
process with PIL's built-in bitmap font scaled to each tier — same
white-on-black intensity convention as the reference's PNGs, so the
compositing math is identical even though the typeface differs.

Mirrors ``yolotpu/runtime/alphabet.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import functools

import numpy as np

SIZES = 8                 # tiers 0..7, like make_labels.py's 8 point sizes
_CHARS = [chr(c) for c in range(32, 127)]


@functools.lru_cache(maxsize=1)
def load_alphabet() -> list[dict[str, np.ndarray]]:
    """list over size tiers of {char: (h, w) float intensity in [0, 1]}.

    Tier i glyph height is 12 + 8*i px (roughly the reference's 8 point
    sizes rendered at ImageMagick defaults).
    """
    from PIL import Image, ImageDraw, ImageFont

    tiers: list[dict[str, np.ndarray]] = []
    base = ImageFont.load_default()
    for i in range(SIZES):
        h = 12 + 8 * i
        tier: dict[str, np.ndarray] = {}
        for ch in _CHARS:
            im = Image.new("L", (16, 16), 0)
            d = ImageDraw.Draw(im)
            d.text((2, 2), ch, fill=255, font=base)
            arr = np.asarray(im, np.float32) / 255.0
            cols = np.where(arr.max(axis=0) > 0)[0]
            if cols.size:
                arr = arr[:, : cols[-1] + 2]
            else:                       # space and blanks keep ~0.4em
                arr = arr[:, :6]
            if h != arr.shape[0]:       # nearest-neighbor scale to tier h
                g = Image.fromarray((arr * 255).astype(np.uint8))
                w = max(1, int(round(arr.shape[1] * h / arr.shape[0])))
                arr = np.asarray(g.resize((w, h), Image.NEAREST),
                                 np.float32) / 255.0
            tier[ch] = arr
        tiers.append(tier)
    return tiers


def get_label(alphabet: list[dict[str, np.ndarray]], text: str,
              size: int) -> np.ndarray:
    """Composite a label strip for ``text`` at ~``size`` px height.

    Mirrors darknet get_label: tier = size/10 clamped to 7, glyphs
    hstacked, then a 1px border (border_image role).
    """
    tier = min(max(size // 10, 0), SIZES - 1)
    glyphs = alphabet[tier]
    parts = [glyphs.get(ch, glyphs["?"]) for ch in text] or [glyphs[" "]]
    h = max(p.shape[0] for p in parts)
    padded = [np.pad(p, ((0, h - p.shape[0]), (0, 0))) for p in parts]
    strip = np.concatenate(padded, axis=1)
    return np.pad(strip, ((1, 1), (1, 1)))


def draw_label(chw: np.ndarray, r: int, c: int, label: np.ndarray,
               rgb: tuple[float, float, float]) -> None:
    """Blend ``label * rgb`` onto CHW float image at (row r, col c), in
    place — darknet draw_label's ``set_pixel(..., val * rgb[k])`` with the
    glyph intensity as alpha."""
    h, w = label.shape
    H, W = chw.shape[1], chw.shape[2]
    if r + h >= H:
        r = max(0, H - h - 1)
    hh = min(h, H - r)
    ww = min(w, W - c)
    if hh <= 0 or ww <= 0:
        return
    a = label[:hh, :ww]
    for k in range(3):
        chw[k, r:r + hh, c:c + ww] = (
            (1 - a) * chw[k, r:r + hh, c:c + ww] + a * rgb[k])
