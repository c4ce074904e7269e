"""Image IO and letterboxing with exact darknet numerics.

Behavioral targets (reference ``src/core/yolo_image.cpp``):
- ``load_image_stb``   :167-189  HWC uint8 -> CHW float32 / 255
- ``resize_image``     :84-127   separable bilinear with darknet's edge rule
  (last column copies the last source pixel; the vertical pass skips the
  second tap on the last row)
- ``letterbox_image``  :148-165  integer new_w/new_h, 0.5-gray fill, centered
  embed at ((w-new_w)//2, (h-new_h)//2)

Mirrors ``yolotpu/image.py`` (only what the port uses); the port keeps
its own copy and imports nothing of ``yolotpu``.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str, channels: int = 3) -> np.ndarray:
    """Load an image file to CHW float32 in [0,1] (darknet layout)."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB" if channels == 3 else "L")
        hwc = np.asarray(im, dtype=np.uint8)
    if hwc.ndim == 2:
        hwc = hwc[:, :, None]
    return (hwc.astype(np.float32) / 255.0).transpose(2, 0, 1)


def save_image(chw: np.ndarray, path: str) -> None:
    """CHW float [0,1] -> PNG/JPEG via PIL (save_image_png equivalent)."""
    from PIL import Image
    hwc = np.clip(chw.transpose(1, 2, 0) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if hwc.shape[2] == 1:
        hwc = hwc[:, :, 0]
    Image.fromarray(hwc).save(path)


def resize_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Darknet bilinear resize, CHW float32 -> CHW float32 (w, h target).

    Horizontal pass: scale (src_w-1)/(w-1); output col w-1 (or src_w==1)
    copies the last source column. Vertical pass: scale (src_h-1)/(h-1);
    the dy tap is skipped entirely on the last output row.
    """
    c, src_h, src_w = im.shape
    im = im.astype(np.float32)

    # horizontal. Index math is float32 end-to-end to match the C code's
    # ``float sx = c * w_scale`` exactly (f64 here occasionally lands on the
    # other side of an integer boundary, shifting ix/dx by one source pixel).
    if w == 1:
        # darknet's `c == w-1` branch wins at col 0 when w==1: the LAST
        # source column is copied (yolo_image.cpp:93-95)
        part = im[:, :, -1:].copy()
    else:
        w_scale = np.float32(np.float32(src_w - 1) / np.float32(w - 1))
        cols = np.arange(w, dtype=np.float32)
        sx = cols * w_scale
        ix = sx.astype(np.int64)
        dx = (sx - ix.astype(np.float32)).astype(np.float32)
        last = (np.arange(w) == w - 1) | (src_w == 1)
        ix0 = np.where(last, src_w - 1, ix)
        ix1 = np.minimum(ix0 + 1, src_w - 1)
        d = np.where(last, np.float32(0.0), dx).astype(np.float32)
        part = (1 - d) * im[:, :, ix0] + d * im[:, :, ix1]

    # vertical
    if h == 1:
        return part[:, :1, :].astype(np.float32)
    h_scale = np.float32(np.float32(src_h - 1) / np.float32(h - 1))
    rows = np.arange(h, dtype=np.float32)
    sy = rows * h_scale
    iy = np.minimum(sy.astype(np.int64), src_h - 1)
    dy = (sy - iy.astype(np.float32)).astype(np.float32)
    out = (1 - dy)[None, :, None] * part[:, iy, :]
    take2 = ~((rows == h - 1) | (src_h == 1))
    iy1 = np.minimum(iy + 1, src_h - 1)
    out = out + np.where(take2, dy, 0.0)[None, :, None] * part[:, iy1, :]
    return out.astype(np.float32)


def resize_image_scalar(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Literal loop transcription of resize_image (yolo_image.cpp:84-127)
    for cross-checking the vectorized version in tests."""
    c, src_h, src_w = im.shape
    part = np.zeros((c, src_h, w), np.float32)
    w_scale = np.float32(src_w - 1) / np.float32(w - 1) if w > 1 else np.float32(0)
    h_scale = np.float32(src_h - 1) / np.float32(h - 1) if h > 1 else np.float32(0)
    for k in range(c):
        for r in range(src_h):
            for col in range(w):
                if col == w - 1 or src_w == 1:
                    val = im[k, r, src_w - 1]
                else:
                    sx = np.float32(np.float32(col) * w_scale)
                    ix = int(sx)
                    dx = np.float32(sx - np.float32(ix))
                    val = (1 - dx) * im[k, r, ix] + dx * im[k, r, ix + 1]
                part[k, r, col] = val
    out = np.zeros((c, h, w), np.float32)
    for k in range(c):
        for r in range(h):
            sy = np.float32(np.float32(r) * h_scale)
            iy = int(sy)
            dy = np.float32(sy - np.float32(iy))
            out[k, r, :] = (1 - dy) * part[k, iy, :]
            if r == h - 1 or src_h == 1:
                continue
            out[k, r, :] += dy * part[k, iy + 1, :]
    return out


def letterbox_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Aspect-preserving resize into a 0.5-gray (w,h) canvas.

    Integer new_w/new_h math matches the reference exactly
    (yolo_image.cpp:150-157): ``new_h = (im_h * w) // im_w`` etc.
    """
    c, im_h, im_w = im.shape
    if w / im_w < h / im_h:
        new_w = w
        new_h = (im_h * w) // im_w
    else:
        new_h = h
        new_w = (im_w * h) // im_h
    resized = resize_image(im, new_w, new_h)
    boxed = np.full((c, h, w), 0.5, dtype=np.float32)
    dy, dx = (h - new_h) // 2, (w - new_w) // 2
    boxed[:, dy:dy + new_h, dx:dx + new_w] = resized
    return boxed
