"""Native (C++) preprocessing library, built on demand with g++ and loaded
with ctypes.

The per-frame host path (uint8 HWC -> letterboxed CHW float -> int16
quantization) mirrors the reference's C preprocessing
(``linux_app/src/yolo2_image_loader.c``, ``yolo2_v4l2.c``) with numerics
identical to ``yolotpu_torch.image`` (the same darknet float32 bilinear).

``-ffp-contract=off`` keeps g++ from fusing the bilinear's mul+add into FMA,
which would change the last bit against the numpy implementation.

The library is built at first use into ``build/yolotpu_torch/native/<hash>/``
at the root of the checkout, keyed by a hash of the source and the command,
in a temporary directory renamed into place, so processes that build it at
the same moment never load a half-written file. Nothing here runs at
import. Mirrors ``yolotpu/native/__init__.py``; the port keeps its own copy
and imports nothing of ``yolotpu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "preproc.cpp"
BUILD_ROOT = _SRC.parent.parent.parent / "build" / "yolotpu_torch" / "native"
LIB_NAME = "libytpreproc.so"
FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-ffp-contract=off")

_lib: ctypes.CDLL | None = None


class NativeUnavailable(RuntimeError):
    pass


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_SRC.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    """g++ the source into ``out``: built in a temporary directory beside it
    and renamed into place (atomic on one file system)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp / LIB_NAME), str(_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp / LIB_NAME, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library; NativeUnavailable when
    g++ cannot build it."""
    global _lib
    if _lib is not None:
        return _lib
    path = BUILD_ROOT / _digest() / LIB_NAME
    if not path.exists():
        try:
            _build(path)
        except (subprocess.CalledProcessError, OSError) as e:
            raise NativeUnavailable(f"cannot build native preproc: {e}") from e
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.yt_hwc_u8_to_chw_f32.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, f32p]
    lib.yt_resize_chw_f32.argtypes = [f32p] + [ctypes.c_int] * 3 + [f32p] + \
        [ctypes.c_int] * 2 + [f32p]
    lib.yt_letterbox_chw_f32.argtypes = [f32p] + [ctypes.c_int] * 3 + [f32p] + \
        [ctypes.c_int] * 2 + [f32p]
    lib.yt_frame_to_input.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                      f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.yt_yuyv_to_rgb.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.yt_quantize_int16.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, i16p]
    for fn in (lib.yt_hwc_u8_to_chw_f32, lib.yt_resize_chw_f32,
               lib.yt_letterbox_chw_f32, lib.yt_frame_to_input,
               lib.yt_yuyv_to_rgb, lib.yt_quantize_int16):
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ---------------------------------------------------------------------------
# numpy-friendly wrappers
# ---------------------------------------------------------------------------

def hwc_to_chw(rgb: np.ndarray) -> np.ndarray:
    lib = load()
    h, w, c = rgb.shape
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty((c, h, w), np.float32)
    lib.yt_hwc_u8_to_chw_f32(_u8(rgb), h, w, c, _fp(out))
    return out


def resize(chw: np.ndarray, dw: int, dh: int) -> np.ndarray:
    lib = load()
    c, sh, sw = chw.shape
    chw = np.ascontiguousarray(chw, np.float32)
    out = np.empty((c, dh, dw), np.float32)
    scratch = np.empty(c * sh * dw, np.float32)
    lib.yt_resize_chw_f32(_fp(chw), c, sh, sw, _fp(out), dh, dw, _fp(scratch))
    return out


def letterbox(chw: np.ndarray, netw: int, neth: int) -> np.ndarray:
    lib = load()
    c, sh, sw = chw.shape
    chw = np.ascontiguousarray(chw, np.float32)
    out = np.empty((c, neth, netw), np.float32)
    scratch = np.empty(c * neth * netw + c * sh * netw + 64, np.float32)
    lib.yt_letterbox_chw_f32(_fp(chw), c, sh, sw, _fp(out), neth, netw,
                             _fp(scratch))
    return out


def frame_to_input(rgb: np.ndarray, netw: int, neth: int) -> np.ndarray:
    """HWC uint8 RGB frame -> letterboxed CHW float32 network input."""
    lib = load()
    h, w, _ = rgb.shape
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty((3, neth, netw), np.float32)
    scratch = np.empty(3 * h * w + 3 * neth * netw + 3 * h * netw + 64,
                       np.float32)
    lib.yt_frame_to_input(_u8(rgb), h, w, _fp(out), neth, netw, _fp(scratch))
    return out


def yuyv_to_rgb(yuyv: np.ndarray, w: int, h: int) -> np.ndarray:
    lib = load()
    yuyv = np.ascontiguousarray(yuyv, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    lib.yt_yuyv_to_rgb(_u8(yuyv), w, h, _u8(out))
    return out


def quantize_int16(x: np.ndarray, q: int) -> np.ndarray:
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.yt_quantize_int16(_fp(x), x.size, q,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out
