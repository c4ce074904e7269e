"""Video frame sources.

Primary path mirrors the reference's ffmpeg pipe reader
(``linux_app/src/yolo2_ffmpeg_video.c:65-156``): fork ``ffmpeg -i <src>
-f rawvideo -pix_fmt rgb24`` with a scale+pad+fps filter so every frame
arrives letterbox-shaped, and read exact-size frames from the pipe with a
read-full loop (``:47-63``). Falls back to OpenCV's decoder when no ffmpeg
binary exists.

Mirrors ``yolotpu/runtime/video.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np


class FFmpegVideoReader:
    """Frames over a pipe from a forked ffmpeg (rgb24, fixed WxH, fps)."""

    def __init__(self, path: str, width: int = 416, height: int = 416,
                 fps: int = 0):
        if shutil.which("ffmpeg") is None:
            raise FileNotFoundError("ffmpeg binary not found")
        vf = (f"scale={width}:{height}:force_original_aspect_ratio=decrease,"
              f"pad={width}:{height}:(ow-iw)/2:(oh-ih)/2:color=gray")
        if fps > 0:
            vf += f",fps={fps}"
        self.width, self.height = width, height
        self._proc = subprocess.Popen(
            ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", path,
             "-vf", vf, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
            stdout=subprocess.PIPE)
        self._frame_bytes = width * height * 3

    def read(self) -> np.ndarray | None:
        """Next frame as HWC uint8 RGB, or None at EOF."""
        buf = b""
        while len(buf) < self._frame_bytes:
            chunk = self._proc.stdout.read(self._frame_bytes - len(buf))
            if not chunk:
                return None
            buf += chunk
        return np.frombuffer(buf, np.uint8).reshape(self.height, self.width, 3)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
        self._proc.wait()


class OpenCVVideoReader:
    """cv2-based fallback decoder; resizes/pads to the target frame."""

    def __init__(self, path: str, width: int = 416, height: int = 416,
                 fps: int = 0):
        import cv2
        self._cv2 = cv2
        self.width, self.height = width, height
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video {path}")

    def read(self) -> np.ndarray | None:
        ok, bgr = self._cap.read()
        if not ok:
            return None
        cv2 = self._cv2
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        h, w = rgb.shape[:2]
        scale = min(self.width / w, self.height / h)
        nw, nh = max(1, int(w * scale)), max(1, int(h * scale))
        resized = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_LINEAR)
        canvas = np.full((self.height, self.width, 3), 128, np.uint8)
        y0, x0 = (self.height - nh) // 2, (self.width - nw) // 2
        canvas[y0:y0 + nh, x0:x0 + nw] = resized
        return canvas

    def close(self) -> None:
        self._cap.release()


def open_video(path: str, width: int = 416, height: int = 416, fps: int = 0):
    """Prefer the ffmpeg pipe (reference behavior); fall back to OpenCV."""
    try:
        return FFmpegVideoReader(path, width, height, fps)
    except FileNotFoundError:
        return OpenCVVideoReader(path, width, height, fps)
