"""Camera capture (V4L2).

The reference negotiates MJPEG with YUYV fallback over raw V4L2 ioctls and
mmap streaming (``linux_app/src/yolo2_v4l2.c:112-119,292-369``). Here cv2's
V4L2 backend provides the device layer; the format negotiation (MJPG
preferred, YUYV fallback) and the BT.601 integer YUYV->RGB conversion are
preserved — the converter is exposed directly for parity tests since cv2
normally hands us decoded frames already.

Mirrors ``yolotpu/runtime/camera.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import numpy as np


def yuyv_to_rgb(yuyv: np.ndarray, width: int, height: int) -> np.ndarray:
    """BT.601 integer YUYV->RGB24, exactly the reference's arithmetic
    (``yolo2_v4l2.c:328-369``): c=y-16, d=u-128, e=v-128;
    r=(298c+409e+128)>>8 etc., clamped to [0,255]."""
    raw = yuyv.reshape(height, width // 2, 4).astype(np.int32)
    y0, u, y1, v = raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3]
    d, e = u - 128, v - 128

    def conv(y):
        c = y - 16
        r = (298 * c + 409 * e + 128) >> 8
        g = (298 * c - 100 * d - 208 * e + 128) >> 8
        b = (298 * c + 516 * d + 128) >> 8
        return np.stack([r, g, b], axis=-1)

    p0, p1 = conv(y0), conv(y1)
    out = np.empty((height, width, 3), np.int32)
    out[:, 0::2], out[:, 1::2] = p0, p1
    return np.clip(out, 0, 255).astype(np.uint8)


class Camera:
    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480, fps: int = 30, fmt: str = "mjpeg"):
        import cv2
        self._cv2 = cv2
        idx = device
        if device.startswith("/dev/video"):
            idx = int(device[len("/dev/video"):])
        self._cap = cv2.VideoCapture(idx, cv2.CAP_V4L2)
        if not self._cap.isOpened():
            raise IOError(f"cannot open camera {device}")
        # format negotiation: MJPG preferred, YUYV fallback (v4l2.c:112-119)
        order = ["MJPG", "YUYV"] if fmt == "mjpeg" else ["YUYV", "MJPG"]
        self.format = None
        for four in order:
            self._cap.set(cv2.CAP_PROP_FOURCC,
                          cv2.VideoWriter_fourcc(*four))
            got = int(self._cap.get(cv2.CAP_PROP_FOURCC))
            if got == cv2.VideoWriter_fourcc(*four):
                self.format = four.lower()
                break
        self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        if fps:
            self._cap.set(cv2.CAP_PROP_FPS, fps)
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def read(self) -> np.ndarray | None:
        ok, bgr = self._cap.read()
        if not ok:
            return None
        return self._cv2.cvtColor(bgr, self._cv2.COLOR_BGR2RGB)

    def close(self) -> None:
        self._cap.release()
