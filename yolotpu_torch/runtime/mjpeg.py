"""MJPEG-over-HTTP live streaming.

Equivalent of the reference pair ``yolo2_mjpeg_server.c`` (single-client
nonblocking HTTP server sending ``multipart/x-mixed-replace``) and
``yolo2_mjpeg_streamer.c`` (a thread resending the latest annotated frame at
a fixed rate so players survive slow inference, ``:71-110``). The streamer
keeps only the newest frame under a lock; the sender loop re-encodes/sends
at ``fps`` regardless of producer rate.

Mirrors ``yolotpu/runtime/mjpeg.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import io
import socket
import threading
import time

import numpy as np

BOUNDARY = "yolomjpegframe"


def encode_jpeg(rgb_hwc: np.ndarray, quality: int = 80) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb_hwc).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


class MjpegStreamer:
    """HTTP server + keepalive sender thread. One client at a time (the
    reference accepts a single client and drops the previous one)."""

    def __init__(self, port: int, bind: str = "0.0.0.0", fps: int = 15,
                 quality: int = 80):
        self.fps = max(1, fps)
        self.quality = quality
        self._frame: np.ndarray | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def update_rgb(self, frame_hwc: np.ndarray) -> None:
        """Producer side: swap in the latest annotated frame (mutex-guarded
        latest-frame swap, yolo2_mjpeg_streamer.c:16-36)."""
        with self._lock:
            self._frame = frame_hwc.copy()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2)

    # ------------------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                self._srv.settimeout(0.5)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._stream_to(conn)
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _stream_to(self, conn: socket.socket) -> None:
        conn.settimeout(5)
        _ = conn.recv(4096)  # request headers (ignored beyond existence)
        conn.sendall(
            b"HTTP/1.0 200 OK\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Pragma: no-cache\r\n"
            b"Connection: close\r\n"
            b"Content-Type: multipart/x-mixed-replace; boundary=" +
            BOUNDARY.encode() + b"\r\n\r\n")
        interval = 1.0 / self.fps
        while not self._stop.is_set():
            with self._lock:
                frame = self._frame
            if frame is not None:
                jpg = encode_jpeg(frame, self.quality)
                head = (f"--{BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
                        f"Content-Length: {len(jpg)}\r\n\r\n").encode()
                conn.sendall(head + jpg + b"\r\n")
            time.sleep(interval)
