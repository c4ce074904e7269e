"""The port's runtime I/O modules against yolotpu's, side by side: the JSONL
records (byte for byte), the integer BT.601 YUYV->RGB converter, the MJPEG
server, the OpenCV video reader, and the raw V4L2 layer under a fake device
(a copy of tests/test_v4l2.py's FakeSys, for either module's ioctl seam):
format fallback and substitution, adjusted dimensions, capability and
buffer checks, YUYV and MJPEG frames, EAGAIN and the index guard."""

import ctypes
import errno
import io
import socket
import time

import numpy as np
import pytest

from yolotpu.postprocess import Detection as JDetection
from yolotpu.runtime import camera as jcamera
from yolotpu.runtime import jsonl as jjsonl
from yolotpu.runtime import mjpeg as jmjpeg
from yolotpu.runtime import v4l2 as jv4l2
from yolotpu.runtime import video as jvideo
from yolotpu_torch.postprocess import Detection
from yolotpu_torch.runtime import camera, jsonl, mjpeg, v4l2, video

SIDES = {"port": (camera, jsonl, mjpeg, v4l2, video, Detection),
         "jax": (jcamera, jjsonl, jmjpeg, jv4l2, jvideo, JDetection)}


def test_jsonl_records_byte_identical(tmp_path):
    out = {}
    for who, (_, jl, _, _, _, det) in SIDES.items():
        dets = [det(bbox=(0.5, 0.5, 0.25, 0.5), objectness=0.9,
                    prob=np.asarray([0.8, 0.1], np.float32), classes=2),
                det(bbox=(0.1, 0.1, 0.05, 0.05), objectness=0.3,
                    prob=np.asarray([0.0, 0.1], np.float32), classes=2),
                det(bbox=(0.3, 0.7, 0.123456789, 0.2), objectness=0.7,
                    prob=np.asarray([0.0, 0.6], np.float32), classes=2)]
        w = jl.JsonlWriter(str(tmp_path / f"{who}.jsonl"))
        w.write_record("video", "clip.mp4", 7, 3, 640, 480, dets,
                       ["dog"], thresh=0.25)
        w.write_record("camera", "/dev/video0", 8, 4, 33, 17, [], ["dog"], 0.5)
        w.close()
        out[who] = (tmp_path / f"{who}.jsonl").read_bytes()
    assert out["port"] == out["jax"]
    assert out["port"].count(b"\n") == 2 and b'"label":"unknown"' in out["port"]


def test_yuyv_to_rgb_equal():
    yuyv = np.random.default_rng(0).integers(0, 256, 48 * 10 * 2, np.uint8)
    got = camera.yuyv_to_rgb(yuyv, 48, 10)
    assert got.dtype == np.uint8 and np.array_equal(
        got, jcamera.yuyv_to_rgb(yuyv, 48, 10))
    white_black = camera.yuyv_to_rgb(np.array([235, 128, 16, 128], np.uint8),
                                     2, 1)
    assert (white_black[0, 0] > 250).all() and (white_black[0, 1] < 5).all()


def _mjpeg_bytes(mod) -> bytes:
    s = mod.MjpegStreamer(port=0, bind="127.0.0.1", fps=30, quality=70)
    try:
        frame = np.zeros((32, 32, 3), np.uint8)
        frame[:, :, 0] = 255
        s.update_rgb(frame)
        conn = socket.create_connection(("127.0.0.1", s.port), timeout=5)
        conn.sendall(b"GET / HTTP/1.0\r\n\r\n")
        data = b""
        t0 = time.time()
        while b"\xff\xd9" not in data and time.time() - t0 < 5:
            data += conn.recv(65536)
        conn.close()
        return data
    finally:
        s.stop()


def test_mjpeg_server_serves_the_same_stream():
    got, want = _mjpeg_bytes(mjpeg), _mjpeg_bytes(jmjpeg)
    assert b"multipart/x-mixed-replace" in got
    assert mjpeg.BOUNDARY.encode() in got and b"\xff\xd8" in got
    # headers and the first JPEG frame, byte for byte
    end = got.index(b"\xff\xd9") + 2
    assert got[:end] == want[:want.index(b"\xff\xd9") + 2]
    assert mjpeg.encode_jpeg(np.zeros((8, 8, 3), np.uint8)) == \
        jmjpeg.encode_jpeg(np.zeros((8, 8, 3), np.uint8))


@pytest.fixture
def tiny_video(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    if not wr.isOpened():
        pytest.skip("cv2 VideoWriter unavailable")
    rng = np.random.default_rng(0)
    for _ in range(8):
        wr.write((rng.random((48, 64, 3)) * 255).astype(np.uint8))
    wr.release()
    return path


def test_opencv_video_reader_equal(tiny_video):
    frames = {}
    for who, (*_, vid, _) in SIDES.items():
        rd = vid.open_video(tiny_video, width=64, height=64)
        frames[who] = []
        while (f := rd.read()) is not None:
            frames[who].append(f)
        rd.close()
    assert len(frames["port"]) == len(frames["jax"]) == 8
    for a, b in zip(frames["port"], frames["jax"]):
        assert a.shape == (64, 64, 3) and a.dtype == np.uint8
        assert np.array_equal(a, b)


# --- the raw V4L2 layer under a fake device --------------------------------

def fake_sys(V, mjpeg_ok=False, width=32, height=8, adjust=None, caps=None,
             substitute_fmt=False, n_buffers=4):
    """tests/test_v4l2.py's FakeSys for the V4L2 module V: YUYV always,
    MJPEG when ``mjpeg_ok``, with a real queued/dequeued buffer state
    machine."""

    class FakeSys(V.V4L2Sys):
        def __init__(self):
            self.mjpeg_ok = mjpeg_ok
            self.w, self.h = width, height
            self.adjust = adjust
            self.caps = (V.CAP_VIDEO_CAPTURE | V.CAP_STREAMING
                         if caps is None else caps)
            self.substitute_fmt = substitute_fmt
            self.n_buffers = n_buffers
            self.queued: list[int] = []
            self.pending: list[tuple[int, bytes]] = []
            self.streaming = False
            self.mem = {}
            self.log: list[str] = []

        def open(self, device):
            self.log.append(f"open {device}")
            return 42

        def close(self, fd):
            self.log.append("close")

        def mmap(self, fd, length, offset):
            buf = bytearray(length)
            self.mem[offset] = buf
            return memoryview(buf)

        def ioctl(self, fd, request, arg):
            if request == V.VIDIOC_QUERYCAP:
                arg.capabilities = self.caps
            elif request == V.VIDIOC_S_FMT:
                pix = arg.fmt.pix
                if pix.pixelformat == V.PIX_FMT_MJPEG and not self.mjpeg_ok:
                    if self.substitute_fmt:
                        pix.pixelformat = V.PIX_FMT_YUYV
                        return
                    raise OSError(errno.EINVAL, "fmt")
                pix.width, pix.height = self.adjust or (self.w, self.h)
            elif request == V.VIDIOC_S_PARM:
                self.fps = arg.parm.capture.timeperframe.denominator
            elif request == V.VIDIOC_REQBUFS:
                arg.count = self.n_buffers
            elif request == V.VIDIOC_QUERYBUF:
                arg.length = max(self.w * self.h * 2, 1 << 16)
                arg.m.offset = 65536 * arg.index
            elif request == V.VIDIOC_QBUF:
                assert arg.index not in self.queued, "double QBUF"
                self.queued.append(arg.index)
            elif request == V.VIDIOC_STREAMON:
                self.streaming = True
            elif request == V.VIDIOC_STREAMOFF:
                self.streaming = False
            elif request == V.VIDIOC_DQBUF:
                assert self.streaming, "DQBUF before STREAMON"
                if not self.pending:
                    raise OSError(errno.EAGAIN, "no frame")
                idx, payload = self.pending.pop(0)
                self.queued.remove(idx)
                self.mem[65536 * idx][:len(payload)] = payload
                arg.index = idx
                arg.bytesused = len(payload)
            else:
                raise OSError(errno.ENOTTY, f"unexpected ioctl {request:#x}")

        def push_frame(self, payload: bytes, index: int | None = None):
            self.pending.append((index if index is not None
                                 else self.queued[0], payload))

    return FakeSys()


def _jpeg(rgb):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=95)
    return buf.getvalue()


def _negotiation(V):
    out = []
    s = fake_sys(V)
    cam = V.RawV4L2Camera("/dev/video9", 32, 8, 15, "mjpeg", sys=s)
    out += [cam.format, (cam.width, cam.height), s.streaming, len(s.queued)]
    cam.close()
    out += [s.streaming, s.log]
    out.append(V.RawV4L2Camera("/dev/video9", 32, 8, 15, "mjpeg",
                               sys=fake_sys(V, substitute_fmt=True)).format)
    cam = V.RawV4L2Camera("/dev/video9", 32, 8, 15, "yuyv",
                          sys=fake_sys(V, adjust=(64, 16)))
    out.append((cam.width, cam.height))
    for kw in ({"caps": V.CAP_STREAMING}, {"caps": V.CAP_VIDEO_CAPTURE},
               {"n_buffers": 1}):
        with pytest.raises(V.V4L2Error) as e:
            V.RawV4L2Camera(sys=fake_sys(V, **kw))
        out.append(str(e.value))
    return out


def _frames(V):
    out = []
    s = fake_sys(V)
    cam = V.RawV4L2Camera("/dev/video9", 32, 8, 15, "yuyv", sys=s)
    yuyv = np.random.default_rng(0).integers(0, 256, 32 * 8 * 2, np.uint8)
    s.push_frame(yuyv.tobytes())
    out += [cam.read(eagain_spins=3), sorted(s.queued)]
    out += [cam.read(eagain_spins=2), s.streaming]          # EAGAIN
    s.queued.append(9)
    s.mem[65536 * 9] = bytearray(32 * 8 * 2)
    s.push_frame(b"x" * 64, index=9)
    out.append(cam.read(eagain_spins=2))                    # index guard
    s = fake_sys(V, mjpeg_ok=True)
    cam = V.RawV4L2Camera("/dev/video9", 32, 8, 15, "mjpeg", sys=s)
    rgb = np.zeros((8, 32, 3), np.uint8)
    rgb[:, :16] = (255, 0, 0)
    s.push_frame(_jpeg(rgb))
    out += [cam.format, cam.read(eagain_spins=3)]
    s.push_frame(_jpeg(np.zeros((4, 16, 3), np.uint8)))     # wrong size
    out += [cam.read(eagain_spins=3), sorted(s.queued)]
    return out


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def test_v4l2_negotiation_as_yolotpu():
    got, want = _negotiation(v4l2), _negotiation(jv4l2)
    assert len(got) == len(want) and all(map(_same, got, want))
    assert got[:5] == ["yuyv", (32, 8), True, 4, False]
    assert got[6:8] == ["yuyv", (64, 16)]


def test_v4l2_frames_as_yolotpu():
    got, want = _frames(v4l2), _frames(jv4l2)
    assert len(got) == len(want) and all(map(_same, got, want))
    yuyv = np.random.default_rng(0).integers(0, 256, 32 * 8 * 2, np.uint8)
    assert np.array_equal(got[0], camera.yuyv_to_rgb(yuyv, 32, 8))
    assert got[1] == [0, 1, 2, 3] and got[2] is None and got[4] is None
    assert got[5] == "mjpeg" and got[6][:, :8, 0].mean() > 200
    assert got[7] is None and got[8] == [0, 1, 2, 3]


def test_v4l2_struct_layouts_equal():
    for name in ("Capability", "PixFormat", "Format", "RequestBuffers",
                 "Buffer", "StreamParm"):
        assert (ctypes.sizeof(getattr(v4l2, name))
                == ctypes.sizeof(getattr(jv4l2, name))), name
    for name in ("VIDIOC_QUERYCAP", "VIDIOC_S_FMT", "VIDIOC_REQBUFS",
                 "VIDIOC_QUERYBUF", "VIDIOC_QBUF", "VIDIOC_DQBUF",
                 "VIDIOC_STREAMON", "VIDIOC_STREAMOFF", "VIDIOC_S_PARM"):
        assert getattr(v4l2, name) == getattr(jv4l2, name), name
