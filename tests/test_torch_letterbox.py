"""The port's on-device letterbox (``yolotpu_torch.ops.letterbox``) against
the JAX package's ``device_letterbox`` and the port's host
``image.letterbox_image``, on the CPU: bit for bit, in the five cases of
tests/test_device_letterbox.py; and the engine's raw-frame entry point
against its host-letterbox path."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yolotpu.ops import letterbox as jletterbox
from yolotpu_torch.image import letterbox_image
from yolotpu_torch.models import zoo
from yolotpu_torch.ops import letterbox
from yolotpu_torch.runtime.engine import Engine, load_or_synthesize

# (frames (B, H, W), net size): wide, tall, upscale, exact fit, small net
CASES = [((2, 480, 640), 416), ((2, 640, 360), 416), ((2, 216, 216), 416),
         ((2, 416, 416), 416), ((1, 48, 64), 64)]


def _frames(shape) -> np.ndarray:
    b, h, w = shape
    return np.random.default_rng(h * 1000 + w).integers(
        0, 256, (b, h, w, 3), np.uint8)


@pytest.mark.parametrize("shape,net", CASES,
                         ids=[f"{s[1]}x{s[2]}->{n}" for s, n in CASES])
def test_device_letterbox_bitexact(shape, net):
    u8 = _frames(shape)
    got = letterbox.device_letterbox(torch.from_numpy(u8), net, net).numpy()
    want = np.asarray(jletterbox.device_letterbox(jnp.asarray(u8), net, net))
    np.testing.assert_array_equal(got, want)
    for i in range(shape[0]):
        chw = (u8[i].astype(np.float32) / 255.0).transpose(2, 0, 1)
        np.testing.assert_array_equal(got[i].transpose(2, 0, 1),
                                      letterbox_image(chw, net, net))


def test_device_letterbox_takes_float_frames():
    u8 = _frames((1, 48, 64))
    f = u8.astype(np.float32) / np.float32(255)
    got = letterbox.device_letterbox(torch.from_numpy(f), 64, 64).numpy()
    want = np.asarray(jletterbox.device_letterbox(jnp.asarray(f), 64, 64))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dst,src", [(1, 7), (7, 1), (1, 1), (416, 640),
                                     (312, 480), (416, 216), (5, 5)])
@pytest.mark.parametrize("vertical", [False, True])
def test_axis_taps_equal_yolotpu(dst, src, vertical):
    for got, want in zip(letterbox._axis_taps(dst, src, vertical),
                         jletterbox._axis_taps(dst, src, vertical)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@functools.cache
def _engine(precision: str) -> Engine:
    spec = zoo.build("yolov2", width=64, height=64)
    store = load_or_synthesize(spec, None, precision, synthetic=True, seed=0)
    return Engine(spec, store, precision, device="cpu")


@pytest.mark.parametrize("precision", ["fp32", "int16"])
def test_raw_frames_equal_the_host_letterbox_path(precision):
    """predict_batch_raw_frames (letterbox on the device) gives the heads of
    predict_batch on host-letterboxed frames, bit for bit."""
    eng = _engine(precision)
    frames = np.random.default_rng(7).integers(0, 256, (2, 48, 80, 3),
                                               np.uint8)
    got = eng.predict_batch_raw_frames(frames)
    boxed = np.stack([letterbox_image(
        (f.astype(np.float32) / np.float32(255)).transpose(2, 0, 1), 64, 64)
        for f in frames])
    np.testing.assert_array_equal(got, eng.predict_batch(boxed))
    assert not eng.graphs   # nothing is captured on the CPU
    with pytest.raises(TypeError, match="uint8"):
        eng.predict_batch_raw_frames(frames.astype(np.float32))
