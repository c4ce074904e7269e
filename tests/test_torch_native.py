"""The port's native preprocessing library (yolotpu_torch.native) against
yolotpu.native, function for function, bit for bit, on seeded inputs; its
build (keyed by the source, atomic when built by several at once) and its
refusal without g++."""

import threading

import numpy as np
import pytest

from yolotpu import native as jnative
from yolotpu_torch import golden, image, native
from yolotpu_torch.runtime.camera import yuyv_to_rgb


@pytest.fixture
def libs():
    if not (native.available() and jnative.available()):
        pytest.skip("g++ cannot build the native libraries here")


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_hwc_to_chw(libs):
    rgb = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    _equal(native.hwc_to_chw(rgb), jnative.hwc_to_chw(rgb))
    _equal(native.hwc_to_chw(rgb),
           (rgb.astype(np.float32) / 255.0).transpose(2, 0, 1))


@pytest.mark.parametrize("sh,sw,dh,dw", [(48, 64, 416, 312), (576, 768, 312, 416),
                                         (10, 10, 31, 7), (216, 216, 416, 416)])
def test_resize(libs, sh, sw, dh, dw):
    im = np.random.default_rng(1).random((3, sh, sw)).astype(np.float32)
    _equal(native.resize(im, dw, dh), jnative.resize(im, dw, dh))
    _equal(native.resize(im, dw, dh), image.resize_image(im, dw, dh))


@pytest.mark.parametrize("sh,sw", [(576, 768), (768, 576), (100, 100)])
def test_letterbox(libs, sh, sw):
    im = np.random.default_rng(2).random((3, sh, sw)).astype(np.float32)
    _equal(native.letterbox(im, 416, 416), jnative.letterbox(im, 416, 416))
    _equal(native.letterbox(im, 416, 416), image.letterbox_image(im, 416, 416))


@pytest.mark.parametrize("h,w,net", [(480, 640, 416), (48, 80, 64), (64, 64, 64)])
def test_frame_to_input(libs, h, w, net):
    rgb = np.random.default_rng(3).integers(0, 256, (h, w, 3), np.uint8)
    _equal(native.frame_to_input(rgb, net, net),
           jnative.frame_to_input(rgb, net, net))


def test_yuyv_to_rgb(libs):
    yuyv = np.random.default_rng(4).integers(0, 256, (64 * 32 * 2,), np.uint8)
    _equal(native.yuyv_to_rgb(yuyv, 64, 32), jnative.yuyv_to_rgb(yuyv, 64, 32))
    _equal(native.yuyv_to_rgb(yuyv, 64, 32), yuyv_to_rgb(yuyv, 64, 32))


@pytest.mark.parametrize("q", [0, 7, 13, -2])
def test_quantize_int16(libs, q):
    x = (np.random.default_rng(5).standard_normal(10000) * 3).astype(np.float32)
    x[:2] = [0.5, -0.5]
    _equal(native.quantize_int16(x, q), jnative.quantize_int16(x, q))
    _equal(native.quantize_int16(x, q), golden.quantize_fp32_to_int16(x, q))


def test_builds_atomically_under_a_source_digest(libs, tmp_path, monkeypatch):
    """Builders started together (as pytest-xdist workers may) leave one
    library under the source's digest and no temporary directory."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    out = tmp_path / native._digest() / native.LIB_NAME
    errors = []

    def build():
        try:
            native._build(out)
        except Exception as e:  # reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert [p.name for p in out.parent.iterdir()] == [native.LIB_NAME]
    assert native.load()._name == str(out)


def test_refuses_without_gxx(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeUnavailable, match="cannot build"):
        native.load()
    assert not native.available()
