"""The host functions that the reference's own tests use, in the port
against yolotpu, on the CPU: image.resize_image_scalar,
postprocess.box_iou, quant.dequantize_tensor, golden.reorg_index_math (all
numpy, equal), ops/region.activated_head (PyTorch against JAX, within
float32 tolerance: rtol 1e-5, atol 1e-6, the sigmoid and softmax of two
libraries), names.write_names and zoo.to_cfg (equal text)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolotpu import golden as jgolden
from yolotpu import image as jimage
from yolotpu import names as jnames
from yolotpu import postprocess as jpost
from yolotpu import quant as jquant
from yolotpu.graph import RegionSpec as JRegion
from yolotpu.models import zoo as jzoo
from yolotpu.ops import region as jregion
from yolotpu_torch import golden, image, names, postprocess, quant
from yolotpu_torch.graph import NetworkSpec, RegionSpec
from yolotpu_torch.models import zoo
from yolotpu_torch.ops import region


@pytest.mark.parametrize("shape", [(3, 7, 9, 13, 5), (3, 20, 15, 32, 32),
                                   (1, 1, 8, 4, 4), (3, 9, 1, 6, 3),
                                   (3, 12, 10, 1, 1)])
def test_resize_image_scalar_equal(shape):
    c, sh, sw, th, tw = shape
    im = np.random.default_rng(0).random((c, sh, sw)).astype(np.float32)
    got = image.resize_image_scalar(im, tw, th)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jimage.resize_image_scalar(im, tw, th))
    np.testing.assert_allclose(got, image.resize_image(im, tw, th), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("a,b", [
    ((0.5, 0.5, 0.2, 0.2), (0.5, 0.5, 0.2, 0.2)),
    ((0.1, 0.1, 0.1, 0.1), (0.9, 0.9, 0.1, 0.1)),
    ((0.5, 0.5, 0.4, 0.2), (0.6, 0.55, 0.3, 0.3)),
    ((0.5, 0.5, 0.0, 0.0), (0.5, 0.5, 0.0, 0.0)),
    ((0.3, 0.3, 0.2, 0.2), (0.5, 0.3, 0.2, 0.2)),
])
def test_box_iou_equal(a, b):
    assert postprocess.box_iou(a, b) == jpost.box_iou(a, b)
    assert postprocess.box_iou(np.float32(a), np.float32(b)) == jpost.box_iou(
        np.float32(a), np.float32(b))


@pytest.mark.parametrize("q", [-3, 0, 5, 15, 20])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_dequantize_tensor_equal(q, dtype):
    info = np.iinfo(dtype)
    x = np.random.default_rng(1).integers(info.min, info.max, (7, 5),
                                          dtype=dtype)
    got = quant.dequantize_tensor(x, q)
    assert got.dtype == np.float32
    assert got.tobytes() == jquant.dequantize_tensor(x, q).tobytes()


@pytest.mark.parametrize("c,h,w,s", [(64, 26, 26, 2), (4, 416, 26, 2),
                                     (16, 8, 8, 2), (36, 12, 6, 3)])
def test_reorg_index_math_equal(c, h, w, s):
    x = np.random.default_rng(2).standard_normal((c, h, w)).astype(np.float32)
    got = golden.reorg_index_math(x, w=w, h=h, c=c, stride=s)
    np.testing.assert_array_equal(
        got, jgolden.reorg_index_math(x, w=w, h=h, c=c, stride=s))
    if (c, h, w) != (4, 416, 26):   # that one is the reference's call
        np.testing.assert_array_equal(golden.reorg_darknet(x, s).reshape(-1),
                                      got)


@pytest.mark.parametrize("softmax,background", [(True, False), (False, False),
                                                (True, True), (False, True)])
def test_activated_head_close_to_jax(softmax, background):
    kw = dict(idx=0, h=3, w=4, c=2 * 8, out_h=3, out_w=4, out_c=2 * 8, num=2,
              classes=3, coords=4, softmax=softmax, background=background,
              biases=(1.0, 2.0, 3.0, 1.5))
    head = np.random.default_rng(3).standard_normal((2, 3, 4, 16)).astype(
        np.float32) * 4
    got = region.activated_head(torch.from_numpy(head), RegionSpec(**kw))
    want = np.asarray(jregion.activated_head(jnp.asarray(head), JRegion(**kw)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_write_names_and_to_cfg_equal(tmp_path):
    labels = names.names_for(80)
    names.write_names(labels, str(tmp_path / "t.names"))
    jnames.write_names(labels, str(tmp_path / "j.names"))
    assert (tmp_path / "t.names").read_bytes() == (tmp_path / "j.names").read_bytes()
    assert names.load_names(str(tmp_path / "t.names")) == labels
    for name in zoo.MODELS:
        text = zoo.to_cfg(name)
        assert text == jzoo.to_cfg(name)
        p = tmp_path / f"{name}.cfg"
        p.write_text(text)
        spec = NetworkSpec.from_cfg(str(p))
        want = zoo.build(name)
        assert [(l.type, l.out_h, l.out_w, l.out_c) for l in spec.layers] == [
            (l.type, l.out_h, l.out_w, l.out_c) for l in want.layers]
