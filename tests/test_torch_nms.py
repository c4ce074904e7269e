"""The port's on-device class-wise NMS (``yolotpu_torch.ops.nms``, the plain
version of the ``nms_greedy`` kernel here) against the JAX package's
``ops.nms`` on the same inputs, on the CPU: the selected boxes and scores
bit for bit, the classes, valid flags and saturation flags equal, in the
scenes of tests/test_nms_eval.py and in scenes of tied scores; then the
engine's device-NMS path against its host path and the JAX engine's."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yolotpu.models import zoo as jzoo
from yolotpu.ops import nms as jnms
from yolotpu.runtime.engine import Engine as JaxEngine
from yolotpu.runtime.engine import load_or_synthesize as jax_store
from yolotpu_torch.models import zoo
from yolotpu_torch.ops import _build, nms
from yolotpu_torch.runtime.engine import Engine, load_or_synthesize


def _random_scene(rng, n=40, classes=5):
    boxes = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n),
                      rng.uniform(0.05, 0.3, n), rng.uniform(0.05, 0.3, n)],
                     axis=1).astype(np.float32)
    obj = rng.uniform(0, 1, n).astype(np.float32)
    probs = rng.dirichlet(np.ones(classes), n).astype(np.float32)
    return boxes, obj, probs


def _dense_scene():
    """tests/test_nms_eval.py's dense scene: 400 small boxes, half of them
    over the threshold."""
    rng = np.random.default_rng(42)
    n, classes = 400, 8
    boxes, obj, probs = _random_scene(rng, n=n, classes=classes)
    boxes[:, 2:] = rng.uniform(0.02, 0.08, (n, 2))
    probs = np.full((n, classes), 0.1 / (classes - 1), np.float32)
    probs[np.arange(n), rng.integers(0, classes, n)] = 0.9
    obj = np.where(np.arange(n) % 2 == 0, rng.uniform(0.5, 1.0, n),
                   rng.uniform(0.0, 0.25, n)).astype(np.float32)
    return boxes, obj, probs


def _tied_scene():
    """Quantized heads give equal scores: objectness on a coarse grid (ties
    at the top-K cut too), class probabilities in ties across classes and
    boxes, and overlapping boxes in clusters, so the order of equal scores
    decides what survives."""
    rng = np.random.default_rng(3)
    n, classes = 60, 4
    centers = rng.uniform(0.3, 0.7, (6, 2))
    boxes = np.concatenate([
        centers[rng.integers(0, 6, n)] + rng.uniform(-0.02, 0.02, (n, 2)),
        rng.choice([0.2, 0.25], (n, 2))], axis=1).astype(np.float32)
    obj = rng.choice([0.0, 0.5, 0.75, 1.0], n).astype(np.float32)
    probs = rng.choice([0.25, 0.5], (n, classes)).astype(np.float32)
    return boxes, obj, probs


def _basic_scene():
    boxes = np.asarray([[0.5, 0.5, 0.4, 0.4], [0.52, 0.5, 0.4, 0.4],
                        [0.9, 0.9, 0.1, 0.1]], np.float32)
    obj = np.asarray([0.9, 0.8, 0.7], np.float32)
    probs = np.asarray([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    return boxes, obj, probs


# name -> (scene maker, thresh, nms thresh, topk, saturated)
SCENES = {
    "random": (lambda: _random_scene(np.random.default_rng(0)), 0.2, 0.45, 40,
               False),
    "basic": (_basic_scene, 0.3, 0.45, 3, False),
    "dense-k256": (_dense_scene, 0.3, 0.45, 256, False),
    "dense-k64": (_dense_scene, 0.3, 0.45, 64, True),
    "tied-k40": (_tied_scene, 0.1, 0.3, 40, True),   # the cut falls in a tie
    "tied-k-equals-n": (_tied_scene, 0.1, 0.5, 60, False),
}


def _batch(scene):
    """Three frames: the scene, its reverse, and the scene with its boxes
    shifted, so the batch dimension is exercised."""
    boxes, obj, probs = scene
    boxes2 = boxes.copy()
    boxes2[:, :2] += 0.01
    return (np.stack([boxes, boxes[::-1], boxes2]),
            np.stack([obj, obj[::-1], obj]),
            np.stack([probs, probs[::-1], probs]))


@pytest.mark.parametrize("name", SCENES)
def test_topk_decode_nms_equals_yolotpu(name):
    make, thresh, nt, topk, saturated = SCENES[name]
    boxes, obj, probs = _batch(make())
    got = nms.topk_decode_nms(*map(torch.from_numpy, (boxes, obj, probs)),
                              thresh, nt, topk)
    want = jnms.topk_decode_nms(*map(jnp.asarray, (boxes, obj, probs)),
                                thresh, nt, topk)
    for g, w, what in zip(got, want, ("boxes", "scores", "classes", "valid",
                                      "saturated")):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, what
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    assert got[4].tolist() == [saturated] * 3
    assert got[3].sum() > 0


def test_ties_decide_what_survives():
    """In the tied scene the order among equal scores changes the result
    (so the stable sorts are what makes it equal to JAX's)."""
    boxes, obj, probs = _tied_scene()
    cprob = torch.from_numpy(probs * obj[:, None])[None]
    ious = nms.box_iou_matrix(*[torch.from_numpy(boxes)[None]] * 2)
    kept = nms.nms_greedy_plain(cprob, ious, 0.3)
    rev = nms.nms_greedy_plain(cprob.flip(1), ious.flip(1, 2), 0.3).flip(1)
    assert not torch.equal(kept, rev)


def test_box_iou_matrix_equals_yolotpu():
    boxes, _, _ = _random_scene(np.random.default_rng(5), n=30)
    got = nms.box_iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes))
    want = np.asarray(jnms.box_iou_matrix(jnp.asarray(boxes),
                                          jnp.asarray(boxes)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=1e-6)
    assert torch.equal(got, got.T)   # the scan's orientation does not matter


def test_greedy_nms_mask_equals_yolotpu():
    rng = np.random.default_rng(9)
    boxes, obj, _ = _random_scene(rng, n=32)
    order = np.argsort(-obj, kind="stable")
    scores = np.where(obj > 0.3, obj, 0)[order].astype(np.float32)
    ious = np.array(jnms.box_iou_matrix(jnp.asarray(boxes[order]),
                                        jnp.asarray(boxes[order])))
    for thresh in (0.1, 0.45, 0.9):
        got = nms.greedy_nms_mask(torch.from_numpy(ious),
                                  torch.from_numpy(scores), thresh)
        want = jnms.greedy_nms_mask(jnp.asarray(ious), jnp.asarray(scores),
                                    thresh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nms_greedy_card_branch(monkeypatch):
    """The wrapper's card branch, reached with tensors on the meta device and
    the launch recorded instead of made: it hands the C entry point cprob,
    ious, out, B, K, C and the threshold (the stream is added by
    _build.launch), and refuses K over MAX_K and non-float operands."""
    calls = []
    monkeypatch.setattr(nms, "_check", lambda *a: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, out, *args, counts: calls.append(
                            (name, fn, out, args)) or out)
    cprob = torch.empty((2, 256, 80), device="meta")
    ious = torch.empty((2, 256, 256), device="meta")
    out = nms.nms_greedy(cprob, ious, 0.45)
    assert out.shape == cprob.shape and out.dtype == torch.float32
    (name, fn, _, args), = calls
    assert (name, fn) == ("nms_greedy", "yq_nms_greedy")
    assert len(args) == len(_build.SIGNATURES[fn]) - 1
    assert args[3:] == (2, 256, 80, 0.45)
    with pytest.raises(ValueError, match="K=1025"):
        nms.nms_greedy(torch.empty((1, 1025, 3), device="meta"),
                       torch.empty((1, 1025, 1025), device="meta"), 0.5)
    monkeypatch.undo()
    with pytest.raises(TypeError, match="float32"):
        nms.nms_greedy(torch.zeros((1, 4, 2), dtype=torch.float64),
                       torch.zeros((1, 4, 4), dtype=torch.float64), 0.5)
    with pytest.raises(ValueError, match="want"):
        nms.nms_greedy(torch.zeros((1, 4, 2)), torch.zeros((1, 4, 3)), 0.5)
    assert nms.LAUNCHES["nms_greedy"] == 0


def _kept(dets, thresh) -> list[tuple]:
    """(class, score, box) of each detection whose best class is over the
    threshold, by class and score."""
    return sorted((*d.best_class(), *d.bbox) for d in dets
                  if d.best_class()[1] > thresh)


def _assert_same(got: list, want: list) -> None:
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want],
                               rtol=1e-4, atol=1e-6)


@functools.cache
def _engines(precision: str):
    """The port's engine with device NMS, and the JAX engine's, on one
    store each (equal, test_torch_host), at a low threshold so that many
    boxes of many classes reach the NMS (yolov2-tiny at 96: 45 boxes)."""
    spec = zoo.build("yolov2-tiny", width=96, height=96)
    store = load_or_synthesize(spec, None, precision, synthetic=True, seed=0)
    jspec = jzoo.build("yolov2-tiny", width=96, height=96)
    jstore = jax_store(jspec, None, precision, synthetic=True, seed=0)
    return (Engine(spec, store, precision, device="cpu", device_nms=True,
                   thresh=0.01, nms=0.45),
            JaxEngine(jspec, jstore, precision, backend="xla",
                      device_nms=True, thresh=0.01, nms=0.45, warmup=False))


@pytest.mark.parametrize("precision", ["fp32", "int16"])
def test_detect_device_equals_detect_and_yolotpu(precision, monkeypatch):
    """As tests/test_nms_eval.py holds the JAX engine's two paths: the same
    kept detections, classes equal, scores and boxes within rtol 1e-4 (the
    decode's sigmoid, exp and softmax are numpy's on the host path,
    PyTorch's and XLA's on the device paths, a few ulp apart; in fp32 the
    heads differ by the convs' summation order too)."""
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    eng, jeng = _engines(precision)
    img = np.random.default_rng(3).random((3, 96, 128)).astype(np.float32)
    dev, _ = eng.detect_device(img)
    host, _ = eng.detect(img, 0.01, 0.45)
    jdev, _ = jeng.detect_device(img)
    got = _kept(dev, 0.01)
    assert len(got) > 3
    assert len({g[0] for g in got}) > 1   # several classes
    _assert_same(got, _kept(host, 0.01))
    _assert_same(got, _kept(jdev, 0.01))


def test_device_nms_tables_of_a_batch():
    """predict_batch_detections on uint8 frames and on float frames, and
    the raw-frame path with device NMS, give one top-K table per frame."""
    eng, _ = _engines("int16")
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (2, 96, 96, 3), np.uint8)
    sb, ss, sc, sv = eng.predict_batch_detections(u8)
    assert sb.shape == (2, 45, 4) and ss.shape == sc.shape == sv.shape == (2, 45)
    f = u8.transpose(0, 3, 1, 2) / np.float32(255)
    for a, b in zip((sb, ss, sc, sv), eng.predict_batch_detections(f)):
        np.testing.assert_array_equal(a, b)
    raw = eng.predict_batch_raw_frames(rng.integers(0, 256, (2, 48, 80, 3),
                                                    np.uint8))
    assert [t.shape for t in raw] == [(2, 45, 4), (2, 45), (2, 45), (2, 45)]
    host = Engine(eng.spec, eng.store, "int16", device="cpu")
    with pytest.raises(ValueError, match="device_nms"):
        host.predict_batch_detections(u8)
