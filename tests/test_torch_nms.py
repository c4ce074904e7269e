"""The port's on-device class-wise NMS (``yolotpu_torch.ops.nms``, the plain
version of the ``nms_greedy`` kernel here) against the JAX package's
``ops.nms`` on the same inputs, on the CPU: the selected boxes and scores
bit for bit, the classes, valid flags and saturation flags equal, in the
scenes of tests/test_nms_eval.py and in scenes of tied scores; a numpy
model of the kernel's algorithm (bit table, live-box compaction, ranks by
counting, bitmask walk) against the JAX package's greedy scan; then the
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
    cboxes = torch.from_numpy(boxes)[None]
    kept = nms.nms_greedy_plain(cprob, cboxes, 0.3)
    rev = nms.nms_greedy_plain(cprob.flip(1), cboxes.flip(1), 0.3).flip(1)
    assert not torch.equal(kept, rev)


def _jax_class_wise(cprob: np.ndarray, cboxes: np.ndarray,
                    thresh: float) -> np.ndarray:
    """The JAX package's per-class path (``one_class`` of
    ``topk_decode_nms``) frame by frame and class by class: its IoU matrix,
    ``jnp.argsort(-s)``, ``greedy_nms_mask``, scattered back."""
    out = np.zeros_like(cprob)
    for b in range(cprob.shape[0]):
        ious = jnms.box_iou_matrix(jnp.asarray(cboxes[b]),
                                   jnp.asarray(cboxes[b]))
        for c in range(cprob.shape[2]):
            scores = jnp.asarray(cprob[b, :, c])
            order = jnp.argsort(-scores)
            keep_sorted = jnms.greedy_nms_mask(ious[order][:, order],
                                               scores[order], thresh)
            keep = np.zeros(len(order), bool)
            keep[np.asarray(order)] = np.asarray(keep_sorted)
            out[b, :, c] = np.where(keep, cprob[b, :, c], 0)
    return out


@pytest.mark.parametrize("name", ["random", "dense-k256", "tied-k40"])
def test_nms_greedy_plain_equals_yolotpu_class_wise(name):
    """nms_greedy_plain(cprob, cboxes, t), which builds its IoU matrix from
    the boxes, equals the JAX package's per-class path bit for bit on the
    candidate tables of the scenes."""
    make, thresh, nt, topk, _ = SCENES[name]
    boxes, obj, probs = _batch(make())
    cboxes, cprob, _ = nms.candidates(*map(torch.from_numpy,
                                           (boxes, obj, probs)), thresh, topk)
    got = nms.nms_greedy_plain(cprob, cboxes, nt).numpy()
    want = _jax_class_wise(cprob.numpy(), cboxes.numpy(), nt)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).sum() < (cprob > 0).sum().item()


def _iou_f32(boxes: np.ndarray) -> np.ndarray:
    """box_iou_matrix in numpy float32, one rounding per operation, in the
    kernel's order: corners cx -+ w/2, the clamped overlap, inter = iw*ih,
    (area_a + area_b) - inter, inter / max(union, 1e-12)."""
    cx, cy, w, h = boxes.astype(np.float32).T
    hw, hh = w * np.float32(0.5), h * np.float32(0.5)
    x0, y0, x1, y1 = cx - hw, cy - hh, cx + hw, cy + hh
    zero = np.float32(0)
    iw = np.maximum(np.minimum(x1[:, None], x1[None]) -
                    np.maximum(x0[:, None], x0[None]), zero)
    ih = np.maximum(np.minimum(y1[:, None], y1[None]) -
                    np.maximum(y0[:, None], y0[None]), zero)
    inter = iw * ih
    area = w * h
    union = (area[:, None] + area[None]) - inter
    return inter / np.maximum(union, np.float32(1e-12))


def _kernel_model(scores: np.ndarray, boxes: np.ndarray,
                  thresh: float) -> tuple[np.ndarray, int]:
    """numpy model of csrc/nms_greedy.cu for one frame and class: the packed
    K x ceil(K/32) table of iou > thresh, the live boxes compacted in index
    order 32 at a time (a ballot and its popcount), their ranks by counting
    (scores descending, ties by index), and the walk in rank order over a
    removed mask of one 32-bit word per lane, each kept box's row ORed in.
    Returns the keep mask and the walk's steps."""
    k = len(scores)
    words = (k + 31) // 32
    hit = np.zeros((k, 32 * words), bool)
    hit[:, :k] = _iou_f32(boxes) > np.float32(thresh)
    table = np.packbits(hit.reshape(k, words, 32), axis=-1,
                        bitorder="little").view("<u4")[..., 0]
    score, index = [], []
    for k0 in range(0, k, 32):
        chunk = scores[k0:k0 + 32]
        lanes = np.flatnonzero(chunk > 0)          # the ballot's set bits
        score += list(chunk[lanes])
        index += list(k0 + lanes)
    n = len(index)
    score = np.asarray(score, np.float32)
    order = np.zeros(n, int)
    for i in range(n):
        j = np.arange(n)
        rank = int(((score > score[i]) | ((score == score[i]) & (j < i))).sum())
        order[rank] = index[i]
    removed = np.zeros(32, np.uint32)
    kept = np.zeros(32, np.uint32)
    for box in order:
        if not (int(removed[box >> 5]) >> (box & 31)) & 1:
            removed[:words] |= table[box]
            kept[box >> 5] |= np.uint32(1 << (box & 31))
    bits = np.unpackbits(kept.view(np.uint8), bitorder="little")[:k]
    return bits.astype(bool), n


def _model_scene(kind: str, k: int):
    """(scores, boxes, thresh) of one class: "random" boxes with a third of
    the scores 0; "empty", no live box; "ties", scores on a coarse grid over
    overlapping clusters; "crowd", every box live and crowded together, so
    most are suppressed; "near", _near_scene's pairs, whose second box
    survives or not by the last bit of their IoU."""
    rng = np.random.default_rng(k + len(kind))
    boxes = np.stack([rng.uniform(0.1, 0.9, k), rng.uniform(0.1, 0.9, k),
                      rng.uniform(0.05, 0.4, k), rng.uniform(0.05, 0.4, k)],
                     1).astype(np.float32)
    scores = np.where(rng.random(k) < 1 / 3, 0,
                      rng.uniform(0.3, 1, k)).astype(np.float32)
    if kind == "empty":
        scores[:] = 0
    elif kind == "ties":
        centers = rng.uniform(0.3, 0.7, (8, 2))
        boxes[:, :2] = centers[rng.integers(0, 8, k)] + rng.uniform(
            -0.03, 0.03, (k, 2))
        scores = rng.choice([0, 0.25, 0.5, 0.75], k).astype(np.float32)
    elif kind == "crowd":
        boxes[:, :2] = rng.uniform(0.45, 0.55, (k, 2))
        scores = rng.uniform(0.3, 1, k).astype(np.float32)
    elif kind == "near":   # pairs at the threshold, the first box ahead
        boxes = _near_scene(k // 2)
        scores = np.repeat(rng.uniform(0.5, 1, k // 2), 2).astype(np.float32)
        scores[1::2] -= np.float32(1e-3)
    return scores, boxes, 0.45


@pytest.mark.parametrize("kind,k", [
    ("random", 1), ("random", 31), ("random", 32), ("random", 33),
    ("random", 256), ("random", 845), ("empty", 256), ("ties", 256),
    ("crowd", 256), ("near", 256)])
def test_kernel_model_equals_greedy_nms_mask(kind, k):
    """The kernel's algorithm, modelled in numpy, keeps what the JAX
    package's greedy scan keeps (over the scores in jnp.argsort(-s) order
    and its IoU matrix), and walks only the live boxes. The kernel cannot
    run on the CPU: this is the CPU's hold on its logic."""
    scores, boxes, thresh = _model_scene(kind, k)
    got, steps = _kernel_model(scores, boxes, thresh)
    order = np.asarray(jnp.argsort(-jnp.asarray(scores)))
    ious = jnms.box_iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes))
    keep_sorted = jnms.greedy_nms_mask(ious[order][:, order],
                                       jnp.asarray(scores[order]), thresh)
    want = np.zeros(k, bool)
    want[order] = np.asarray(keep_sorted)
    np.testing.assert_array_equal(got, want)
    assert steps == (scores > 0).sum()
    if kind == "empty":
        assert steps == 0 and not got.any()
    elif k >= 256:
        assert 0 < got.sum() < steps
    if kind == "crowd":
        assert got.sum() < steps / 4


def _near_scene(pairs: int) -> np.ndarray:
    """Boxes in pairs whose IoU is the threshold in exact arithmetic: equal
    heights, widths 29m and shifts 11m units of 2^-20 (so (w - d) / (w + d)
    = 18/40 = 0.45), every coordinate a multiple of 2^-20, each pair alone in
    its cell of the frame. Only the float32 roundings of the products, the
    union and the quotient decide whether iou > 0.45."""
    rng = np.random.default_rng(pairs)
    unit = 2.0 ** -20
    g = int(np.ceil(np.sqrt(pairs)))
    cell = int(0.8 / g / unit)        # the room a pair may take, in units
    cells = np.arange(pairs)
    cx = np.round(((cells % g) + 0.1) / g / unit)
    cy = np.round(((cells // g) + 0.5) / g / unit)
    m = rng.integers(cell // 80, cell // 40, pairs)
    w, d = 29 * m, 11 * m             # the pair spans 40m <= cell
    h = 2 * rng.integers(cell // 8, cell // 2, pairs)
    a = np.stack([cx, cy, w, h], 1)
    b = np.stack([cx + d, cy, w, h], 1)
    return (np.stack([a, b], 1).reshape(-1, 4) * unit).astype(np.float32)


def test_near_threshold_scene_tells_contraction_apart():
    """The boxes that chip_smoke.py's near-threshold case builds: the
    kernel's IoU order (numpy, one rounding per operation) is
    box_iou_matrix's bit for bit; many pairs lie within 4 ulp of the
    threshold, on both sides of it; and a union computed with FMA
    contraction (what nvcc's default -fmad=true would do to area_a*... +
    area_b - inter) moves some pairs across it."""
    thresh = np.float32(0.45)
    boxes = _near_scene(128)
    ious = _iou_f32(boxes)
    want = nms.box_iou_matrix(torch.from_numpy(boxes),
                              torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(ious.view(np.int32), want.view(np.int32))
    pair = ious[np.arange(0, 256, 2), np.arange(1, 256, 2)]
    ulp = np.spacing(thresh)
    near = np.abs(pair - thresh) <= 4 * ulp
    assert near.sum() >= 100
    assert 10 <= (pair[near] > thresh).sum() <= near.sum() - 10
    off = np.ones_like(ious, bool)
    off[np.arange(0, 256, 2), np.arange(1, 256, 2)] = False
    off[np.arange(1, 256, 2), np.arange(0, 256, 2)] = False
    np.fill_diagonal(off, False)
    assert not ious[off].any()   # the pairs do not touch each other
    # an FMA-contracted union: fma(w_a, h_a, area_b) then fma(-iw, ih, s)
    a, b = boxes[0::2].astype(np.float64), boxes[1::2].astype(np.float64)
    cx0, cx1 = boxes[0::2, 0], boxes[1::2, 0]
    hw = boxes[0::2, 2] * np.float32(0.5)
    iw = np.maximum(np.minimum(cx0 + hw, cx1 + hw) -
                    np.maximum(cx0 - hw, cx1 - hw), np.float32(0))
    ih = boxes[0::2, 3]
    inter = iw * ih
    s = (a[:, 2] * a[:, 3] + (b[:, 2] * b[:, 3]).astype(np.float32)
         ).astype(np.float32)
    union = (s.astype(np.float64) - iw.astype(np.float64) * ih).astype(
        np.float32)
    fused = inter / union
    assert ((fused > thresh) != (pair > thresh)).sum() >= 5


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
    cboxes, the first pass's table, out, B, K, C, the walk's classes per
    block and the threshold (the stream is added by _build.launch), fewer
    classes per block where C is smaller; and it refuses K over MAX_K, a
    block's shared memory overrun, cboxes that are not (B, K, 4),
    non-float32 operands and operands on two devices."""
    calls = []
    check = nms._check
    monkeypatch.setattr(nms, "_check", lambda *a: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, out, *args, counts: calls.append(
                            (name, fn, out, args)) or out)
    cprob = torch.empty((2, 256, 80), device="meta")
    cboxes = torch.empty((2, 256, 4), device="meta")
    out = nms.nms_greedy(cprob, cboxes, 0.45)
    assert out.shape == cprob.shape and out.dtype == torch.float32
    (name, fn, _, args), = calls
    assert (name, fn) == ("nms_greedy", "yq_nms_greedy")
    assert len(args) == len(_build.SIGNATURES[fn]) - 1
    assert args[4:] == (2, 256, 80, nms.WARPS, 0.45)
    # fewer classes a block where C is smaller; shared memory for WARPS
    # classes at every K up to MAX_K (at K=1024, 128 KB of table and 12 KB
    # a class), more refused
    for k, c, want in ((845, 80, nms.WARPS), (1024, 80, nms.WARPS),
                       (1024, 3, min(3, nms.WARPS))):
        nms.nms_greedy(torch.empty((1, k, c), device="meta"),
                       torch.empty((1, k, 4), device="meta"), 0.5)
        assert calls[-1][3][4:8] == (1, k, c, want)
    assert nms.walk_smem(nms.MAX_K, nms.WARPS) <= nms.SMEM_MAX
    assert nms.walk_smem(1024, 8) <= nms.SMEM_MAX < nms.walk_smem(1024, 9)
    assert [nms.row_stride(k) for k in (1, 32, 33, 256, 845, 1024)] == [
        4, 4, 4, 8, 28, 32]
    monkeypatch.setattr(nms, "WARPS", 9)
    with pytest.raises(ValueError, match="shared memory"):
        nms.nms_greedy(torch.empty((1, 1024, 80), device="meta"),
                       torch.empty((1, 1024, 4), device="meta"), 0.5)
    with pytest.raises(ValueError, match="K=1025"):
        nms.nms_greedy(torch.empty((1, 1025, 3), device="meta"),
                       torch.empty((1, 1025, 4), device="meta"), 0.5)
    monkeypatch.setattr(nms, "_check", check)
    with pytest.raises(ValueError, match="want"):
        nms.nms_greedy(cprob, torch.empty((2, 256, 256), device="meta"), 0.5)
    with pytest.raises(ValueError, match="want"):
        nms.nms_greedy(cprob, torch.empty((2, 255, 4), device="meta"), 0.5)
    with pytest.raises(ValueError, match="operands on"):
        nms.nms_greedy(cprob, torch.empty((2, 256, 4)), 0.5)
    monkeypatch.undo()
    with pytest.raises(TypeError, match="float32"):
        nms.nms_greedy(torch.zeros((1, 4, 2), dtype=torch.float64),
                       torch.zeros((1, 4, 4), dtype=torch.float64), 0.5)
    with pytest.raises(TypeError, match="float32"):
        nms.nms_greedy(torch.zeros((1, 4, 2)),
                       torch.zeros((1, 4, 4), dtype=torch.float16), 0.5)
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
