"""The port's evaluation (``yolotpu_torch.eval``) against the JAX
package's, on the CPU. The metrics and the label IO are a numpy copy, so
they are held exactly equal on seeded predictions; ``evaluate_engine`` and
``evaluate_engine_batched`` drive the port's int16 engine (the kernels'
plain versions on the CPU) and the JAX package's on the same protocol
scenes, with their own synthetic stores (held bit-equal by
test_torch_host), and must give the same predictions, box for box, and
the same mAP at every IoU: the int16 heads are bit-equal, and the
postprocess is the same numpy code. Trained weights and their mAP are the
business of test_torch_accuracy."""

import numpy as np
import pytest

from yolotpu import accuracy as jacc
from yolotpu import eval as jeval
from yolotpu.models import zoo as jzoo
from yolotpu.postprocess import Detection as JDetection
from yolotpu.runtime.engine import Engine as JEngine
from yolotpu.runtime.engine import load_or_synthesize as jload
from yolotpu_torch import eval as teval
from yolotpu_torch.models import zoo
from yolotpu_torch.postprocess import Detection
from yolotpu_torch.runtime.engine import Engine, load_or_synthesize


def _seeded(rng, n_img: int, classes: int, noise: float):
    gts, jgts, preds, jpreds = [], [], [], []
    for _ in range(n_img):
        k = int(rng.integers(0, 7))
        boxes = np.stack([rng.uniform(0.2, 0.8, k), rng.uniform(0.2, 0.8, k),
                          rng.uniform(0.05, 0.3, k), rng.uniform(0.05, 0.3, k)],
                         1).astype(np.float32).reshape(-1, 4)
        cls = rng.integers(0, classes, k).astype(np.int32)
        m = int(rng.integers(0, 9))
        pb = np.concatenate([boxes + rng.normal(0, noise, boxes.shape)
                             .astype(np.float32),
                             rng.uniform(0.1, 0.9, (m, 4)).astype(np.float32)])
        pc = np.concatenate([cls, rng.integers(0, classes, m)]).astype(np.int32)
        ps = rng.uniform(0, 1, pb.shape[0]).astype(np.float32)
        ps[:2] = 0.5                                    # tied scores
        gts.append(teval.GroundTruth(boxes=boxes, classes=cls))
        jgts.append(jeval.GroundTruth(boxes=boxes, classes=cls))
        preds.append(teval.Prediction(boxes=pb, classes=pc, scores=ps))
        jpreds.append(jeval.Prediction(boxes=pb, classes=pc, scores=ps))
    return gts, jgts, preds, jpreds


@pytest.mark.parametrize("seed,noise", [(0, 0.01), (1, 0.04), (2, 0.0),
                                        (3, 0.1)])
def test_metrics_equal_jax_exactly(seed, noise):
    rng = np.random.default_rng(seed)
    gts, jgts, preds, jpreds = _seeded(rng, 12, 4, noise)
    assert teval.map_coco(preds, gts, 4) == jeval.map_coco(jpreds, jgts, 4)
    for t in (0.3, 0.5, 0.75):
        assert teval.ap_voc(preds, gts, 4, t) == jeval.ap_voc(jpreds, jgts,
                                                              4, t)
    a, b = preds[0].boxes, gts[1].boxes
    np.testing.assert_array_equal(teval.iou_matrix(a, b),
                                  jeval.iou_matrix(a, b))
    assert teval.iou_matrix(a[:0], b).shape == (0, b.shape[0])


def test_labels_and_predictions_equal_jax(tmp_path):
    p = tmp_path / "img.txt"
    p.write_text("2 0.5 0.5 0.25 0.3\n7 0.1 0.2 0.05 0.05\nbad line\n")
    got, want = (m.load_darknet_labels(str(p)) for m in (teval, jeval))
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.classes, want.classes)
    assert teval.load_darknet_labels(str(tmp_path / "no.txt")).boxes.shape \
        == (0, 4)
    rng = np.random.default_rng(5)
    dets, jdets = [], []
    for _ in range(6):
        prob = rng.uniform(0, 1, 5).astype(np.float32) * (rng.random(5) > 0.5)
        box = tuple(float(v) for v in rng.uniform(0, 1, 4))
        dets.append(Detection(bbox=box, objectness=0.5, prob=prob, classes=5))
        jdets.append(JDetection(bbox=box, objectness=0.5, prob=prob,
                                classes=5))
    for thresh in (0.0, 0.4):
        got = teval.detections_to_prediction(dets, thresh)
        want = jeval.detections_to_prediction(jdets, thresh)
        for f in ("boxes", "classes", "scores"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    size = 64
    pairs = jacc.write_eval_set(str(tmp_path_factory.mktemp("ev")), size)[:8]
    calib = [np.full((3, size, size), 0.5, np.float32)]
    spec = zoo.build("yolov2-tiny", width=size, height=size)
    jspec = jzoo.build("yolov2-tiny", width=size, height=size)
    eng = Engine(spec, load_or_synthesize(spec, None, "int16", synthetic=True,
                                          calib_images=calib),
                 "int16", device="cpu")
    jeng = JEngine(jspec, jload(jspec, None, "int16", synthetic=True,
                                calib_images=calib), "int16", backend="xla")
    return eng, jeng, pairs


def _capture(monkeypatch, module) -> list:
    """Record the predictions and truths each evaluation scores."""
    seen = []
    real = module.map_coco

    def spy(preds, gts, num_classes):
        seen.append((preds, gts))
        return real(preds, gts, num_classes)
    monkeypatch.setattr(module, "map_coco", spy)
    return seen


def _same_predictions(got: list, want: list) -> None:
    """The predictions equal, box for box, and there are some: the
    synthetic weights' mAP is 0 at every IoU in both packages, so the boxes,
    classes and scores are what the test holds."""
    (preds, _), = got
    (jpreds, _), = want
    assert len(preds) == len(jpreds) == 8
    for p, q in zip(preds, jpreds):
        for f in ("boxes", "classes", "scores"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
    assert sum(p.boxes.shape[0] for p in preds) > 8


def test_evaluate_engine_equals_jax(engines, monkeypatch):
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    eng, jeng, pairs = engines
    seen, jseen = _capture(monkeypatch, teval), _capture(monkeypatch, jeval)
    got = teval.evaluate_engine(eng, pairs, num_classes=80, thresh=0.005)
    want = jeval.evaluate_engine(jeng, pairs, num_classes=80, thresh=0.005)
    assert got == want and got["images"] == 8
    _same_predictions(seen, jseen)


def test_evaluate_engine_batched_equals_jax_and_unbatched(engines,
                                                          monkeypatch):
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    eng, jeng, pairs = engines
    seen, jseen = _capture(monkeypatch, teval), _capture(monkeypatch, jeval)
    got = teval.evaluate_engine_batched(eng, pairs, num_classes=80,
                                        thresh=0.005, batch=3)
    want = jeval.evaluate_engine_batched(jeng, pairs, num_classes=80,
                                         thresh=0.005, batch=3)
    assert got == want
    _same_predictions(seen, jseen)
    assert got == teval.evaluate_engine(eng, pairs, num_classes=80,
                                        thresh=0.005)


def test_evaluate_engine_batched_rejects_non_net_sized(engines, tmp_path):
    from PIL import Image
    eng, _, _ = engines
    ip = str(tmp_path / "odd.png")
    Image.fromarray(np.zeros((48, 80, 3), np.uint8)).save(ip)
    with pytest.raises(ValueError, match="net-sized"):
        teval.evaluate_engine_batched(eng, [(ip, ip + ".txt")],
                                      num_classes=80)


def test_int8_accuracy_sweep_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """``python -m yolotpu_torch.tools.int8_accuracy_sweep --device cpu``,
    cut to 2 training steps and 2 eval scenes: one JSON line per
    configuration (fp32, int16, w8a16 and int8 at three margins, per layer
    and per channel), the trained weights cached where INT8_SWEEP_STORE
    says; with no card it raises by default."""
    import json

    import torch

    from yolotpu_torch.tools import int8_accuracy_sweep as sweep

    monkeypatch.setattr(sweep, "TRAIN_STEPS", 2)
    monkeypatch.setenv("INT8_SWEEP_STORE", str(tmp_path / "store.npz"))
    monkeypatch.setenv("INT8_SWEEP_EVAL_N", "2")
    assert sweep.main(["--device", "cpu"]) == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    assert [r["cfg"] for r in rows] == ["fp32", "int16", "w8a16"] + [
        f"int8 margin={m} pc={pc}" for m in (2.0, 1.4, 1.0)
        for pc in (False, True)]
    assert all(0.0 <= r["mAP_50"] <= 1.0 for r in rows)
    assert (tmp_path / "store.npz").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep.main([])
