"""The port's streaming runtime (yolotpu_torch.runtime.stream) against
yolotpu's, frame for frame: the port's StreamRunner over the port's int16
Engine (device backend, the kernels' plain versions on the CPU) and
yolotpu's over its golden backend (int32 mode) write the same JSONL records,
byte for byte, from in-memory sources of raw frames (so no video writer is
needed): the single-frame loop with --infer-every and --max-frames, the
batched feed with a padded tail batch (the port letterboxes on the device,
yolotpu on the host), the device-NMS feed against the host records, a flaky
and a dead camera, and the annotated PNGs."""

import functools
import json

import numpy as np

from yolotpu.models import zoo as jzoo
from yolotpu.runtime import engine as jengine
from yolotpu.runtime import stream as jstream
from yolotpu_torch.models import zoo
from yolotpu_torch.runtime import engine, stream

SIZE = 64
# the synthetic weights spread the class scores over 80 classes: at 64x64 the
# best of a frame's 20 boxes reach about 0.015
THRESH = 0.013
LABELS = [str(i) for i in range(80)]


@functools.cache
def _stores():
    spec = zoo.build("yolov2", width=SIZE, height=SIZE)
    jspec = jzoo.build("yolov2", width=SIZE, height=SIZE)
    return (spec, engine.load_or_synthesize(spec, None, "int16", synthetic=True),
            jspec, jengine.load_or_synthesize(jspec, None, "int16",
                                              synthetic=True))


@functools.cache
def _engines():
    spec, store, jspec, jstore = _stores()
    return (engine.Engine(spec, store, "int16", device="cpu"),
            jengine.Engine(jspec, jstore, "int16", backend="golden",
                           compute="int32"))


class Frames:
    """An in-memory frame source: seeded raw RGB frames, then EOF."""

    def __init__(self, n, shape=(48, 80), seed=0):
        rng = np.random.default_rng(seed)
        self.frames = [rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
                       for _ in range(n)]

    def read(self):
        return self.frames.pop(0) if self.frames else None

    def close(self):
        pass


def _run(mod, eng, src, path, **kw):
    cfg = mod.StreamConfig(thresh=THRESH, nms=0.45, output_json=str(path),
                           mode="video", source="mem", labels=LABELS, **kw)
    return mod.StreamRunner(eng, cfg).run(src)


def _both(tmp_path, src, **kw):
    """Each side's summary and JSONL bytes for the same source."""
    eng, jeng = _engines()
    out = {}
    for who, mod, e in (("port", stream, eng), ("jax", jstream, jeng)):
        path = tmp_path / f"{who}.jsonl"
        out[who] = (_run(mod, e, src(), path, **kw), path.read_bytes())
    return out


def _records(data: bytes) -> list[dict]:
    return [json.loads(line) for line in data.decode().splitlines()]


def test_single_frame_loop_equals_yolotpu(tmp_path):
    got = _both(tmp_path, lambda: Frames(9), infer_every=2, max_frames=4)
    assert got["port"][1] == got["jax"][1]
    recs = _records(got["port"][1])
    assert [r["frame_index"] for r in recs] == [0, 2, 4, 6]
    assert [r["inference_index"] for r in recs] == [0, 1, 2, 3]
    assert sum(len(r["detections"]) for r in recs) > 0
    assert got["port"][0]["count"] == got["jax"][0]["count"] == 4


def test_batched_feed_pads_the_tail_and_equals_yolotpu(tmp_path):
    """6 frames at b=4: one full batch and a tail of 2 padded to 4; the
    port uploads raw uint8 frames and letterboxes them on the device."""
    got = _both(tmp_path, lambda: Frames(6, seed=1), batch_size=4)
    assert got["port"][1] == got["jax"][1]
    recs = _records(got["port"][1])
    assert [r["frame_index"] for r in recs] == list(range(6))
    assert sum(len(r["detections"]) for r in recs) > 0
    assert got["port"][0]["count"] == 2

    # device decode + NMS with K = N (never saturated): the same best-class
    # (class, prob) list per frame as the host path's records (as
    # tests/test_runtime.py's device-NMS stream test holds them)
    spec, store, _, _ = _stores()
    n_boxes = spec.region.num * spec.layers[-1].out_h * spec.layers[-1].out_w
    dev = engine.Engine(spec, store, "int16", device="cpu", device_nms=True,
                        thresh=THRESH, nms=0.45, topk=n_boxes)
    path = tmp_path / "dev.jsonl"
    _run(stream, dev, Frames(6, seed=1), path, batch_size=4)
    # classes equal, probs within one unit of the 6th decimal: the host
    # decodes in numpy, the device path in PyTorch, a float32 ulp apart
    for g, w in zip(_records(path.read_bytes()), recs, strict=True):
        assert g["frame_index"] == w["frame_index"]
        got = sorted((d["class_id"], d["prob"]) for d in g["detections"])
        want = sorted((d["class_id"], d["prob"]) for d in w["detections"])
        assert [c for c, _ in got] == [c for c, _ in want]
        np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                                   rtol=0, atol=1.01e-6)


class FlakySource:
    """6 frames, with a None (decode failure) before every real one, then
    None for ever (a dead camera)."""

    def __init__(self):
        self.n = 0

    def read(self):
        self.n += 1
        if self.n > 12 or self.n % 2 == 1:
            return None
        return np.full((SIZE, SIZE, 3), self.n * 9, np.uint8)

    def close(self):
        pass


class DeadSource:
    def read(self):
        return None

    def close(self):
        pass


def test_flaky_and_dead_camera_as_yolotpu(tmp_path, monkeypatch):
    monkeypatch.setenv("YOLO2_READ_RETRIES", "3")
    monkeypatch.setenv("YOLO2_READ_RETRY_MS", "1")
    eng, jeng = _engines()
    out = {}
    for who, mod, e in (("port", stream, eng), ("jax", jstream, jeng)):
        cfg = mod.StreamConfig(thresh=THRESH, mode="camera",
                               source="/dev/video0",
                               output_json=str(tmp_path / f"{who}.jsonl"),
                               labels=LABELS)
        summary = mod.StreamRunner(e, cfg).run(FlakySource())
        dead = mod.StreamRunner(e, cfg).run(DeadSource())
        out[who] = (summary["count"], dead.get("count", 0),
                    (tmp_path / f"{who}.jsonl").read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (6, 0)
    assert len(_records(out["port"][2])) == 6


def test_annotated_pngs_as_yolotpu(tmp_path):
    eng, jeng = _engines()
    for who, mod, e in (("port", stream, eng), ("jax", jstream, jeng)):
        cfg = mod.StreamConfig(thresh=THRESH, mode="video", source="mem",
                               save_annotated_dir=str(tmp_path / who),
                               labels=LABELS)
        mod.StreamRunner(e, cfg).run(Frames(3, seed=3))
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"frame_{i:06d}.png" for i in range(3)]
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
