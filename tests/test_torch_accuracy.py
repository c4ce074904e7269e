"""The port's accuracy protocol (``yolotpu_torch.accuracy``), its evidence
tool and the report bundle's accuracy block, against the JAX package, on
the CPU.

- The protocol is a numpy copy: its hash, scenes, eval set, batches and
  calibration images are held exactly equal to the JAX package's.
- ``train_flagship_store`` (3 steps on a small graph with every layer
  kind) against the JAX package's own: with the flips of both held to
  all-or-none (JAX draws them from ``jax.random``, the port from numpy), the
  shuffle, the schedule, the staging and the mirroring of the image and of
  cx are JAX's. The losses within rtol 1e-5 and each trained weight's
  change within 1e-4 of the leaf's largest change (plus 2 ulp of the leaf's
  largest weight), as in test_torch_train; the port's own mixed flips
  against JAX's step on batches flipped by hand, the same way.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yolotpu import accuracy as jacc
from yolotpu import train as jtrain
from yolotpu.graph import NetworkSpec as JSpec
from yolotpu.models import yolov2 as jy
from yolotpu.weights import WeightStore as JStore
from yolotpu_torch import accuracy as acc
from yolotpu_torch.cli import report
from yolotpu_torch.graph import NetworkSpec
from yolotpu_torch.tools import accuracy_protocol

from test_torch_train import SMALL_CFG

SIZE = 64


def test_protocol_hash_is_jax_s():
    assert acc.protocol_hash() == jacc.protocol_hash() == "b50b290992cfde91"
    assert acc.PROTOCOL == jacc.PROTOCOL
    assert acc.CLASS_COLORS == jacc.CLASS_COLORS
    assert acc.TRAIN_RECIPE == jacc.TRAIN_RECIPE
    assert acc.MAX_BOXES == jacc.MAX_BOXES


def test_protocol_hash_is_param_sensitive(monkeypatch):
    monkeypatch.setitem(acc.PROTOCOL, "eval_scenes", 65)
    assert acc.protocol_hash() != jacc.protocol_hash()


@pytest.mark.parametrize("size,seed", [(64, 7), (128, 99), (416, 3)])
def test_scenes_equal_jax(size, seed):
    got = acc.make_scenes(5, size, seed)
    want = jacc.make_scenes(5, size, seed)
    for (img, boxes, cls), (jimg, jboxes, jcls) in zip(got, want):
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(boxes, jboxes)
        np.testing.assert_array_equal(cls, jcls)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(20):
        assert acc.sample_scene_geometry(rng) == \
            jacc.sample_scene_geometry(jrng)


def test_eval_set_equals_jax(tmp_path):
    pairs = acc.write_eval_set(str(tmp_path / "port"), SIZE)
    jpairs = jacc.write_eval_set(str(tmp_path / "jax"), SIZE)
    assert len(pairs) == len(jpairs) == 64
    for (ip, lp), (jip, jlp) in zip(pairs, jpairs):
        assert os.path.basename(ip) == os.path.basename(jip)
        np.testing.assert_array_equal(np.asarray(Image.open(ip)),
                                      np.asarray(Image.open(jip)))
        assert open(lp).read() == open(jlp).read()


def test_batch_builder_and_calib_images_equal_jax():
    scenes = acc.make_scenes(6, SIZE, 7)
    got = acc.batch_builder(scenes, SIZE)([4, 0, 4, 2])
    want = jacc.batch_builder(jacc.make_scenes(6, SIZE, 7), SIZE)([4, 0, 4, 2])
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(acc.calib_images(SIZE), jacc.calib_images(SIZE)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    """The small graph of test_torch_train, with the protocol's 8 classes."""
    path = tmp_path_factory.mktemp("cfg") / "small8.cfg"
    path.write_text(SMALL_CFG.replace("classes=3", "classes=8")
                    .replace("filters=16\nactivation=linear",
                             "filters=26\nactivation=linear"))
    return JSpec.from_cfg(str(path)), NetworkSpec.from_cfg(str(path))


def _close(got, want, init):
    scale = np.abs(want - init).max()
    floor = 2 * np.finfo(np.float32).eps * np.abs(init).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-4 * scale + floor


def _same_stores(store, jstore, init, spec) -> None:
    for l in spec.conv_layers():
        for k in (0, 1):
            _close(store.fp32[l.idx][k], jstore.fp32[l.idx][k],
                   init.fp32[l.idx][k])


@pytest.mark.parametrize("flip", [True, False])
def test_train_flagship_store_equals_jax(specs, monkeypatch, flip):
    jspec, tspec = specs
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.full(shape, flip))
    monkeypatch.setattr(acc, "flip_mask",
                        lambda rng, b: np.full(b, flip))
    jstore, jlosses = jacc.train_flagship_store(jspec, seed=2, size=SIZE,
                                                steps=3, batch=2)
    store, losses = acc.train_flagship_store(tspec, seed=2, size=SIZE,
                                             steps=3, batch=2, device="cpu")
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _same_stores(store, jstore, JStore.synthetic(jspec, seed=2), tspec)


def test_train_flagship_store_flips_image_and_cx(specs):
    """The port's own seeded flips (a mix over 3 steps of 4): each flipped
    sample's image is mirrored on W and its cx is 1 - cx, as JAX's step
    takes the batch built so by hand; the losses and weights agree."""
    jspec, tspec = specs
    seed, steps, batch = 5, 3, 4
    store, losses = acc.train_flagship_store(tspec, seed=seed, size=SIZE,
                                             steps=steps, batch=batch,
                                             device="cpu")
    # the same run by hand through JAX's step
    scenes = jacc.make_scenes(jacc.PROTOCOL["train_scenes"], SIZE,
                              jacc.PROTOCOL["train_scene_seed"])
    build = jacc.batch_builder(scenes, SIZE)
    rng = np.random.default_rng(seed)
    flips = np.random.default_rng(seed + 1000)
    step = jax.jit(jtrain.make_train_step(
        jspec, lr=1e-3, momentum=0.9, cfg=jtrain.LossConfig(rescore=False),
        clip_norm=1.0))
    init = JStore.synthetic(jspec, seed=seed)
    params = jy.params_fp32(jspec, init)
    vel = jtrain.zeros_like_velocity(params)
    order = np.arange(len(scenes))
    jlosses, mixed = [], set()
    for it in range(steps):
        rng.shuffle(order)
        b = build(order[:batch])
        f = acc.flip_mask(flips, batch)
        mixed.update(f.tolist())
        b["images"][f] = b["images"][f][:, :, ::-1]
        b["boxes"][f, :, 0] = 1.0 - b["boxes"][f, :, 0]
        params, vel, loss = step(params, vel, b, np.float32(
            acc.lr_scale_at(it, steps, 200)))
        jlosses.append(float(loss))
    assert mixed == {True, False}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    jstore = JStore(spec=jspec)
    for l in jspec.conv_layers():
        p = params[f"conv{l.idx}"]
        jstore.fp32[l.idx] = (np.asarray(p["w"]).transpose(3, 2, 0, 1),
                              np.asarray(p["b"]))
    _same_stores(store, jstore, init, tspec)


def test_train_flagship_store_needs_a_card_by_default(specs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acc.train_flagship_store(specs[1], seed=0, size=SIZE, steps=1)


def test_accuracy_protocol_tool_writes_the_port_s_evidence(tmp_path,
                                                           monkeypatch):
    """The tool at 64x64, 2 seeds of 2 steps, fp32 and int16 on the CPU:
    one file a tier under --out-dir with the JAX package's schema, the
    engine's fingerprint and the CI of 2 seeds; and with no card it
    raises by default."""
    monkeypatch.setattr(acc, "PROTOCOL", {**acc.PROTOCOL,
                                          "train_scenes": 16,
                                          "eval_scenes": 4})
    out = tmp_path / "plans"
    assert accuracy_protocol.main([
        "--device", "cpu", "--size", "64", "--seeds", "2", "--steps", "2",
        "--batch", "2", "--tiers", "fp32,int16", "--out-dir", str(out),
        "--scratch", str(tmp_path / "scratch")]) == 0
    assert sorted(os.listdir(out)) == ["accuracy_fp32.json",
                                       "accuracy_int16.json"]
    jax_keys = {"tier", "protocol", "protocol_hash", "resolution", "train",
                "eval_scenes", "classes", "engine", "backend_platform",
                "mAP_50_per_seed", "mAP_50_mean", "mAP_50_ci95",
                "fp32_mAP_50_per_seed", "delta_vs_fp32_mean",
                "delta_vs_fp32_ci95", "date"}
    doc = json.load(open(out / "accuracy_int16.json"))
    assert jax_keys <= set(doc)
    assert doc["protocol_hash"] == acc.protocol_hash()
    assert doc["resolution"] == 64 and doc["backend_platform"] == "cpu"
    assert len(doc["mAP_50_per_seed"]) == 2
    assert doc["engine"]["kernel_build"] and doc["engine"]["plan"] == ""
    assert doc["device"] == "cpu" and doc["power_limit_w"] is None
    assert doc["delta_vs_fp32_mean"] == pytest.approx(
        np.mean(doc["mAP_50_per_seed"]) - np.mean(
            doc["fp32_mAP_50_per_seed"]), abs=2e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            accuracy_protocol.main(["--size", "64", "--out-dir",
                                    str(tmp_path / "never")])
        assert not (tmp_path / "never").exists()


def _evidence(tmp_path, **over) -> str:
    doc = {"tier": "int16", "protocol": "scenes-v2",
           "protocol_hash": acc.protocol_hash(), "resolution": 64,
           "train": {"size": 64, "steps": 2, "batch": 2, "seeds": 3,
                     "recipe": "bce3"},
           "eval_scenes": 64, "classes": 8, "mAP_50_mean": 0.25,
           "mAP_50_ci95": 0.01, "delta_vs_fp32_mean": -0.002,
           "delta_vs_fp32_ci95": 0.003, **over}
    d = tmp_path / "plans"
    d.mkdir(exist_ok=True)
    (d / "accuracy_int16.json").write_text(json.dumps(doc))
    return str(d)


@pytest.mark.parametrize("over,found", [
    ({}, True),
    ({"protocol_hash": "0123456789abcdef"}, False),   # another protocol
    ({"resolution": 416}, False),                     # another resolution
])
def test_report_reads_only_matching_evidence(tmp_path, monkeypatch, over,
                                             found):
    monkeypatch.setenv("YOLO2_PLAN_DIR", _evidence(tmp_path, **over))
    doc = report.accuracy_evidence("int16", 64)
    assert (doc is not None) == found
    assert report.accuracy_evidence("int8", 64) is None


def test_report_run_bundles_the_accuracy_block(tmp_path, monkeypatch):
    """``report run`` at 64x64 on the CPU carries the matching evidence in
    metrics.json and its lines in summary.md; stale evidence is left
    out."""
    argv = ["--report-dir", str(tmp_path / "reports"), "run", "--width", "64",
            "--height", "64", "--batch", "1", "--steps", "1",
            "--synthetic-weights", "--device", "cpu", "--no-batch1-p50"]
    for over, found in (({}, True), ({"resolution": 128}, False)):
        monkeypatch.setenv("YOLO2_PLAN_DIR", _evidence(tmp_path, **over))
        for d in (tmp_path / "reports").glob("*") if (
                tmp_path / "reports").exists() else ():
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
        assert report.main(argv) == 0
        (bundle,) = (tmp_path / "reports").iterdir()
        metrics = json.load(open(bundle / "metrics.json"))
        summary = (bundle / "summary.md").read_text()
        assert ("accuracy" in metrics) == found
        assert ("## Accuracy" in summary) == found
        if found:
            assert metrics["accuracy"]["mAP_50_mean"] == 0.25
            assert "delta vs fp32: -0.002 ±0.003" in summary
