"""The port's training (``yolotpu_torch.train``: ``region_loss`` and
``make_train_step``; ``models.yolov2.head_fp32``; ``ops.pool.maxpool``'s
gradient) against the JAX package's, on the CPU, on the same seeded numpy
inputs.

Tolerances, and why they are not zero:
- the loss and d loss/d head: XLA and PyTorch sum in other orders and use
  their own exp/log1p; rtol 1e-5 on the loss, and the gradient within 1e-5
  of its largest magnitude;
- maxpool's gradient: a max is exact and a tie's split is a power of two,
  so equal;
- two train steps on a small graph with every layer kind (3x3 and 1x1
  convs, pools, a reorg and a route concat): the convs' sums differ in
  order between XLA and oneDNN, and the differences compound through the
  backward; the loss within rtol 1e-5, and each velocity leaf and each
  step's change of the params within 1e-4 of the leaf's largest magnitude
  (the change also within 2 ulp of the leaf's largest parameter, to which
  p + v rounds).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolotpu import train as jtrain
from yolotpu.accuracy import render_scene, sample_scene_geometry
from yolotpu.graph import NetworkSpec as JSpec
from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu.ops import pool as jpool
from yolotpu.weights import WeightStore as JStore
from yolotpu_torch import train
from yolotpu_torch.graph import NetworkSpec
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.models import zoo
from yolotpu_torch.ops import pool
from yolotpu_torch.weights import WeightStore

# a 64x64 graph with every layer kind the flagship has: 3x3 and 1x1 convs,
# 2x2/s2 pools, a reorg and the route concat of two branches; region 8x8,
# 2 anchors, 3 classes
SMALL_CFG = """[net]
batch=1
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=8
size=1
stride=1
pad=1
activation=leaky

[convolutional]
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
filters=32
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-3

[convolutional]
filters=4
size=1
stride=1
pad=1
activation=leaky

[reorg]
stride=2

[route]
layers=-1,-4

[convolutional]
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=16
activation=linear

[region]
anchors=1.0,1.5,3.0,2.5
classes=3
coords=4
num=2
softmax=1
"""


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "small.cfg"
    path.write_text(SMALL_CFG)
    return JSpec.from_cfg(str(path)), NetworkSpec.from_cfg(str(path))


def _truths(rng, b: int, m: int, n: int, classes: int):
    boxes = np.zeros((b, m, 4), np.float32)
    boxes[:, :, :2] = rng.uniform(0.05, 0.95, (b, m, 2))
    boxes[:, :, 2:] = rng.uniform(0.05, 0.6, (b, m, 2))
    cls = rng.integers(0, classes, (b, m)).astype(np.int32)
    mask = np.zeros((b, m), np.float32)
    mask[:, :n] = 1.0
    return boxes, cls, mask


def _loss_both(head, boxes, cls, mask, rescore=True):
    """(JAX loss, JAX d loss/d head, port loss, port d loss/d head) on
    yolov2's region (5 anchors, 80 classes)."""
    jr = jzoo.build("yolov2").region
    tr = zoo.build("yolov2").region
    cfg_j = jtrain.LossConfig(rescore=rescore)
    cfg_t = train.LossConfig(rescore=rescore)
    jl, jg = jax.jit(jax.value_and_grad(lambda h, b, c, m: jtrain.region_loss(
        h, b, c, m, jr, cfg_j)))(jnp.asarray(head), jnp.asarray(boxes),
                                 jnp.asarray(cls), jnp.asarray(mask))
    h = torch.from_numpy(head).requires_grad_(True)
    tl = train.region_loss(h, torch.from_numpy(boxes), torch.from_numpy(cls),
                           torch.from_numpy(mask), tr, cfg_t)
    (tg,) = torch.autograd.grad(tl, h)
    return float(jl), np.asarray(jg), float(tl.detach()), tg.numpy()


def _close_grad(got, want, rel=1e-5, floor=0.0):
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale + floor, (err, scale)


@pytest.mark.parametrize("rescore", [True, False])
def test_region_loss_and_grad_random_heads(rescore):
    rng = np.random.default_rng(0)
    head = rng.standard_normal((2, 13, 13, 425)).astype(np.float32)
    boxes, cls, mask = _truths(rng, 2, 8, 5, 80)
    jl, jg, tl, tg = _loss_both(head, boxes, cls, mask, rescore)
    assert tl == pytest.approx(jl, rel=1e-5)
    _close_grad(tg, jg)


def test_region_loss_perfect_prediction():
    """A head that predicts its one truth exactly at the assigned slot and
    no object elsewhere: the loss is near 0 in both (objectness toward 1,
    the protocol's ``rescore=False``: toward the IoU, a rounding of 1 in
    either package, the BCE of a logit of 20 cancels to +-1e-5)."""
    spec = zoo.build("yolov2").region
    n, c = spec.num, spec.classes
    head = np.zeros((1, 13, 13, n, 5 + c), np.float32)
    head[..., 4] = -20.0                       # no object anywhere
    anchors = np.asarray(spec.biases, np.float32).reshape(n, 2)
    box = np.array([[[6.5 / 13, 4.25 / 13, anchors[2, 0] / 13,
                      anchors[2, 1] / 13]]], np.float32)
    x = head[0, 4, 6, 2]                       # cell (6, 4), anchor 2
    x[1] = np.log(0.25 / 0.75)                 # sigmoid: tx 0.5, ty 0.25
    x[4] = 20.0                                # tw = th = 0: the anchor
    x[5 + 7] = 20.0
    cls = np.array([[7]], np.int32)
    mask = np.ones((1, 1), np.float32)
    jl, jg, tl, tg = _loss_both(head.reshape(1, 13, 13, -1), box, cls, mask,
                                rescore=False)
    assert tl == pytest.approx(jl, abs=1e-6)
    assert 0 <= tl < 1e-5
    # every gradient is a rounding here (log(w / a_w) of a w that is the
    # anchor's own, 1.2e-7 off 0): held absolutely
    assert np.abs(tg - jg).max() <= 1e-6


def test_region_loss_grad_at_zero_logits():
    """Every objectness logit exactly 0: JAX's |x| takes +1 there and its
    maximum splits a tie, so a noobj slot's BCE gradient is 0 (PyTorch's
    own abs would give 1/2). The loss sums about 1,700 equal terms of
    log 2, where a float32 sum's rounding adds up rather than cancels (n
    eps = 1e-4): rtol 1e-4."""
    rng = np.random.default_rng(4)
    head = np.zeros((2, 13, 13, 425), np.float32)
    boxes, cls, mask = _truths(rng, 2, 6, 4, 80)
    jl, jg, tl, tg = _loss_both(head, boxes, cls, mask)
    assert tl == pytest.approx(jl, rel=1e-4)
    _close_grad(tg, jg)
    obj = tg.reshape(2, 13, 13, 5, 85)[..., 4]
    assert (obj == 0).mean() > 0.9


def test_region_loss_two_truths_on_one_slot():
    """Two truths in one cell with the same best anchor: both gather the
    same slot, and their gradients add."""
    rng = np.random.default_rng(3)
    head = rng.standard_normal((1, 13, 13, 425)).astype(np.float32)
    boxes = np.array([[[0.51, 0.52, 0.2, 0.3], [0.52, 0.53, 0.21, 0.29],
                       [0.1, 0.1, 0.05, 0.05], [0, 0, 0, 0]]], np.float32)
    cls = np.array([[3, 5, 1, 0]], np.int32)
    mask = np.array([[1, 1, 1, 0]], np.float32)
    jl, jg, tl, tg = _loss_both(head, boxes, cls, mask)
    assert tl == pytest.approx(jl, rel=1e-5)
    _close_grad(tg, jg)
    slot = np.abs(tg.reshape(13, 13, 5, 85)).sum(-1)
    assert (slot > 0.1).sum() >= 2            # the shared slot and another


@pytest.mark.parametrize("ties", [2, 3, 4])
def test_maxpool_grad_on_ties_equals_jax(ties):
    """Windows with 2-, 3- and 4-way exact ties: the gradient splits at
    each of the two maxes, in JAX's order (a 3-way tie gives 1/4, 1/4,
    1/2), where one max over the window would give 1/3 each."""
    rng = np.random.default_rng(ties)
    x = rng.integers(0, 3, (2, 8, 8, 4)).astype(np.float32)
    win = x.reshape(2, 4, 2, 4, 2, 4)
    win[..., :] = 0.0
    flat = win.transpose(0, 1, 3, 5, 2, 4).reshape(-1, 4)
    for row in flat:
        row[rng.permutation(4)[:ties]] = 5.0
    x = flat.reshape(2, 4, 4, 4, 2, 2).transpose(0, 1, 4, 2, 5, 3).reshape(
        2, 8, 8, 4)
    cot = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jpool.maxpool(v, 2, 2, 0) * cot))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((pool.maxpool(xt, 2, 2, 0)
                                  * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if ties == 3:
        shares = sorted(set(np.round(np.abs(got.numpy()[x == 5.0]
                                            / np.repeat(np.repeat(
                                                np.abs(cot), 2, 1), 2, 2)
                                            [x == 5.0]), 4)))
        assert shares == [0.25, 0.5]


def test_maxpool_grad_strided_and_padded_equals_jax():
    """The strided-slice branch (the 2x2/s1 pool with padding of
    yolov2-tiny's last pool), ties included."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 3, (1, 7, 7, 3)).astype(np.float32)
    cot = rng.standard_normal((1, 7, 7, 3)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jpool.maxpool(v, 2, 1, 1) * cot))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((pool.maxpool(xt, 2, 1, 1)
                                  * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_head_fp32_equals_the_serving_walk(small):
    """The differentiable head is the fp32 tier's head (YoloV2Q), on uint8
    and float frames."""
    _, tspec = small
    store = WeightStore.synthetic(tspec, seed=0)
    params = ty.params_fp32(tspec, store)
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    model = ty.YoloV2Q(tspec, None, params, "cpu", "fp32", outputs=("head",))
    want = model(torch.from_numpy(frames))["head"]
    for x in (torch.from_numpy(frames),
              torch.from_numpy(frames.astype(np.float32) / 255)):
        assert torch.equal(ty.head_fp32(tspec, params, x), want)


def _scene_batch(b: int, size: int, seed: int):
    """Protocol-style frames (flat rectangles, so the first pool ties) and
    their truths."""
    rng = np.random.default_rng(seed)
    imgs, bx = np.zeros((b, size, size, 3), np.float32), []
    cl = np.zeros((b, 8), np.int32)
    mk = np.zeros((b, 8), np.float32)
    boxes = np.zeros((b, 8, 4), np.float32)
    for i in range(b):
        img, bb, cc = render_scene(sample_scene_geometry(rng), size, rng)
        imgs[i] = img / np.float32(255)
        k = len(cc)
        boxes[i, :k], cl[i, :k], mk[i, :k] = bb, cc % 3, 1.0
    return {"images": imgs, "boxes": boxes, "classes": cl, "mask": mk}


@pytest.mark.parametrize("clip_norm", [0.0, 1.0])
def test_two_train_steps_equal_jax(small, clip_norm):
    jspec, tspec = small
    jstore, tstore = JStore.synthetic(jspec, seed=1), WeightStore.synthetic(
        tspec, seed=1)
    cfg_j = jtrain.LossConfig(rescore=False)
    cfg_t = train.LossConfig(rescore=False)
    jstep = jax.jit(jtrain.make_train_step(jspec, lr=1e-3, momentum=0.9,
                                           cfg=cfg_j, clip_norm=clip_norm))
    tstep = train.make_train_step(tspec, lr=1e-3, momentum=0.9, cfg=cfg_t,
                                  clip_norm=clip_norm)
    jp = jy.params_fp32(jspec, jstore)
    jv = jtrain.zeros_like_velocity(jp)
    tp = ty.params_fp32(tspec, tstore)
    tv = train.zeros_like_velocity(tp)
    for it, scale in enumerate((1.0, np.float32(0.5))):
        batch = _scene_batch(2, 64, seed=10 + it)
        jp_next, jv, jl = jstep(jp, jv, {k: jnp.asarray(v)
                                         for k, v in batch.items()}, scale)
        tp_next, tv, tl = tstep(tp, tv, {k: torch.from_numpy(v)
                                         for k, v in batch.items()}, scale)
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        for name in jp:
            for leaf in ("w", "b"):
                want_v = np.asarray(jv[name][leaf])
                _close_grad(tv[name][leaf].numpy(), want_v, 1e-4)
                want_d = np.asarray(jp_next[name][leaf]) - np.asarray(
                    jp[name][leaf])
                got_d = (tp_next[name][leaf] - tp[name][leaf]).numpy()
                # p + v rounds to p's own ulp: 2 ulp of the largest |p|
                ulp2 = 2 * np.finfo(np.float32).eps * np.abs(
                    np.asarray(jp[name][leaf])).max()
                _close_grad(got_d, want_d, 1e-4, ulp2)
        jp, tp = jp_next, tp_next
    assert float(tl) > 0


def test_train_step_leaves_its_arguments_alone(small):
    _, tspec = small
    params = ty.params_fp32(tspec, WeightStore.synthetic(tspec, seed=2))
    before = {k: {l: v.clone() for l, v in p.items()} for k, p in params.items()}
    vel = train.zeros_like_velocity(params)
    batch = {k: torch.from_numpy(v) for k, v in _scene_batch(1, 64, 5).items()}
    new_p, new_v, loss = train.make_train_step(tspec, clip_norm=1.0)(
        params, vel, batch)
    assert all(torch.equal(params[k][l], before[k][l]) for k in params
               for l in ("w", "b"))
    assert all(not v.requires_grad for p in new_p.values() for v in p.values())
    assert any(not torch.equal(new_p[k]["w"], params[k]["w"]) for k in params)
    assert not loss.requires_grad and loss.ndim == 0


def test_train_cli_equals_jax_with_resume_and_export(small, tmp_path,
                                                    monkeypatch, capsys):
    """cli.train on the CPU and the JAX package's, the same argv: 4 steps
    with a checkpoint every 2, then --resume to 6; the checkpoints' params
    and velocities agree as the train steps do (within 1e-4 of each leaf's
    change or velocity), the exports load into the port's fp32 Engine, and
    the port's exported files are the port's own checkpoint, written as
    the JAX exporter writes them."""
    from yolotpu import checkpoint as jckpt
    from yolotpu.cli import train as jcli
    from yolotpu_torch import checkpoint as ckpt
    from yolotpu_torch.cli import train as cli
    from yolotpu_torch.runtime.engine import Engine

    cfg = tmp_path / "small.cfg"
    cfg.write_text(SMALL_CFG)
    monkeypatch.chdir(tmp_path)

    def argv(who: str, steps: int, *more: str) -> list[str]:
        return ["--cfg", str(cfg), "--synthetic-data", "--batch", "2",
                "--steps", str(steps), "--ckpt-every", "2", "--seed", "1",
                "--ckpt-dir", f"ck_{who}", "--export-weights", f"w_{who}",
                *more]
    for steps, more in ((4, ()), (6, ("--resume",))):
        assert cli.main(argv("port", steps, "--device", "cpu", "--mesh",
                             *more)) == 0
        assert jcli.main(argv("jax", steps, *more)) == 0
    out = capsys.readouterr().out
    assert out.count("resumed from") == 2 and "ckpt_00000004.npz" in out
    assert sorted(os.listdir(tmp_path / "ck_port")) == [
        "ckpt_00000002.npz", "ckpt_00000004.npz", "ckpt_00000006.npz"]
    _, tspec = small
    init = ty.params_fp32(tspec, WeightStore.synthetic(tspec, seed=1))
    step, p, v = ckpt.load_checkpoint(ckpt.latest_checkpoint("ck_port"))
    jstep, jp, jv = jckpt.load_checkpoint(jckpt.latest_checkpoint("ck_jax"))
    assert step == jstep == 6
    for name in jp:
        for leaf in ("w", "b"):
            p0 = init[name][leaf].numpy()
            ulp2 = 2 * np.finfo(np.float32).eps * np.abs(p0).max()
            _close_grad(p[name][leaf] - p0, jp[name][leaf] - p0, 1e-4, ulp2)
            _close_grad(v[name][leaf], jv[name][leaf], 1e-4)
    ckpt.export_weight_artifacts(p, tspec, "again")
    for f in ("weights.bin", "bias.bin"):
        assert (tmp_path / "w_port" / f).read_bytes() == \
            (tmp_path / "again" / f).read_bytes()
    store = WeightStore.load_fp32(tspec, "w_port/weights.bin",
                                  "w_port/bias.bin")
    heads = Engine(tspec, store, "fp32", device="cpu").predict_batch_rgb(
        np.zeros((1, 64, 64, 3), np.uint8))
    assert heads.shape == (1, 16, 8, 8) and np.isfinite(heads).all()


def test_train_cli_needs_a_card_by_default(small, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    cfg = tmp_path / "small.cfg"
    cfg.write_text(SMALL_CFG)
    from yolotpu_torch.cli import train as cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--cfg", str(cfg), "--synthetic-data", "--steps", "1",
                  "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_train_cli_mesh_over_cards_is_m13(monkeypatch, tmp_path):
    """--mesh (M13) runs one process per card under torchrun: with more
    than one visible card and no torchrun world it raises, naming the
    launch, before it builds anything; with one process it shards nothing
    (the CPU run above passes --mesh, and its checkpoints equal JAX's).
    tests/test_torch_parallel.py runs it over two ranks."""
    from yolotpu_torch.cli import train as cli
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError,
                       match="torchrun --nproc-per-node 2 -m "
                             "yolotpu_torch.cli.train --mesh"):
        cli.main(["--synthetic-data", "--mesh", "--steps", "1",
                  "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
