"""The port's multi-GPU path (``yolotpu_torch.parallel``) on the CPU: ranks
of a gloo world, each a process started by ``parallel.launch.spawn`` with a
file rendezvous, running the kernels' plain versions.

One world of 8 ranks (module-scoped; the cases are in
``torch_parallel_ranks.cases``) runs every multi-rank case at once, and
each test below reads its part of the result:

- yolov2 64x64, b=4: the int16 forward over (dp=2, tp=4) and (dp=2, sp=4),
  int8 and w8a16 under tp, and int8 under sp (its convs that fold their
  pool on one card run unfused on the slabs): head and detections
  ``torch.equal`` to the
  port's one-process forward of the tier, and the head ``np.array_equal``
  to the JAX package's unsharded ``build_forward(spec, tier,
  compute="int32")``; the bytes each collective moved, against the count
  from the shapes;
- the sharded train step, the clip off and on, against the port's one
  step on the whole batch and against the JAX package's step on its own
  (dp=2, tp=4) mesh of the 8 CPU devices, the same params and batch: the
  loss within rtol 1e-5 and every leaf of the new params within rtol
  1e-5, atol 1e-6 (the JAX package's ``test_train_parallel.py``
  tolerances for its sharded step), the velocities within rtol 1e-4: the
  tp all-reduce of each sharded conv's input gradient and the dp sum add
  in another order than one process does;
- the dryrun's five stages at 32x32 (``parallel.dryrun.run_stages``);
- the mixed cfg of ``test_torch_general_conv.py`` (a 7x7/s2 entry, a
  3x3/s2, a 5x5, a 2x2/s2, a VALID 3x3, a 1x1/s2 and a 3x3 head) at 96x96,
  b=4, over (dp=4, sp=2) in int16 and int8 (its head on ``conv_s8``'s
  int16 output): the heads ``torch.equal`` to the one-process forward and
  ``np.array_equal`` to the JAX package's unsharded head on the same
  frames, H gathered before the first layer, a strided conv;
- no rank imports JAX or the JAX package.

Two small worlds: one where a rank raises, which must fail within 60 s and
leave no process behind, and ``cli.train --mesh --device cpu`` over 2
ranks, whose checkpoints and export equal a one-process run of the port
and the JAX package's ``cli.train --mesh`` (its 8-device mesh) within
``test_torch_train.py``'s tolerance for the CLI.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolotpu import quant as jquant
from yolotpu import train as jtrain
from yolotpu import weights as jweights
from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu.parallel import mesh as jmesh
from yolotpu_torch import checkpoint as ckpt
from yolotpu_torch.models import engine_plan, zoo
from yolotpu_torch.models.yolov2 import YoloV2Q, params_fp32
from yolotpu_torch.parallel import dryrun, launch
from yolotpu_torch.parallel.mesh import make_mesh, tp_sharded
from yolotpu_torch.train import make_train_step, zeros_like_velocity
from yolotpu_torch.weights import WeightStore

import torch_parallel_ranks as ranks
from test_torch_general_conv import MIXED_CFG, MIXED_SIZE, NET_TIERS, _net

N = 8
SIZE, BATCH = 64, 4


SP_TIERS = ("int16", "int8")


def _mixed_job(root: str) -> dryrun.Job:
    """The mixed cfg as a job for ``ranks.sp_general``: its text as
    ``net.cfg`` under ``root``, BATCH seeded frames, the int16 and int8 Q
    tables and params (files under ``root``, as dryrun.Job reads them)."""
    spec, store = _net(MIXED_CFG, True, SP_TIERS)
    with open(os.path.join(root, "net.cfg"), "w") as f:
        f.write(MIXED_CFG)
    for tier in SP_TIERS:
        os.makedirs(os.path.join(root, tier))
        for name, p in dryrun.TIER_PARAMS[tier](spec, store).items():
            for leaf, v in p.items():
                np.save(os.path.join(root, tier, f"{name}.{leaf}.npy"),
                        v.numpy())
    x = np.random.default_rng(96).random((BATCH, MIXED_SIZE, MIXED_SIZE, 3),
                                         dtype=np.float32)
    qtables = {"int16": store.qtables, "int8": store.qtables8}
    return dryrun.Job(MIXED_SIZE, time.time(), {}, x, (), SP_TIERS, qtables,
                      root)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """yolov2 64x64 for the cases, 32x32 for the dryrun, the mixed cfg for
    the general convs under sp; their weights in files that every rank
    maps."""
    return (dryrun.make_job(N, str(tmp_path_factory.mktemp("job64")), SIZE,
                            BATCH, ranks.TIERS),
            dryrun.make_job(N, str(tmp_path_factory.mktemp("job32")), 32),
            _mixed_job(str(tmp_path_factory.mktemp("mixed"))))


@pytest.fixture(scope="module")
def world(jobs):
    """Rank 0's result and the others', from one world of 8."""
    return launch.spawn(ranks.cases, N, "cpu", args=jobs, timeout=600)


@pytest.fixture(scope="module")
def one_process(jobs):
    """The port's one-process forward of each tier on the whole batch."""
    job = jobs[0]
    spec = zoo.build("yolov2", width=SIZE, height=SIZE)
    x = torch.from_numpy(job.x)
    out = {}
    for tier in ranks.TIERS:
        out[tier] = YoloV2Q(spec, job.qtables[tier], job.params(tier), "cpu",
                            tier,
                            outputs=dryrun.OUTPUTS)(x)
    return out


def _equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(torch.from_numpy(got[k]), want[k]), k


@pytest.fixture(scope="module")
def jax_heads(jobs):
    """The JAX package's unsharded head of each tier on the same frames,
    its weights quantized with the same activation Qs."""
    job = jobs[0]
    jspec = jzoo.build("yolov2", width=SIZE, height=SIZE)
    jstore = jweights.WeightStore.synthetic(jspec, seed=0)
    jquant.quantize_weights(jstore, job.qtables["int16"].act_q)
    jquant.quantize_weights_w8a16(jstore, job.qtables["int16"].act_q)
    jquant.quantize_weights_int8(jstore, job.qtables["int8"].act_q)
    tiers = {"int16": (jstore.qtables, jy.params_int16),
             "int8": (jstore.qtables8, jy.params_int8),
             "w8a16": (jstore.qtables_w8, jy.params_w8a16)}
    out = {}
    for tier, (qt, params) in tiers.items():
        fwd = jax.jit(jy.build_forward(jspec, tier, qt, compute="int32",
                                       outputs=("head",)))
        out[tier] = np.asarray(fwd(params(jspec, jstore),
                                   jnp.asarray(job.x))["head"])
    return out


@pytest.fixture(scope="module")
def jax_mixed_heads(jobs):
    """The JAX package's unsharded head of the mixed cfg in each sp tier on
    the sp case's frames, run with the job's Q tables; its weights come from
    its own host layer (seed 0, the same calibration image), which gave it
    the same tables."""
    job = jobs[2]
    jspec, jstore = _net(MIXED_CFG, False, SP_TIERS)
    out = {}
    for tier in SP_TIERS:
        qattr, jparams, _ = NET_TIERS[tier]
        qt = jweights.QTables(**vars(job.qtables[tier]))
        assert getattr(jstore, qattr) == qt, tier
        fwd = jax.jit(jy.build_forward(jspec, tier, qt, compute="int32",
                                       outputs=("head",)))
        out[tier] = np.asarray(fwd(jparams(jspec, jstore),
                                   jnp.asarray(job.x))["head"])
    return out


@pytest.fixture(scope="module")
def jax_mesh_steps(jobs):
    """The JAX package's train step on its (dp=2, tp=4) mesh of the 8 CPU
    devices, from the job's fp32 params and batch (the images over dp):
    {clip: (loss, params, velocity)} as numpy."""
    job = jobs[0]
    jspec = jzoo.build("yolov2", width=SIZE, height=SIZE)
    mesh = jmesh.make_mesh(N)
    params = {k: {leaf: jnp.asarray(v.numpy()) for leaf, v in p.items()}
              for k, p in job.params("fp32").items()}
    sh = jmesh.param_shardings(params, mesh)
    put = lambda t: jax.tree_util.tree_map(
        jax.device_put, t, sh, is_leaf=lambda x: not isinstance(x, dict))
    batch = {k: jnp.asarray(v) for k, v in job.batch.items()}
    batch["images"] = jax.device_put(batch["images"],
                                     jmesh.batch_sharding(mesh))
    out = {}
    for clip in ranks.CLIPS:
        step = jax.jit(jtrain.make_train_step(jspec, clip_norm=clip,
                                              mesh=mesh))
        p, v, loss = step(put(params),
                          put(jtrain.zeros_like_velocity(params)), batch)
        out[clip] = (float(loss), jax.tree_util.tree_map(np.asarray, p),
                     jax.tree_util.tree_map(np.asarray, v))
    return out


@pytest.mark.parametrize("mesh", ["tp", "sp"])
def test_int16_sharded_equals_one_process_and_jax(world, one_process,
                                                  jax_heads, mesh):
    got = world[0][f"{mesh}_int16"]
    _equal(got, one_process["int16"])
    np.testing.assert_array_equal(got["head"], jax_heads["int16"])


@pytest.mark.parametrize("tier", ["int8", "w8a16"])
def test_tp_tier_equals_one_process_and_jax(world, one_process, jax_heads,
                                            tier):
    got = world[0][f"tp_{tier}"]
    _equal(got, one_process[tier])
    np.testing.assert_array_equal(got["head"], jax_heads[tier])


def test_int8_under_sp_equals_one_process_and_jax(world, one_process,
                                                  jax_heads):
    """The int8 tier over (dp=2, sp=4): one card folds the pools after
    convs 0, 2, 6 and 10 into their conv; on a slab with its halo rows the
    pool windows would shift by a row, so the sharded model runs those
    convs unfused, and the head and detections still equal one process's
    and the JAX package's."""
    spec = zoo.build("yolov2", width=SIZE, height=SIZE)
    route = engine_plan.kernels(spec, "int8")
    assert [i for i, (k, _) in route.items() if k == "conv3_pool"] == [
        0, 2, 6, 10]
    got = world[0]["sp_int8"]
    _equal(got, one_process["int8"])
    np.testing.assert_array_equal(got["head"], jax_heads["int8"])


@pytest.mark.parametrize("case", ["tp_int16", "sp_int16"])
def test_collective_bytes_follow_the_shapes(world, case):
    """Each rank receives, per forward: under tp, the other 3 Cout blocks
    of every sharded conv's int16 output (pooled where the conv folds the
    pool after it: a quarter of the rows); under sp, the neighbours' two
    edge rows before each 3x3 conv on a slab (every rank's, as one
    all-gather) and the other 3 slabs at the gather, here before the pool
    at layer 17 (slabs of 16, 8, 4, 2 and then 1 row)."""
    spec = zoo.build("yolov2", width=SIZE, height=SIZE)
    b = BATCH // 2
    want = {}
    if case == "tp_int16":
        route = engine_plan.kernels(spec, "int16")
        want["tp_gather"] = sum(3 * b * l.out_h * l.out_w * l.n // 4 * 2
                                // (4 if route[l.idx][0] == "conv3_pool"
                                    else 1)
                                for l in spec.conv_layers()
                                if l.n % 4 == 0)
    else:
        halo = gather = 0
        for l in spec.layers:
            if l.idx == 17:
                gather = 3 * b * (l.h // 4) * l.w * l.c * 2
                break
            if getattr(l, "size", 0) == 3 and hasattr(l, "n"):
                halo += 3 * b * 2 * l.w * l.c * 2
        want = {"sp_halo": halo, "sp_gather": gather}
    for rec in world:
        assert rec["bytes"][case] == want


@pytest.mark.parametrize("tier", SP_TIERS)
def test_general_convs_under_sp_equal_one_process(world, jobs,
                                                  jax_mixed_heads, tier):
    """The mixed cfg over (dp=4, sp=2): the head equals the one-process
    forward of the whole batch and the JAX package's unsharded head on the
    same frames; its first layer, a 7x7/s2 conv, cannot run
    on a slab, so each rank's only collective is the gather of its dp
    group's quantized input (one frame, the other 48 rows)."""
    job = jobs[2]
    spec = _net(MIXED_CFG, True, SP_TIERS)[0]
    one = YoloV2Q(spec, job.qtables[tier], job.params(tier), "cpu", tier,
                  outputs=("head",))(torch.from_numpy(job.x))["head"]
    got = world[0]["sp_general"][tier]
    assert torch.equal(torch.from_numpy(got), one)
    np.testing.assert_array_equal(got, jax_mixed_heads[tier])
    width = 2 if tier == "int16" else 1
    for rec in world:
        assert rec["bytes"]["sp_general"][tier] == {
            "sp_gather": MIXED_SIZE // 2 * MIXED_SIZE * 3 * width}


def _hold_step(got: dict, loss: float, params: dict, velocity: dict) -> None:
    """The gathered sharded step ``got`` against a reference step's loss,
    new params and velocity (numpy trees)."""
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    for name in params:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got["params"][name][leaf],
                                       params[name][leaf], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name}/{leaf}")
            np.testing.assert_allclose(got["velocity"][name][leaf],
                                       velocity[name][leaf], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name}/{leaf}")


@pytest.mark.parametrize("clip", ranks.CLIPS)
def test_sharded_train_step_matches_single(world, jobs, clip):
    job = jobs[0]
    spec = zoo.build("yolov2", width=SIZE, height=SIZE)
    params = job.params("fp32")
    batch = {k: torch.from_numpy(v) for k, v in job.batch.items()}
    p1, v1, l1 = make_train_step(spec, clip_norm=clip)(
        params, zeros_like_velocity(params), batch)
    _hold_step(world[0][f"train_clip{clip}"], float(l1),
               dryrun.to_numpy(p1), dryrun.to_numpy(v1))
    # the dp sum ran once and each tp-sharded conv's input gradient was
    # summed over tp (one all-reduce each in the backward)
    sharded = [l for l in spec.conv_layers() if l.n % 4 == 0]
    tally = world[0]["bytes"][f"train_clip{clip}"]
    assert tally["dp_grad_reduce"] == 4 * (1 + sum(
        v.numel() for p in params.values() for v in p.values()) - 3 * sum(
        params[f"conv{l.idx}"]["w"].numel() // 4
        + params[f"conv{l.idx}"]["b"].numel() // 4 for l in sharded))
    assert ("tp_norm_reduce" in tally) == (clip > 0)


@pytest.mark.parametrize("clip", ranks.CLIPS)
def test_sharded_train_step_equals_jax_mesh(world, jax_mesh_steps, clip):
    """The port's ranks against the JAX package's GSPMD step on the same
    mesh shape: the Megatron pair, the dp loss scaling and the clip's norm
    summed over tp, held to the JAX package."""
    _hold_step(world[0][f"train_clip{clip}"], *jax_mesh_steps[clip])


@pytest.mark.parametrize("stage", ["train", "int16", "tp", "sp", "kernel"])
def test_dryrun_stage(world, jobs, stage):
    """The dryrun's stages at 32x32 over 8 ranks, each with the line of
    the JAX package's dryrun; stage 2 also against the one-process forward,
    stage 1 against the one-process step."""
    job = jobs[1]
    rec = world[0]["dryrun"]
    assert list(rec["seconds"]) == ["train", "int16", "tp", "sp", "kernel"]
    line = rec["lines"][list(rec["seconds"]).index(stage)]
    assert line.startswith("dryrun_multichip ") and " OK" in line, line
    out = rec["outputs"]
    if stage == "train":
        spec = zoo.build("yolov2", width=32, height=32)
        params = job.params("fp32")
        batch = {k: torch.from_numpy(v) for k, v in job.batch.items()}
        _, _, loss = make_train_step(spec)(params,
                                           zeros_like_velocity(params), batch)
        np.testing.assert_allclose(out["train"]["loss"], float(loss),
                                   rtol=1e-5)
        assert "mesh={'dp': 2, 'tp': 4}" in line
    elif stage == "int16":
        dryrun.check_one_process(job, rec, torch.device("cpu"))
    elif stage == "tp":
        for k, v in out["int16"].items():
            np.testing.assert_array_equal(out["tp_int16"][k], v)
    elif stage == "sp":
        np.testing.assert_array_equal(out["sp"]["head"], out["int16"]["head"])
        assert "mesh={'dp': 2, 'sp': 4}" in line
    else:   # CPU tensors: mm_q16 ran its plain version, no kernel launch
        assert all(v == 0 for counts in rec["launches"].values()
                   for v in counts.values())
        assert "q16 matmul via shard_map over 8 devices" in line


def test_ranks_hold_no_jax(world):
    for rec in world:
        assert rec["loaded"] == rec["loaded_after"] == []


def test_launcher_backend_rules(monkeypatch):
    assert launch.pick_backend(8, "cpu", None) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launch.pick_backend(1, "cuda", None) == "nccl"
    assert launch.pick_backend(8, "cuda", "gloo") == "gloo"
    with pytest.raises(ValueError, match='backend="gloo"'):
        launch.pick_backend(8, "cuda", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.pick_backend(1, "cuda", None)


def test_a_raising_rank_fails_the_world_fast(tmp_path):
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised:(.|\n)*fails on "
                       "purpose"):
        launch.spawn(ranks.fail_on_rank1, 4, "cpu", args=(str(tmp_path),),
                     timeout=300)
    assert time.monotonic() - t < 60
    pids = [int(p.read_text()) for p in tmp_path.glob("*.pid")]
    assert len(pids) == 4
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_train_cli_mesh_over_two_ranks(tmp_path):
    """cli.train --mesh over a world of 2 (dp=1, tp=2: every conv of the
    small cfg tp-sharded, the head included), the port's one-process run
    and the JAX package's cli.train --mesh (its 8 CPU devices, dp=2 x tp=4)
    of the same argv: the port's checkpoints (gathered from the tp blocks)
    agree with both as test_torch_train.py's CLI test holds the port to
    JAX (within 1e-4 of each leaf's change or velocity), and the exports
    agree."""
    from test_torch_train import SMALL_CFG, _close_grad
    from yolotpu import checkpoint as jckpt
    from yolotpu.cli import train as jcli
    from yolotpu_torch.cli import train as cli
    cfg = tmp_path / "small.cfg"
    cfg.write_text(SMALL_CFG)

    def argv(who: str) -> list[str]:
        return ["--cfg", str(cfg), "--synthetic-data", "--batch", "2",
                "--steps", "3", "--ckpt-every", "2", "--seed", "1",
                "--mesh", "--ckpt-dir", str(tmp_path / f"ck_{who}"),
                "--export-weights", str(tmp_path / f"w_{who}")]
    assert launch.spawn(ranks.train_cli, 2, "cpu",
                        args=(argv("mesh") + ["--device", "cpu"],),
                        timeout=300) == [0, 0]
    assert cli.main(argv("one") + ["--device", "cpu"]) == 0
    assert jcli.main(argv("jax")) == 0
    names = sorted(os.listdir(tmp_path / "ck_one"))
    assert names == sorted(os.listdir(tmp_path / "ck_mesh")) == sorted(
        os.listdir(tmp_path / "ck_jax")) == [
        "ckpt_00000002.npz", "ckpt_00000003.npz"]
    spec = _small_spec(cfg)
    init = params_fp32(spec, WeightStore.synthetic(spec, seed=1))
    for name in names:
        s2, p2, v2 = ckpt.load_checkpoint(str(tmp_path / "ck_mesh" / name))
        for ref, load in (("one", ckpt.load_checkpoint),
                          ("jax", jckpt.load_checkpoint)):
            s1, p1, v1 = load(str(tmp_path / f"ck_{ref}" / name))
            assert s1 == s2
            for k in p1:
                for leaf in ("w", "b"):
                    p0 = init[k][leaf].numpy()
                    ulp2 = 2 * np.finfo(np.float32).eps * np.abs(p0).max()
                    _close_grad(p2[k][leaf] - p0,
                                np.asarray(p1[k][leaf]) - p0, 1e-4, ulp2)
                    _close_grad(v2[k][leaf], np.asarray(v1[k][leaf]), 1e-4)
    mesh = WeightStore.load_fp32(spec, str(tmp_path / "w_mesh/weights.bin"),
                                 str(tmp_path / "w_mesh/bias.bin"))
    for ref in ("one", "jax"):
        want = WeightStore.load_fp32(
            spec, str(tmp_path / f"w_{ref}/weights.bin"),
            str(tmp_path / f"w_{ref}/bias.bin"))
        for l in spec.conv_layers():
            for a, b in zip(want.fp32[l.idx], mesh.fp32[l.idx]):
                np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    assert all(tp_sharded(l.n, make_mesh(2)) for l in spec.conv_layers())


def _small_spec(cfg):
    from yolotpu_torch.graph import NetworkSpec
    return NetworkSpec.from_cfg(str(cfg))
