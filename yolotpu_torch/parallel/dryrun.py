"""The multi-GPU dryrun: the counterpart of
``__graft_entry__.dryrun_multichip``, in its five stages, each printing
the JAX package's line (``MULTICHIP_r05.json``) with its elapsed seconds:

1. one train step on ``make_mesh(n)`` (batch over dp, conv Cout over tp);
2. int16 ("head", "detections") with the batch over dp and the params
   replicated;
3. the same forward with the convs tp-sharded: head and detections
   ``torch.equal`` to stage 2's (and so for each tier of the job's
   ``tiers``, each against its own replicated run);
4. ``make_mesh_sp(n)``: activations split on H, the head ``torch.equal``
   to stage 2's;
5. ``q16.mm_q16`` on each rank's rows (M = 8n, K = N = 64, operands drawn
   as the JAX package draws them), gathered and ``torch.equal`` to one
   call over all rows: its ``shard_map`` stage.

``dryrun_multichip`` makes the inputs from seed 0 (``make_job``: ``BATCH``
frames, the tiers ``TIERS``) in a directory of the caller's, builds the
kernels once, runs ``run_stages`` in n ranks (``launch.spawn``) and holds
stage 2 to the one-process forward on the whole batch. Every stage
runs the whole 31-layer yolov2 graph; each inference stage runs its
forward twice, the second timed. Each rank returns its stage lines,
seconds, ms per forward, the bytes each collective kind received
(``comm``) and the kernel launches of each stage; rank 0 also returns the
gathered outputs.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models import zoo
from ..models.yolov2 import (YoloV2Q, params_fp32, params_int8, params_int16,
                             params_w8a16)
from ..ops import _build, nms, q8, q16
from ..quant import (calibrate_activations, calibrate_activations_int8,
                     quantize_weights, quantize_weights_int8,
                     quantize_weights_w8a16)
from ..train import make_train_step, zeros_like_velocity
from ..weights import WeightStore
from . import comm, launch
from .forward import ShardedYoloV2Q, gather_batch
from .mesh import (Sharding, batch_sharding, make_mesh, make_mesh_sp,
                   param_shardings, shard_params, spatial_batch_sharding)

OUTPUTS = ("head", "detections")
TIER_PARAMS = {"int16": params_int16, "int8": params_int8,
               "w8a16": params_w8a16}
MM_SHIFT = 7
BATCH = 8                   # the train batch and the inference frames
TIERS = ("int16", "int8")   # the tiers stage 3 holds to their replicated run
RANK_TIMEOUT_S = 300.0      # the ranks' deadline (``launch.spawn``)


@dataclass
class Job:
    """What every rank is given: the yolov2 input size, the dryrun's start
    (``time.time()``), the train batch, the inference frames, the mm
    stage's operands, the tiers the tp stage holds to their replicated
    run, each tier's Q tables, and the directory that holds each tier's
    full parameter tree (``params``)."""

    size: int
    t0: float
    batch: dict
    x: np.ndarray
    mm: tuple
    tiers: tuple
    qtables: dict
    root: str

    def params(self, tier: str) -> dict:
        """The full tree of ``tier`` ("fp32" or one of ``tiers``) as CPU
        tensors over copy-on-write maps of the files: the ranks of one
        machine share the pages, and each copies only what it slices."""
        out = {}
        for f in sorted(os.listdir(os.path.join(self.root, tier))):
            name, leaf = f[:-len(".npy")].split(".")
            out.setdefault(name, {})[leaf] = torch.from_numpy(np.load(
                os.path.join(self.root, tier, f), mmap_mode="c"))
        return out


def make_job(n_devices: int, root: str, size: int = 32, batch: int = BATCH,
             tiers: tuple[str, ...] = TIERS) -> Job:
    """The inputs from seed 0, drawn as ``__graft_entry__`` draws them but
    at ``batch`` frames where it takes 2 dp and 2n: a train batch with 8
    boxes a frame, one calibration image, the inference frames and the mm
    stage's int16 operands; the synthetic weights (seed 0) in fp32 and
    quantized for each tier, written under ``root``."""
    t0 = time.time()
    unknown = set(tiers) - set(TIER_PARAMS)
    if unknown or "int16" not in tiers:
        raise ValueError(f"tiers {tiers}: int16 and any of "
                         f"{tuple(TIER_PARAMS)}")
    spec = zoo.build("yolov2", width=size, height=size)
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(0)
    b, m = batch, 8
    train = {
        "images": rng.random((b, size, size, 3), dtype=np.float32),
        "boxes": np.stack([rng.uniform(0.3, 0.7, (b, m)),
                           rng.uniform(0.3, 0.7, (b, m)),
                           rng.uniform(0.1, 0.3, (b, m)),
                           rng.uniform(0.1, 0.3, (b, m))],
                          axis=-1).astype(np.float32),
        "classes": rng.integers(0, 80, (b, m)).astype(np.int32),
        "mask": np.ones((b, m), np.float32),
    }
    calib = [rng.random((3, size, size)).astype(np.float32)]
    act_q = calibrate_activations(spec, store, calib)
    quantize_weights(store, act_q)
    if "w8a16" in tiers:
        quantize_weights_w8a16(store, act_q)
    if "int8" in tiers:
        quantize_weights_int8(store, calibrate_activations_int8(
            spec, store, calib))
    x = rng.random((b, size, size, 3), dtype=np.float32)
    mrows, k, n = 8 * n_devices, 64, 64
    mm = (rng.integers(-32768, 32768, (mrows, k)).astype(np.int16),
          rng.integers(-32768, 32640, (k, n)).astype(np.int16),
          rng.integers(-20000, 20000, n).astype(np.int32))
    qtables = {"int16": store.qtables, "int8": store.qtables8,
               "w8a16": store.qtables_w8}
    for tier in ("fp32", *tiers):
        params = (params_fp32 if tier == "fp32" else TIER_PARAMS[tier])(
            spec, store)
        os.makedirs(os.path.join(root, tier))
        for name, p in params.items():
            for leaf, v in p.items():
                np.save(os.path.join(root, tier, f"{name}.{leaf}.npy"),
                        v.numpy())
    return Job(size, t0, train, x, mm, tuple(tiers),
               {t: qtables[t] for t in tiers}, root)


def launch_counts() -> dict:
    """Every kernel's launches in this process so far."""
    return {**q16.LAUNCHES, **q8.LAUNCHES, **nms.LAUNCHES}


def jax_modules() -> list[str]:
    """The modules of JAX and the JAX package loaded in this process."""
    return sorted(m for m, v in sys.modules.items() if v is not None
                  and m.split(".")[0] in ("jax", "jaxlib", "yolotpu"))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def twice(fn, device: torch.device, tally: dict) -> tuple:
    """fn()'s first result, and the ms of a second call (every rank
    starting together, ``tally`` counting that call only)."""
    out = fn()
    dist.barrier()
    _sync(device)
    tally.clear()
    t = time.perf_counter()
    fn()
    _sync(device)
    return out, (time.perf_counter() - t) * 1e3


def run_stages(device: torch.device, job: Job) -> dict:
    """The five stages in this rank of a world of n (every rank calls it)."""
    rank, n = dist.get_rank(), dist.get_world_size()
    spec = zoo.build("yolov2", width=job.size, height=job.size)
    rec = {"rank": rank, "lines": [], "seconds": {}, "ms": {}, "bytes": {},
           "launches": {}, "outputs": {}}
    clock = [time.perf_counter(), launch_counts()]

    def stage(name: str, msg: str) -> None:
        now, counts = time.perf_counter(), launch_counts()
        rec["seconds"][name] = now - clock[0]
        rec["launches"][name] = {k: v - clock[1][k] for k, v in counts.items()}
        clock[:] = [now, counts]
        line = f"dryrun_multichip {msg} [t={time.time() - job.t0:.0f}s]"
        rec["lines"].append(line)
        if rank == 0:
            print(line, flush=True)

    mesh = make_mesh(n)
    rows = Sharding(mesh, ("dp",))

    # 1. one train step, batch over dp and conv Cout over tp
    params = job.params("fp32")
    shardings = param_shardings(params, mesh)
    local = {k: {leaf: v.to(device) for leaf, v in p.items()}
             for k, p in shard_params(params, mesh).items()}
    batch = {k: rows(torch.from_numpy(v)).contiguous().to(device)
             for k, v in job.batch.items()}
    tally = {}
    step = make_train_step(spec, mesh=mesh, tally=tally)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        _sync(device)
        t = time.perf_counter()
        new_p, new_v, loss = step(local, zeros_like_velocity(local), batch)
        _sync(device)
    rec["ms"]["train"] = (time.perf_counter() - t) * 1e3
    rec["bytes"]["train"] = dict(tally)
    full_p = gather_params_np(new_p, shardings, rank)
    full_v = gather_params_np(new_v, shardings, rank)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if rank == 0:
        rec["outputs"]["train"] = {"loss": loss, "params": full_p,
                                   "velocity": full_v}
    del params, local, new_p, new_v
    stage("train", f"train OK: mesh={dict(mesh.shape)} loss={loss:.4f}")

    # 2. int16 inference, the batch over dp, the params replicated
    qt, iparams = job.qtables["int16"], job.params("int16")
    x = torch.from_numpy(job.x)
    x_dp = batch_sharding(mesh)(x).contiguous().to(device)
    replica = YoloV2Q(spec, qt, iparams, device, "int16", outputs=OUTPUTS)
    out, rec["ms"]["int16"] = twice(lambda: replica(x_dp), device, {})
    want = gather_batch(out, mesh)
    checksum = float(want["head"].sum())
    ndet = int(want["det_valid"].sum())
    if not np.isfinite(checksum):
        raise AssertionError(f"non-finite head checksum {checksum}")
    if rank == 0:
        rec["outputs"]["int16"] = to_numpy(want)
    del replica
    stage("int16", f"int16 inference OK: head checksum {checksum:.4f}, "
          f"{ndet} detections, batch sharded over dp={mesh.shape['dp']}")

    # 3. the convs tp-sharded: bit-equal to the replicated run, per tier
    for tier in job.tiers:
        if tier == "int16":
            tq, tparams, ref = qt, iparams, want
        else:
            tq, tparams = job.qtables[tier], job.params(tier)
            rep = YoloV2Q(spec, tq, tparams, device, tier, outputs=OUTPUTS)
            ref = gather_batch(rep(x_dp), mesh)
            del rep
        tp_model = ShardedYoloV2Q(spec, tq, tparams, mesh, device, tier,
                                  outputs=OUTPUTS)
        out, rec["ms"][f"tp_{tier}"] = twice(lambda: tp_model(x_dp), device,
                                             tp_model.tally)
        rec["bytes"][f"tp_{tier}"] = dict(tp_model.tally)
        got = gather_batch(out, mesh)
        diff = [k for k in ref if not torch.equal(got[k], ref[k])]
        if diff:
            raise AssertionError(f"{tier} tp-sharded {diff} diverged")
        if rank == 0:
            rec["outputs"][f"tp_{tier}"] = to_numpy(got)
        del tp_model
    stage("tp", f"int16 tp-sharded FULL-GRAPH inference OK: tp="
          f"{mesh.shape['tp']}, head + detections bit-equal to replicated "
          "run" + (f" (and {', '.join(job.tiers[1:])})"
                   if len(job.tiers) > 1 else ""))

    # 4. the (dp, sp) mesh: activations split on H
    mesh_sp = make_mesh_sp(n)
    sp_model = ShardedYoloV2Q(spec, qt, iparams, mesh_sp, device, "int16",
                              outputs=("head",))
    x_sp = spatial_batch_sharding(mesh_sp)(x).contiguous().to(device)
    out, rec["ms"]["sp"] = twice(lambda: sp_model(x_sp), device,
                                 sp_model.tally)
    rec["bytes"]["sp"] = dict(sp_model.tally)
    head = gather_batch(out, mesh_sp)["head"]
    if not torch.equal(head, want["head"]):
        raise AssertionError("sp-sharded head diverged")
    if rank == 0:
        rec["outputs"]["sp"] = {"head": to_numpy(head)}
    del sp_model
    stage("sp", f"int16 sp-sharded inference OK: mesh={dict(mesh_sp.shape)}, "
          "H-sharded head bit-equal to replicated run")

    # 5. the q16 kernel on each rank's rows
    xq, w16, bq = (torch.from_numpy(a).to(device) for a in job.mm)
    planes = q16.pack_q16(w16) if device.type == "cuda" else None
    whole = q16.mm_q16(xq, w16, bq, MM_SHIFT, True, planes=planes)
    clock[1] = launch_counts()   # that call is the reference, not the path
    mine = Sharding(mesh, (("dp", "tp"), None))(xq).contiguous()
    got = comm.all_gather(q16.mm_q16(mine, w16, bq, MM_SHIFT, True,
                                     planes=planes), 0, dist.group.WORLD)
    if not torch.equal(got, whole):
        raise AssertionError("mm_q16 under the mesh diverged")
    stage("kernel", f"pallas-under-mesh OK: q16 matmul via shard_map over "
          f"{n} devices, bit-equal")
    rec["blocked"] = all(sys.modules.get(m, 0) is None
                         for m in ("jax", "yolotpu"))
    rec["loaded"] = jax_modules()
    return rec


def gather_params_np(local: dict, shardings: dict, rank: int) -> dict | None:
    """The full tree of a rank's blocks, as numpy on rank 0 (None on the
    others; every rank calls this)."""
    full = comm.gather_params(local, shardings)
    return to_numpy(full) if rank == 0 else None


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str | None = None, size: int = 32, *,
                     root: str) -> dict:
    """The five stages over n ranks on ``device`` ("cuda": ranks on the
    cards, ``backend`` as ``launch.spawn`` takes it; "cpu": gloo), then
    stage 2's head and detections held ``torch.equal`` to the one-process
    forward of the whole batch on ``device``. The job's weights go under
    ``root``, a directory the caller keeps while it reads the job. Returns
    {"job", "ranks" (each rank's record, ``run_stages``)}; raises if any
    stage or rank fails."""
    backend = launch.pick_backend(n_devices, device, backend)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    job = make_job(n_devices, root, size)
    if device == "cuda":
        _build.load_library()   # built here once; the ranks load it
    ranks = launch.spawn(run_stages, n_devices, device, backend, args=(job,),
                         timeout=RANK_TIMEOUT_S)
    check_one_process(job, ranks[0], dev)
    return {"job": job, "ranks": ranks}


def check_one_process(job: Job, rec: dict, device: torch.device) -> None:
    """Hold rank 0's stage-2 head and detections (``rec``) ``torch.equal``
    to the one-process forward of the job's whole batch on ``device``."""
    spec = zoo.build("yolov2", width=job.size, height=job.size)
    model = YoloV2Q(spec, job.qtables["int16"], job.params("int16"), device,
                    "int16", outputs=OUTPUTS)
    one = model(torch.from_numpy(job.x).to(device))
    sharded = rec["outputs"]["int16"]
    diff = [k for k in one
            if not torch.equal(one[k].cpu(), torch.from_numpy(sharded[k]))]
    if diff:
        raise AssertionError(f"the dp run's {diff} differ from the "
                             "one-process forward")
    print(f"dryrun_multichip one-process forward OK: head + detections of "
          f"{job.x.shape[0]} frames bit-equal to the dp run "
          f"[t={time.time() - job.t0:.0f}s]", flush=True)
