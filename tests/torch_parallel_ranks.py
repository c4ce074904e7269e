"""The rank functions of tests/test_torch_parallel.py: module-level, so
that ``parallel.launch.spawn`` can start them by name, and importing only
torch and the port, so that a rank holds no JAX.
"""

import os

import torch
import torch.distributed as dist

from yolotpu_torch.graph import NetworkSpec
from yolotpu_torch.models import zoo
from yolotpu_torch.parallel import dryrun
from yolotpu_torch.parallel.forward import ShardedYoloV2Q, gather_batch
from yolotpu_torch.parallel.mesh import (Sharding, batch_sharding, make_mesh,
                                         make_mesh_sp, param_shardings,
                                         shard_params, spatial_batch_sharding)
from yolotpu_torch.train import make_train_step, zeros_like_velocity

TIERS = ("int16", "int8", "w8a16")
CLIPS = (0.0, 1.0)


def cases(device, job, job_dryrun, job_sp) -> dict:
    """Every multi-rank case of the CPU tests, in one world of 8: the
    sharded forwards of ``job`` (each tier under (dp, tp), int16 under
    (dp, sp)), its train step with the clip off and on, the dryrun's five
    stages on ``job_dryrun``, and ``job_sp``'s cfg, whose general convs
    gather H, under (dp, sp=2) (``sp_general``). Rank 0 returns the
    gathered outputs."""
    rank, n = dist.get_rank(), dist.get_world_size()
    spec = zoo.build("yolov2", width=job.size, height=job.size)
    mesh, mesh_sp = make_mesh(n), make_mesh_sp(n)
    x = torch.from_numpy(job.x)
    out = {"loaded": dryrun.jax_modules(), "bytes": {}}
    for tier in TIERS:
        qt, params = job.qtables[tier], job.params(tier)
        model = ShardedYoloV2Q(spec, qt, params, mesh, device, tier,
                               outputs=dryrun.OUTPUTS)
        out[f"tp_{tier}"] = gather_batch(model(batch_sharding(mesh)(x)), mesh)
        out["bytes"][f"tp_{tier}"] = dict(model.tally)
        if tier == "int16":
            model = ShardedYoloV2Q(spec, qt, params, mesh_sp, device, tier,
                                   outputs=dryrun.OUTPUTS)
            out["sp_int16"] = gather_batch(
                model(spatial_batch_sharding(mesh_sp)(x)), mesh_sp)
            out["bytes"]["sp_int16"] = dict(model.tally)
    full = job.params("fp32")
    shardings = param_shardings(full, mesh)
    local = shard_params(full, mesh)
    rows = Sharding(mesh, ("dp",))
    batch = {k: rows(torch.from_numpy(v)).contiguous()
             for k, v in job.batch.items()}
    for clip in CLIPS:
        tally = {}
        step = make_train_step(spec, clip_norm=clip, mesh=mesh, tally=tally)
        p, v, loss = step(local, zeros_like_velocity(local), batch)
        out[f"train_clip{clip}"] = {
            "loss": float(loss),
            "params": dryrun.gather_params_np(p, shardings, rank),
            "velocity": dryrun.gather_params_np(v, shardings, rank)}
        out["bytes"][f"train_clip{clip}"] = tally
    out["sp_general"] = sp_general(device, job_sp)
    out["bytes"]["sp_general"] = out["sp_general"].pop("bytes")
    out["dryrun"] = dryrun.run_stages(device, job_dryrun)
    out["loaded_after"] = dryrun.jax_modules()
    if rank:
        return {k: out[k] for k in ("loaded", "loaded_after", "bytes")}
    return {k: dryrun.to_numpy(v) if k.startswith(("tp_", "sp_")) else v
            for k, v in out.items()}


def sp_general(device, job) -> dict:
    """The cfg ``net.cfg`` under ``job.root`` in each of the job's tiers over
    a (dp, sp=2) mesh of the world, each rank on its H slab of its frames:
    each tier's gathered head, and the bytes each collective kind received
    per tier."""
    spec = NetworkSpec.from_cfg(os.path.join(job.root, "net.cfg"))
    mesh = make_mesh_sp(sp=2)
    x = spatial_batch_sharding(mesh)(torch.from_numpy(job.x)).contiguous()
    out = {"bytes": {}}
    for tier in job.tiers:
        model = ShardedYoloV2Q(spec, job.qtables[tier], job.params(tier), mesh,
                               device, tier, outputs=("head",))
        out[tier] = gather_batch(model(x), mesh)["head"]
        out["bytes"][tier] = dict(model.tally)
    return out


def fail_on_rank1(device, pid_dir: str) -> None:
    """Every rank writes its pid and meets the others; then rank 1 raises
    and the others wait in a barrier that never completes."""
    with open(os.path.join(pid_dir, f"{dist.get_rank()}.pid"), "w") as f:
        f.write(str(os.getpid()))
    dist.barrier()
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def train_cli(device, argv: list[str]) -> int:
    from yolotpu_torch.cli import train
    return train.main(argv)
