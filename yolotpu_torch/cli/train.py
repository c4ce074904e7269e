"""Training CLI: regenerate weight artifacts on the card.

The counterpart of ``yolotpu/cli/train.py``, with its argv and ``--device
cuda|cpu`` (cuda by default; with no card it raises): darknet-format
datasets (image + ``class cx cy w h`` label files) or ``--synthetic-data``
-> region-loss SGD (``train.make_train_step``) -> checkpoints
(``checkpoint.py``, ``--ckpt-every``, ``--resume`` from the latest) -> the
standard weight artifact contract (``--export-weights``).

Dataset format: a list file of image paths; each image's label file sits
next to it with .txt extension (darknet convention).

``--mesh`` trains over a (dp, tp) mesh (``parallel.mesh.make_mesh``) of
one process per card, launched by ``torchrun`` (where the JAX package's
one process drives every device): rank r on ``cuda:LOCAL_RANK``, the
params its tp blocks, the batch its dp rows (every rank draws the same
global batch from ``--seed`` and loads only its share). Checkpoints and
``--export-weights`` gather the tp blocks, and rank 0 writes them whole,
in the one-process format. With one process ``--mesh`` shards nothing, as
the JAX package's with one device; with more than one visible card and no
``torchrun`` it raises, naming the launch:

    python -m yolotpu_torch.cli.train --synthetic-data --steps 20 \\
        --ckpt-dir ckpt --export-weights weights_out
    torchrun --nproc-per-node 8 -m yolotpu_torch.cli.train --mesh \\
        --synthetic-data --batch 16
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def load_batch(paths, labels, spec, rng, batch, max_boxes=30,
               rows: slice = slice(None)):
    """``batch`` images drawn from ``rng``, of which ``rows`` are loaded."""
    from ..eval import load_darknet_labels
    from ..image import letterbox_image, load_image
    idx = rng.integers(0, len(paths), batch)[rows]
    imgs, boxes, classes, mask = [], [], [], []
    for i in idx:
        im = load_image(paths[i])
        imgs.append(letterbox_image(im, spec.net.width, spec.net.height)
                    .transpose(1, 2, 0))
        gt = load_darknet_labels(labels[i])
        n = min(gt.boxes.shape[0], max_boxes)
        b = np.zeros((max_boxes, 4), np.float32)
        c = np.zeros((max_boxes,), np.int32)
        m = np.zeros((max_boxes,), np.float32)
        b[:n], c[:n], m[:n] = gt.boxes[:n], gt.classes[:n], 1.0
        boxes.append(b); classes.append(c); mask.append(m)
    return {"images": np.stack(imgs), "boxes": np.stack(boxes),
            "classes": np.stack(classes), "mask": np.stack(mask)}


def synthetic_batch(spec, rng, batch, max_boxes=30):
    b = np.zeros((batch, max_boxes, 4), np.float32)
    c = np.zeros((batch, max_boxes), np.int32)
    m = np.zeros((batch, max_boxes), np.float32)
    n = 4
    b[:, :n] = rng.uniform(0.2, 0.8, (batch, n, 4)).astype(np.float32)
    b[:, :n, 2:] = rng.uniform(0.05, 0.3, (batch, n, 2)).astype(np.float32)
    c[:, :n] = rng.integers(0, spec.region.classes, (batch, n))
    m[:, :n] = 1.0
    return {"images": rng.random((batch, spec.net.height, spec.net.width, 3),
                                 dtype=np.float32),
            "boxes": b, "classes": c, "mask": m}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="yolo2_train", description=__doc__)
    ap.add_argument("--model", default="yolov2")
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--train-list", default=None,
                    help="file listing training image paths (darknet style)")
    ap.add_argument("--synthetic-data", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--export-weights", default=None,
                    help="directory for weights.bin/bias.bin at the end")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="shard over the torchrun world, dp x tp (one "
                    "process: no-op)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="train on the card (default) or the CPU")
    return ap


def join_world(device: str):
    """The device of this torchrun rank, its process group initialised
    from the environment unless it already is."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", torch.cuda.current_device())))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def main(argv: list[str] | None = None) -> int:
    import torch
    import torch.distributed as dist

    from ..checkpoint import (export_weight_artifacts, latest_checkpoint,
                              load_checkpoint, save_checkpoint)
    from ..graph import NetworkSpec
    from ..models import yolov2 as m
    from ..models import zoo
    from ..parallel import comm
    from ..parallel.mesh import make_mesh, param_shardings, shard_params
    from ..train import make_train_step, zeros_like_velocity
    from ..weights import WeightStore

    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train --device cuda: no CUDA device is available "
                           "to this process")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    own_group = args.mesh and world > 1 and not dist.is_initialized()
    mesh = None
    if args.mesh and (world > 1 or dist.is_initialized()):
        device = join_world(args.device)
        mesh = make_mesh()
        print(f"mesh: {dict(mesh.shape)}, rank {mesh.rank} on {device}")
    elif args.mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise RuntimeError(
            f"--mesh over {n} cards runs one process per card: launch it "
            f"with torchrun --nproc-per-node {n} -m yolotpu_torch.cli.train "
            "--mesh ...")
    lead = mesh is None or mesh.rank == 0
    spec = (NetworkSpec.from_cfg(args.cfg) if args.cfg
            else zoo.build(args.model, width=args.width, height=args.height))
    rng = np.random.default_rng(args.seed)

    def on_device(tree):
        return {k: {leaf: torch.as_tensor(v).to(device)
                    for leaf, v in p.items()} for k, p in tree.items()}

    params = m.params_fp32(spec, WeightStore.synthetic(spec, seed=args.seed),
                           device)
    velocity = zeros_like_velocity(params)
    start_step = 0
    if args.resume:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            start_step, ptree, vtree = load_checkpoint(ck)
            params = on_device(ptree)
            velocity = (on_device(vtree) if vtree
                        else zeros_like_velocity(params))
            if lead:
                print(f"resumed from {ck} at step {start_step}")

    rows = slice(None)
    if mesh is not None:
        shardings = param_shardings(params, mesh)
        params, velocity = (shard_params(t, mesh) for t in (params, velocity))
        dp = mesh.shape["dp"]
        if args.batch % dp:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"dp={dp}")
        share = args.batch // dp
        rows = slice(mesh.coords()["dp"] * share,
                     (mesh.coords()["dp"] + 1) * share)

    def whole(tree):
        return tree if mesh is None else comm.gather_params(tree, shardings)

    paths = labels = None
    if args.train_list:
        paths = [l.strip() for l in open(args.train_list) if l.strip()]
        labels = [os.path.splitext(p)[0] + ".txt" for p in paths]
    elif not args.synthetic_data and lead:
        print("note: no --train-list; using --synthetic-data")

    step_fn = make_train_step(spec, lr=args.lr, momentum=args.momentum,
                              mesh=mesh)
    t0 = time.time()
    for step in range(start_step, args.steps):
        if paths:
            batch = load_batch(paths, labels, spec, rng, args.batch,
                               rows=rows)
        else:
            batch = {k: v[rows] for k, v in
                     synthetic_batch(spec, rng, args.batch).items()}
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in batch.items()}
        params, velocity, loss = step_fn(params, velocity, batch)
        if lead and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step}: loss {float(loss):.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            full_p, full_v = whole(params), whole(velocity)
            if lead:
                p = save_checkpoint(args.ckpt_dir, step + 1, full_p, full_v)
                print(f"checkpoint: {p}")

    full_p, full_v = whole(params), whole(velocity)
    if lead:
        save_checkpoint(args.ckpt_dir, args.steps, full_p, full_v)
        if args.export_weights:
            export_weight_artifacts(full_p, spec, args.export_weights)
            print(f"exported weight artifacts to {args.export_weights}/")
    if mesh is not None:
        dist.barrier()   # rank 0's files are written
    if own_group:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
