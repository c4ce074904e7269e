"""Run one function in n ranks of a torch.distributed world.

``spawn(fn, n, device, backend)`` starts n processes (always the ``spawn``
start method: a parent that already holds a CUDA context cannot fork one),
each with its process group initialised through a file in a fresh
temporary directory (no port, so concurrent worlds never clash) and a
``timeout`` on every collective, calls ``fn(device, *args)`` in each, and
returns the results in rank order. Rank r runs on ``cuda:(r % cards)``, or
on the CPU with one thread.

The parent waits with a deadline. When a rank raises, dies, or the
deadline passes, it kills every rank and raises, naming the rank and
carrying its traceback: a hung collective can hold no caller past the
deadline. The backend is the caller's: with none given it is ``nccl``
when each rank has a card of its own and ``gloo`` on the CPU; ranks that
would share a card need ``backend="gloo"`` named (NCCL refuses two ranks
on one card, and gloo takes CUDA tensors through the host).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist


def pick_backend(n: int, device: str, backend: str | None) -> str:
    """The backend for n ranks on ``device`` ("cuda" or "cpu")."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r} (cuda or cpu)")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn on cuda: no CUDA device is available to "
                           "this process")
    if backend is not None:
        return backend
    if device == "cpu":
        return "gloo"
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(f"{n} ranks on {cards} card(s) would share a card, "
                         "which NCCL refuses: pass backend=\"gloo\" to run "
                         "them with host-staged collectives")
    return "nccl"


def _rank_main(rank: int, n: int, device: str, backend: str, tmp: str,
               timeout: float, results) -> None:
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)   # written by spawn, in this run
        if device == "cpu":
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        rdv = "file://" + os.path.join(tmp, "rdv")
        # NCCL binds each rank to its card up front (else it guesses)
        bind = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=rdv, world_size=n,
                                rank=rank, timeout=timedelta(seconds=timeout),
                                **bind)
        out = fn(dev, *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, which kills the world
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, n: int, device: str = "cuda", backend: str | None = None,
          args: tuple = (), timeout: float = 600.0) -> list:
    """``fn(device, *args)`` in n ranks -> [each rank's result] (picklable:
    return numpy arrays and numbers, not CUDA tensors). ``fn`` must be
    importable by name (a module-level function). Raises RuntimeError when
    a rank fails or the ``timeout`` seconds pass, with every rank killed."""
    backend = pick_backend(n, device, backend)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="yolotpu_rdv_")
    # the call goes through a file: a process's arguments go down a pipe
    # that its child reads only after importing the parent's main module,
    # so large ones would start the ranks one after another
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n, device, backend, tmp, timeout, results)) for r in range(n)]
    out: dict[int, object] = {}
    failed = None
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < n and failed is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failed = (f"the world of {n} timed out after {timeout:.0f} s; "
                          f"ranks {sorted(set(range(n)) - set(out))} never "
                          "reported")
                break
            try:
                rank, ok, val = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failed = (f"rank {dead[0]} exited with code "
                              f"{procs[dead[0]].exitcode} without a result")
                continue
            if ok:
                out[rank] = val
            else:
                failed = f"rank {rank} raised:\n{val}"
    finally:
        grace = time.monotonic() + (30 if len(out) == n else 0)
        for p in procs:
            if p.pid is None:   # start() raised before this one
                continue
            p.join(timeout=max(0.0, grace - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, {n}, "
                           f"{device!r}, {backend!r}): {failed}")
    return [out[r] for r in range(n)]
