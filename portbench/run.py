"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the check compared beside its limit); the last
lines of standard error repeat the check's numbers. The process runs on the
host CPUs its traffic mix gives it (``cpus``; ``pin``). Without a CUDA
card, or with fewer than the cell asks for, it exits 2 and prints no
result; if JAX,
Flax or the JAX package were loaded into the process by the time the window
closed, it names them and exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "yolotpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``yolotpu_torch`` is not ``yolotpu``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def pin(cpus: int | None) -> None:
    """Run this process, and every thread it starts later, on the last
    ``cpus`` CPUs it may use; None leaves it on all of them."""
    if cpus is not None:
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, allowed[-cpus:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from .manifest import Manifest

    manifest = Manifest(Path.cwd() / "BENCHMARK.json")
    cell = manifest.cell(args.workload)
    traffic = manifest.traffic(cell)
    pin(traffic.cpus)

    import torch

    from .cell import run_cell, say

    if not torch.cuda.is_available():
        say("portbench: no CUDA card is available to this process")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        say(f"portbench: {cell['name']} wants {cell['chips']} cards; "
            f"{torch.cuda.device_count()} available")
        return 2
    result, checks = run_cell(manifest.config(cell), traffic,
                              manifest.metrics(cell, bool(args.trace)),
                              args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T0)
    bad = forbidden_loaded()
    if bad:
        say(f"portbench: the run loaded {', '.join(bad)}")
        return 3
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
