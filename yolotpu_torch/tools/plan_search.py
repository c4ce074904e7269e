"""Engine-plan search on the card: time int16 routes against the rule's.

The counterpart of ``tools/plan_search.py``. The candidates come from
``models.engine_plan``: for each conv that the int16 rule folds (a regular
3x3 that a darknet 2x2/s2 pool follows and no route reads, in order
"acc"), the rule's route beside each other that a legal kind gives it
through the lever (``POOL_KINDS``: "unfused" as ``conv3``, or ``xla`` at a
C<8 entry conv, where ``conv3`` is not legal; "acc_h" as ``entryf``; "out"
as ``conv3p2``), and every combination of them. At yolov2 416 that is conv0
{acc, unfused, acc_h}, conv2 and conv6 {acc, unfused, out} and conv10
{acc, unfused}: 54 rows, the rule ("") first, the plan slice P2 of
``chip_smoke.py`` among them. Each row is a ``YOLO2_Q16_PLAN`` string, so
any row can be run by hand.

One process on one card, yolov2 at 416x416: for each row an int16
``Engine`` (synthetic weights from seed 0, calibrated on one seeded image,
as ``chip_smoke.py`` builds its store), its forward captured as a CUDA
graph at ``--batch``, 8 and 1 on seeded uint8 frames and timed with CUDA
events around back-to-back replays. The rows run in turns over ROUNDS (3)
rounds, the order rotated each round; each row's engine and graphs are
freed before the next. Every row's heads must be ``torch.equal`` to the
rule's at each batch, or the tool exits 1. It writes every row's readings,
their median and spread (max - min over the rounds), to ``--out``
(default ``<plan_dir()>/plan_search_yolov2_416_<card>.json``). A row that
beats the rule at every batch, each by more than the larger spread, is a
case for changing the rule in ``engine_plan``; one file per card holds the
evidence. The checked-in H100 file was measured when the rule folded
nothing: its "" row is the unfused route, and its winner,
``0:entry_sdmm,2:sd_pool,6:sd_pool,10:sd_pool``, the route the rule takes
now. It refuses to run without a CUDA device.

    python -m yolotpu_torch.tools.plan_search [--batch 128]
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import subprocess
import sys
import time
import unittest.mock

import numpy as np

from ..models import engine_plan

# route -> the kinds that give a conv the rule folds that route, the first
# legal one taken ("acc" is the rule's own: the row names no kind)
POOL_KINDS = {"unfused": ("conv3", "xla"), "acc_h": ("entryf",),
              "out": ("conv3p2",)}
MODEL, SIZE = "yolov2", 416
ROUNDS = 3
SMALL_BATCHES = (8, 1)   # read beside --batch
# back-to-back replays a timing and timings a reading, by batch
REPLAYS = {1: 50, 8: 20}
REPLAYS_LARGE = 5
TIMINGS = 3


def candidates(spec) -> dict[int, dict[str, str | None]]:
    """conv idx -> {"acc": None (the rule), route: its kind, ...} for each
    conv that the int16 rule folds, the routes that a legal kind gives
    it."""
    rule = engine_plan.kernels(spec, "int16")
    out = {}
    for l in spec.conv_layers():
        if rule[l.idx][0] != "conv3_pool":
            continue
        options: dict[str, str | None] = {"acc": None}
        for route, kinds in POOL_KINDS.items():
            for kind in kinds:
                try:
                    engine_plan.select_engine(l, spec, {l.idx: kind})
                except ValueError:
                    continue
                options[route] = kind
                break
        out[l.idx] = options
    return out


def plan_string(kinds: dict[int, str]) -> str:
    return ",".join(f"{i}:{k}" for i, k in sorted(kinds.items()))


def grid(spec) -> list[str]:
    """Every combination of ``candidates``, as YOLO2_Q16_PLAN strings; the
    rule ("") first."""
    cand = candidates(spec)
    rows = []
    for pick in itertools.product(*(list(o.values()) for o in cand.values())):
        rows.append(plan_string({i: k for i, k in zip(cand, pick) if k}))
    return rows


def summarize(ms: dict[str, list[float]]) -> tuple[dict, dict]:
    """(median, spread) of each batch's readings; the spread is max - min."""
    return ({b: float(np.median(v)) for b, v in ms.items()},
            {b: float(max(v) - min(v)) for b, v in ms.items()})


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def replay_ms(graph, replays: int) -> float:
    """ms of one replay: CUDA events around ``replays`` back-to-back
    replays, the median of TIMINGS such timings."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ts = []
    for _ in range(TIMINGS):
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / replays)
    return float(np.median(ts))


def quantized_store(spec):
    """Synthetic int16 weights from seed 0, calibrated on one seeded image
    (chip_smoke.quantized_store's int16 tier)."""
    from ..quant import calibrate_activations, quantize_weights
    from ..weights import WeightStore
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(0)
    calib = [rng.random((3, spec.net.height, spec.net.width),
                        dtype=np.float32)]
    quantize_weights(store, calibrate_activations(spec, store, calib))
    return store


def measure_row(spec, store, plan: str, frames: dict,
                dev) -> tuple[dict, dict]:
    """One row once: ({"b<batch>": ms}, {batch: heads}) of an int16 Engine
    under ``YOLO2_Q16_PLAN=plan``, its graphs captured by one request each;
    the engine and its graphs are freed before it returns."""
    import torch

    from ..runtime.engine import Engine
    with unittest.mock.patch.dict(os.environ, {"YOLO2_Q16_PLAN": plan}):
        eng = Engine(spec, store, "int16", dev, warmup=False)
    want = engine_plan.kernels(spec, "int16",
                               engine_plan._parse_plan_items(plan))
    if eng.model.route != want:
        raise AssertionError(f"row {plan!r}: the engine runs "
                             f"{eng.model.route}; want {want}")
    ms, heads = {}, {}
    try:
        for b, x in frames.items():
            heads[b] = eng.predict_batch_rgb(x)
            g = eng.graphs[(False, torch.uint8, tuple(x.shape))]
            g.graph.replay()
            ms[f"b{b}"] = replay_ms(g.graph, REPLAYS.get(b, REPLAYS_LARGE))
    finally:
        del eng
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return ms, heads


def search(spec, store, rows: list[str], batch: int, rounds: int, dev,
           log=print) -> list[dict]:
    """Every row in turns over ``rounds`` rounds, the order rotated each
    round: its readings, their median and spread, and whether its heads
    equal the rule's."""
    import torch
    rng = np.random.default_rng(0)
    net = (spec.net.height, spec.net.width, 3)
    big = rng.integers(0, 256, (max(batch, *SMALL_BATCHES), *net),
                       dtype=np.uint8)
    frames = {b: np.ascontiguousarray(big[:b])
              for b in (batch, *SMALL_BATCHES)}
    readings = {p: {f"b{b}": [] for b in frames} for p in rows}
    equal = dict.fromkeys(rows, True)
    # the rule first, for the reference heads; it is not timed
    _, ref = measure_row(spec, store, "", frames, dev)
    for r in range(rounds):
        k = r * len(rows) // rounds
        t0 = time.perf_counter()
        for plan in rows[k:] + rows[:k]:
            ms, heads = measure_row(spec, store, plan, frames, dev)
            for key, v in ms.items():
                readings[plan][key].append(v)
            same = all(torch.equal(torch.from_numpy(heads[b]),
                                   torch.from_numpy(ref[b]))
                       for b in frames)
            equal[plan] &= same
            log(f"[plan_search] round {r + 1} {plan or '(rule)':44s} "
                + " ".join(f"{key} {v:.4f}" for key, v in ms.items())
                + ("" if same else "  HEADS DIFFER FROM THE RULE'S"))
        log(f"[plan_search] round {r + 1} of {rounds}: {len(rows)} rows "
            f"in {time.perf_counter() - t0:.1f} s")
    out = []
    for plan in rows:
        med, spread = summarize(readings[plan])
        out.append({"plan": plan, "ms": readings[plan], "median": med,
                    "spread": spread, "heads_equal_rule": equal[plan]})
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rows", default="",
                    help="';'-separated YOLO2_Q16_PLAN rows to run (default "
                         "the whole grid); the rule is always one")
    ap.add_argument("--out", default=None,
                    help="the evidence file (default <plan_dir()>/"
                         "plan_search_yolov2_416_<card>.json)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("plan_search: no CUDA device is available to this process; "
              "the search times plans on the card only", file=sys.stderr)
        return 2
    from ..models import zoo
    from ..ops import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    kind = engine_plan.current_device_kind(dev)
    out = args.out or os.path.join(
        engine_plan.plan_dir(),
        f"plan_search_{MODEL}_{SIZE}_{engine_plan.device_kind_slug(kind)}.json")
    smi = nvidia_smi()
    spec = zoo.build(MODEL, width=SIZE, height=SIZE)
    rows = grid(spec)
    if args.rows:
        want = [p.strip() for p in args.rows.split(";")]
        rows = [""] + [p for p in want if p]
    print(f"[plan_search] {smi}; {MODEL} {SIZE}, {len(rows)} rows, "
          f"{ROUNDS} rounds, b={args.batch} and {SMALL_BATCHES}; "
          f"candidates {candidates(spec)}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    store = quantized_store(spec)
    print(f"[plan_search] kernels built and store calibrated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    results = search(spec, store, rows, args.batch, ROUNDS, dev,
                     log=lambda m: print(m, flush=True))
    key = f"b{args.batch}"
    results.sort(key=lambda r: r["median"][key])
    for r in results:
        print(f"[plan_search] {r['plan'] or '(rule)':44s} median "
              + " ".join(f"{b} {v:.4f} (spread {r['spread'][b]:.4f})"
                         for b, v in r["median"].items())
              + ("" if r["heads_equal_rule"] else "  HEADS DIFFER"), flush=True)
    bad = [r["plan"] for r in results if not r["heads_equal_rule"]]
    evidence = {"device_kind": kind, "nvidia_smi": smi, "model": MODEL,
                "size": SIZE, "batch": args.batch,
                "batches": [args.batch, *SMALL_BATCHES],
                "rounds": ROUNDS,
                "replays": {b: REPLAYS.get(b, REPLAYS_LARGE)
                            for b in (args.batch, *SMALL_BATCHES)},
                "timings": TIMINGS, "rows": results,
                "heads_differ": bad, "date": time.strftime("%Y-%m-%d"),
                "seconds": round(time.perf_counter() - t0, 1)}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(evidence, f, indent=1)
    print(f"[plan_search] wrote {out}", flush=True)
    if bad:
        print(f"[plan_search] heads differ from the rule's under {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
