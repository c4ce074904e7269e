"""Engine-plan search on the card: time candidate int16 plans, emit the best.

The counterpart of ``tools/plan_search.py``. The candidates come from
``models.engine_plan``: for each conv that a darknet 2x2/s2 pool follows
and no route reads, each pool order of ``ops.q16.conv3x3_pool_q16`` that a
legal kind gives it, beside the unfused conv (``POOL_KINDS``: "acc" as
``entry_sdmm`` at C<=4, else ``sd_pool``; "acc_h" as ``entryf``; "out" as
``conv3p2``), and every combination of them. At yolov2 416 that is conv0
{unfused, acc, acc_h}, conv2 and conv6 {unfused, acc, out} and conv10
{unfused, acc}: 54 rows, among them the default rule and the plan slices P1
and P2 of ``chip_smoke.py``. Each row is a ``YOLO2_Q16_PLAN`` string, so
any row can be run by hand.

One process on one card, yolov2 at 416x416: for each row an int16
``Engine`` (synthetic weights from seed 0, calibrated on one seeded image,
as ``chip_smoke.py`` builds its store), its forward captured as a CUDA
graph at ``--batch``, 8 and 1 on seeded uint8 frames and timed with CUDA
events around back-to-back replays. The rows run in turns over ROUNDS (3)
rounds, the order rotated each round; each row's engine and graphs are
freed before the next. Every row's heads must be ``torch.equal`` to the
rule's at each batch, or the tool exits 1 and emits no plan. One plan per
card serves every batch: the stream serves b=8, ``detect`` and the latency
runs b=1, eval b=16, a bulk run ``--batch``. So a row may win only where it
beats the rule at every batch measured, each by more than the larger of the
two rows' spreads (max - min over the rounds). No workload says yet which
batch weighs most, so each weighs the same: of those rows the one whose
medians, each over the rule's at its batch, have the least mean wins.
Where no row beats the rule, the plan is the rule's (empty).

It writes every row's readings to ``--out`` (default
``<plan_dir()>/plan_search_yolov2_416_<card>.json``) and, with
``--emit-plan``, ``<plan_dir()>/<device_kind_slug(card)>.json``, the plan
that ``engine_plan.resolve_knobs`` loads on this card for this network
(its ``plan_key``). It refuses to run without a CUDA device.

    python -m yolotpu_torch.tools.plan_search [--batch 128] [--emit-plan]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..graph import RouteSpec
from ..models import engine_plan

# pool order -> the kinds that fold the pool in that order, the first legal
# one taken (an entry conv takes the entry kind of its order)
POOL_KINDS = {"acc": ("entry_sdmm", "sd_pool"), "acc_h": ("entryf",),
              "out": ("conv3p2",)}
MODEL, SIZE = "yolov2", 416
ROUNDS = 3
SMALL_BATCHES = (8, 1)   # read beside --batch
# back-to-back replays a timing and timings a reading, by batch
REPLAYS = {1: 50, 8: 20}
REPLAYS_LARGE = 5
TIMINGS = 3


def candidates(spec) -> dict[int, dict[str, str | None]]:
    """conv idx -> {"unfused": None, pool order: its kind, ...} for each conv
    that a darknet 2x2/s2 pool follows and no route reads, the orders that
    a legal kind gives it."""
    routed = {s for l in spec.layers if isinstance(l, RouteSpec)
              for s in l.layers}
    out = {}
    for l in spec.conv_layers():
        if l.idx in routed or not engine_plan.next_is_pool22(spec, l.idx):
            continue
        options: dict[str, str | None] = {"unfused": None}
        for order, kinds in POOL_KINDS.items():
            for kind in kinds:
                try:
                    engine_plan.select_engine(l, spec, {l.idx: kind})
                except ValueError:
                    continue
                options[order] = kind
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


def choose(rows: list[dict]) -> dict | None:
    """The winning row: of the rows that beat the rule's ("" plan) at every
    batch read, each by more than the larger of the two spreads, the one
    with the least mean of its medians over the rule's; None where no row
    beats the rule (it stays)."""
    rule = next(r for r in rows if r["plan"] == "")

    def beats(r) -> bool:
        return all(rule["median"][b] - r["median"][b]
                   > max(rule["spread"][b], r["spread"][b])
                   for b in rule["median"])
    def ratio(r) -> float:
        return float(np.mean([r["median"][b] / rule["median"][b]
                              for b in rule["median"]]))
    wins = [r for r in rows if r is not rule and beats(r)]
    return min(wins, key=ratio, default=None)


def plan_document(device_kind: str, spec, model: str, rows: list[dict],
                  batch: int, evidence: str, date: str, smi: str) -> dict:
    """The plan file of ``device_kind`` for ``spec``, from the search's rows
    (each {"plan", "median", "spread"}, readings in ms by "b<batch>")."""
    win = choose(rows)
    rule = next(r for r in rows if r["plan"] == "")
    return {
        "device_kind": device_kind,
        "model": model,
        "size": [spec.net.width, spec.net.height],
        "plan_key": engine_plan.plan_key(spec),
        "plan": {str(i): k for i, k in sorted(
            engine_plan._parse_plan_items(win["plan"] if win else "").items())},
        "batch": batch,
        "winner": {"plan": win["plan"], "median_ms": win["median"],
                   "spread_ms": win["spread"]} if win else None,
        "rule": {"median_ms": rule["median"], "spread_ms": rule["spread"]},
        "evidence": evidence,
        "date": date,
        "nvidia_smi": smi,
    }


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _row_env(plan: str, empty_dir: str):
    """YOLO2_Q16_PLAN at ``plan`` and no plan file: the engine runs the row
    and nothing else."""
    keys = ("YOLO2_Q16_PLAN", "YOLO2_PLAN_DIR")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["YOLO2_Q16_PLAN"] = plan
    os.environ["YOLO2_PLAN_DIR"] = empty_dir
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def measure_row(spec, store, plan: str, frames: dict, dev,
                empty_dir: str) -> tuple[dict, dict]:
    """One row once: ({"b<batch>": ms}, {batch: heads}) of an int16 Engine
    under ``plan`` alone, its graphs captured by one request each; the
    engine and its graphs are freed before it returns."""
    import torch

    from ..runtime.engine import Engine
    with _row_env(plan, empty_dir):
        eng = Engine(spec, store, "int16", dev, warmup=False)
    want = engine_plan.plan(spec, engine_plan._parse_plan_items(plan))
    if eng.plan_source is not None or eng.model.kinds != want:
        raise AssertionError(f"row {plan!r}: the engine runs {eng.model.kinds} "
                             f"from {eng.plan_source}; want {want}")
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
    ref = None
    with tempfile.TemporaryDirectory() as empty:
        # the rule first, for the reference heads; it is not timed
        _, ref = measure_row(spec, store, "", frames, dev, empty)
        for r in range(rounds):
            k = r * len(rows) // rounds
            t0 = time.perf_counter()
            for plan in rows[k:] + rows[:k]:
                ms, heads = measure_row(spec, store, plan, frames, dev, empty)
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
    ap.add_argument("--emit-plan", action="store_true",
                    help="also write <plan_dir()>/<card>.json from the "
                         "winner (the rule where none wins)")
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
    slug = engine_plan.device_kind_slug(kind)
    plans = engine_plan.plan_dir()
    out = args.out or os.path.join(
        plans, f"plan_search_{MODEL}_{SIZE}_{slug}.json")
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
    plan_path = os.path.join(plans, f"{slug}.json")
    doc = plan_document(kind, spec, MODEL, results, args.batch,
                        os.path.relpath(out, os.path.dirname(plan_path)),
                        time.strftime("%Y-%m-%d"), smi)
    evidence = {"device_kind": kind, "nvidia_smi": smi, "model": MODEL,
                "size": SIZE, "batch": args.batch,
                "batches": [args.batch, *SMALL_BATCHES],
                "rounds": ROUNDS,
                "replays": {b: REPLAYS.get(b, REPLAYS_LARGE)
                            for b in (args.batch, *SMALL_BATCHES)},
                "timings": TIMINGS, "plan_key": doc["plan_key"],
                "winner": doc["winner"], "rows": results,
                "heads_differ": bad, "date": doc["date"],
                "seconds": round(time.perf_counter() - t0, 1)}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(evidence, f, indent=1)
    print(f"[plan_search] wrote {out}; winner: "
          f"{doc['winner']['plan'] if doc['winner'] else 'the rule'}",
          flush=True)
    if bad:
        print(f"[plan_search] heads differ from the rule's under {bad}: no "
              "plan emitted", file=sys.stderr)
        return 1
    if args.emit_plan:
        os.makedirs(plans, exist_ok=True)
        with open(plan_path, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"[plan_search] wrote the card's plan {plan_path}: {doc['plan']}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
