"""Performance report bundles: ``yolo2_report.py`` equivalent, on the card.

The reference tool bundles HLS csynth XML, Vivado timing/utilization/power
reports and board logs into ``reports/<ts>_<label>/{meta,metrics}.json +
summary.md`` with a ``compare`` diff view (``scripts/yolo2_report.py``,
``scripts/YOLO2_REPORT_TOOL.md:163-199``). The port's bundle collects:

- run metrics: mean/median/p90 step latency and FPS over ``--steps``
  requests of ``--batch`` uint8 frames served by the engine (each a replay
  of its captured CUDA graph, host copies included; the same statistics
  the reference regexes out of board logs), and the single-frame p50 of
  the engine's batch-1 graph (CUDA events around each replay);
- "utilization": the engine's build time (the kernels' build included) and
  its graph's capture time, the device's peak allocated memory, and with
  ``--profile-layers`` the per-layer rows of ``profile_prefix``;
- environment: the card's name and power limit, torch and CUDA versions,
  precision/compute mode, and the engine's plan (``plan``: each conv's kind
  and its route, [kernel, pool order], as ``engine_plan.kernels`` gives
  it).

Subcommands: init, run, list, compare, parse-log. ``run`` serves on
``--device`` (cuda by default; with no card it raises; cpu runs the
kernels' plain versions eagerly, on the host clock).

Mirrors ``yolotpu/cli/report.py``: ``list``, ``compare``, ``parse-log``,
``_flatten`` and ``parse_inference_log`` are its own; ``run`` measures the
card in place of XLA (``build_seconds`` and ``capture_seconds`` for
``compile_seconds``, ``memory`` for ``memory_analysis``, no
``rpc_floor_ms``). Its ``accuracy`` block is the port's accuracy evidence
of the tier (``yolotpu_torch/plans/accuracy_<precision>.json``, written by
``python -m yolotpu_torch.tools.accuracy_protocol``) when that file's
protocol hash and resolution are the run's; stale evidence is left out.

    python -m yolotpu_torch.cli.report run --label int16_b8 --batch 8 \\
        --synthetic-weights --profile-layers
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from datetime import datetime

REPORT_DIR = "reports"


def accuracy_evidence(precision: str, resolution: int) -> dict | None:
    """The port's accuracy evidence for a tier at a resolution
    (``accuracy_<precision>.json`` in ``engine_plan.plan_dir()``), or None
    where there is none or it is stale: another protocol hash or another
    resolution."""
    from ..accuracy import protocol_hash
    from ..models.engine_plan import plan_dir
    path = os.path.join(plan_dir(), f"accuracy_{precision}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    if (doc.get("protocol_hash") != protocol_hash()
            or doc.get("resolution") != resolution):
        return None
    return doc


def power_limit_w() -> float | None:
    """The first card's power limit in W, as nvidia-smi reports it; None
    where nvidia-smi is not there."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) if out.returncode == 0 else None


def _metrics_run(args) -> dict:
    import numpy as np
    import torch

    from ..models import zoo
    from ..ops import _build
    from ..runtime.engine import Engine, load_or_synthesize
    from ..runtime.profiler import StepTimer

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("report run --device cuda: no CUDA device is "
                           "available to this process")
    spec = zoo.build(args.model, width=args.width, height=args.height)
    store = load_or_synthesize(spec, args.weights_dir, args.precision,
                               synthetic=args.synthetic_weights)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (args.batch, spec.net.height,
                                   spec.net.width, 3), dtype=np.uint8)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if cuda and args.precision != "fp32":
        _build.load_library()
    eng = Engine(spec, store, args.precision, device, compute=args.compute,
                 warmup=False)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.predict_batch_rgb(frames)      # the batch's graph: warm-up, capture
    capture_s = time.perf_counter() - t0

    timer = StepTimer()
    for _i in range(args.steps):
        t0 = time.perf_counter()
        eng.predict_batch_rgb(frames)
        timer.add((time.perf_counter() - t0) * 1e3)
    summary = timer.summary(frames_per_step=args.batch)

    b1 = {}
    if args.batch1_p50:
        # the single-frame latency of the engine's batch-1 graph on the
        # device: CUDA events around each replay (on the CPU, the host clock
        # around each eager forward)
        one = frames[:1]
        eng.predict_batch_rgb(one)
        n = max(8, int(args.batch1_chain))
        ts = eng.forward_ms(one, n)
        b1 = {"batch1_device_p50_ms": round(float(np.median(ts)), 3),
              "batch1_chain": n}

    per_layer = None
    if args.profile_layers:
        # per-layer achieved TOPS / GB/s by the forward's prefixes: the
        # analog of the csynth DSP/LUT/BRAM table the reference report
        # parses (scripts/yolo2_report.py:131+)
        from ..runtime.profiler import profile_prefix
        rep = profile_prefix(spec, store, precision=args.precision,
                             compute=args.compute, batch=args.batch,
                             device=device)
        per_layer = rep.as_dicts()

    # the tier's accuracy evidence at this resolution: the bundle then holds
    # fps, latency and the mAP delta of one configuration
    accuracy = accuracy_evidence(args.precision, spec.net.width)
    return {
        **b1,
        **({"per_layer": per_layer} if per_layer else {}),
        **({"accuracy": accuracy} if accuracy else {}),
        "model": args.model,
        "precision": args.precision,
        "compute": args.compute,
        "batch": args.batch,
        "steps": args.steps,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "platform": "gpu" if cuda else "cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "power_limit_w": power_limit_w() if cuda else None,
        "plan": {"kinds": {str(i): k for i, k in
                           (eng.model.kinds if eng.model else {}).items()},
                 "route": {str(i): list(r) for i, r in
                           (eng.model.route if eng.model else {}).items()}},
        "build_seconds": round(build_s, 2),
        "capture_seconds": round(capture_s, 2),
        "memory": ({"max_memory_allocated_bytes":
                    int(torch.cuda.max_memory_allocated(device))}
                   if cuda else {}),
        "latency": summary,
    }


def _plan_line(plan: dict | None) -> str:
    """The engine's plan in one line: the convs whose kind is not the rule's
    "mm" or "conv3", and those that fold the pool after them."""
    if not plan:
        return "not recorded"
    other = [f"{i}:{k}" for i, k in plan.get("kinds", {}).items()
             if k not in ("mm", "conv3")]
    folds = [f"{i}" + (f" ({o})" if o else "")
             for i, (k, o) in plan.get("route", {}).items()
             if k == "conv3_pool"]
    return (f"kinds {', '.join(other) or 'the rule'}; pools folded at convs "
            f"{', '.join(folds) or 'none'}")


def _render_summary(meta: dict, metrics: dict) -> str:
    lat = metrics.get("latency", {})
    lines = [
        f"# Report: {meta['label']}",
        "",
        f"- timestamp: {meta['timestamp']}",
        f"- model: {metrics['model']}  precision: {metrics['precision']}"
        f" ({metrics['compute']})  batch: {metrics['batch']}",
        f"- device: {metrics['device']} ({metrics['platform']}),"
        f" power limit {metrics['power_limit_w']} W,"
        f" torch {metrics['torch_version']}, CUDA {metrics['cuda_version']}",
        f"- build: {metrics['build_seconds']} s, graph capture:"
        f" {metrics['capture_seconds']} s",
        f"- plan: {_plan_line(metrics.get('plan'))}",
        "",
        "## Latency / throughput",
        f"- steps: {lat.get('count', 0)}",
        f"- mean: {lat.get('mean_ms', 0):.2f} ms   median: "
        f"{lat.get('median_ms', 0):.2f} ms   p90: {lat.get('p90_ms', 0):.2f} ms",
        f"- throughput: {lat.get('fps', 0):.1f} frames/sec",
    ]
    if metrics.get("batch1_device_p50_ms") is not None:
        lines.append(
            f"- single-frame device p50: {metrics['batch1_device_p50_ms']}"
            f" ms ({metrics.get('batch1_chain')} runs of the batch-1"
            f" {'graph' if metrics['platform'] == 'gpu' else 'forward'})")
    acc = metrics.get("accuracy")
    if acc:
        lines += [
            "",
            "## Accuracy (protocol evidence, same tier/resolution)",
            f"- mAP_50: {acc['mAP_50_mean']} ±{acc.get('mAP_50_ci95')}"
            f" ({acc['train']['seeds']} seeds, {acc['eval_scenes']} scenes,"
            f" {acc['classes']} classes)",
            f"- delta vs fp32: {acc['delta_vs_fp32_mean']:+}"
            f" ±{acc.get('delta_vs_fp32_ci95')}"
            f" (protocol {acc['protocol']} {acc['protocol_hash']})",
        ]
    lines += [
        "",
        "## Memory (device)",
    ]
    for k, v in metrics.get("memory", {}).items():
        lines.append(f"- {k}: {v / 1e6:.1f} MB")
    if metrics.get("per_layer"):
        lines += ["", "## Per-layer utilization (in-forward prefix deltas)",
                  "", "| layer | type | ms | TOPS | GB/s | detail |",
                  "|---|---|---|---|---|---|"]
        for t in metrics["per_layer"]:
            lines.append(f"| {t['idx']} | {t['type']} | {t['ms']:.3f} | "
                         f"{t['tops']:.1f} | {t['gbs']:.0f} | "
                         f"{t['detail']} |")
    return "\n".join(lines) + "\n"


def cmd_run(args) -> int:
    metrics = _metrics_run(args)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    d = os.path.join(args.report_dir, f"{ts}_{args.label}")
    os.makedirs(d, exist_ok=True)
    meta = {"label": args.label, "timestamp": ts,
            "argv": sys.argv[1:]}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    with open(os.path.join(d, "summary.md"), "w") as f:
        f.write(_render_summary(meta, metrics))
    print(d)
    return 0


def cmd_list(args) -> int:
    if not os.path.isdir(args.report_dir):
        return 0
    for name in sorted(os.listdir(args.report_dir)):
        mp = os.path.join(args.report_dir, name, "metrics.json")
        if os.path.exists(mp):
            mtr = json.load(open(mp))
            lat = mtr.get("latency", {})
            print(f"{name}: {mtr.get('model')} {mtr.get('precision')}"
                  f" b{mtr.get('batch')} -> {lat.get('fps', 0):.1f} fps"
                  f" (p50 {lat.get('median_ms', 0):.2f} ms)")
    return 0


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, (int, float)):
            out[key] = v
    return out


def cmd_compare(args) -> int:
    ja = json.load(open(os.path.join(args.report_dir, args.a, "metrics.json")))
    jb = json.load(open(os.path.join(args.report_dir, args.b, "metrics.json")))
    a, b = _flatten(ja), _flatten(jb)
    keys = sorted(set(a) | set(b))
    print(f"{'metric':42s} {args.a[:18]:>18s} {args.b[:18]:>18s}   delta")
    for k in keys:
        va, vb = a.get(k), b.get(k)
        if va is None or vb is None:
            continue
        delta = ""
        if isinstance(va, (int, float)) and va:
            delta = f"{100.0 * (vb - va) / abs(va):+.1f}%"
        print(f"{k:42s} {va:>18} {vb:>18}   {delta}")
    # per-layer utilization deltas when both bundles carry the table
    pa = {t["idx"]: t for t in ja.get("per_layer") or []}
    pb = {t["idx"]: t for t in jb.get("per_layer") or []}
    common = sorted(set(pa) & set(pb))
    if common:
        print(f"\n{'layer':>5s} {'type':14s} {'ms A':>8s} {'ms B':>8s}"
              f"   delta   detail")
        for i in common:
            ta, tb = pa[i], pb[i]
            d = (f"{100.0 * (tb['ms'] - ta['ms']) / ta['ms']:+.1f}%"
                 if ta["ms"] else "")
            print(f"{i:5d} {ta['type']:14s} {ta['ms']:8.3f} "
                  f"{tb['ms']:8.3f}   {d:>7s} {tb.get('detail', '')}")
    return 0


def cmd_init(args) -> int:
    os.makedirs(args.report_dir, exist_ok=True)
    print(f"initialized {args.report_dir}/")
    return 0


def parse_inference_log(path: str) -> dict:
    """Extract 'inference time: X ms' lines from a run log and compute
    count/mean/median/p90/FPS — exactly the reference report tool's KV260
    log ingestion (scripts/YOLO2_REPORT_TOOL.md:177-184). The streaming
    runtime emits the same lines at verbosity >= 2."""
    import re
    import numpy as np
    pat = re.compile(r"inference time:\s*([0-9.]+)\s*ms")
    vals = []
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                vals.append(float(m.group(1)))
    if not vals:
        return {"count": 0}
    a = np.asarray(vals)
    return {
        "count": int(a.size),
        "mean_ms": round(float(a.mean()), 3),
        "median_ms": round(float(np.median(a)), 3),
        "p90_ms": round(float(np.percentile(a, 90)), 3),
        "fps": round(float(1000.0 / np.median(a)), 2),
    }


def cmd_parse_log(args) -> int:
    stats = parse_inference_log(args.log)
    print(json.dumps(stats, indent=2))
    return 0 if stats.get("count") else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="yolo2_report", description=__doc__)
    ap.add_argument("--report-dir", default=REPORT_DIR)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("init")
    runp = sub.add_parser("run")
    runp.add_argument("--label", default="run")
    runp.add_argument("--model", default="yolov2")
    runp.add_argument("--precision", default="int16",
                      choices=["fp32", "int16", "int8", "w8a16"])
    runp.add_argument("--compute", default="int32")
    runp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                      help="cuda serves through the engine's captured "
                           "graphs; cpu runs the plain versions eagerly")
    runp.add_argument("--batch", type=int, default=16)
    runp.add_argument("--steps", type=int, default=10)
    runp.add_argument("--width", type=int, default=None)
    runp.add_argument("--height", type=int, default=None)
    runp.add_argument("--weights-dir", default="weights")
    runp.add_argument("--synthetic-weights", action="store_true")
    runp.add_argument("--batch1-p50", action="store_true", default=True,
                      help="measure the single-frame latency of the "
                           "engine's batch-1 graph (default on)")
    runp.add_argument("--no-batch1-p50", dest="batch1_p50",
                      action="store_false")
    runp.add_argument("--batch1-chain", type=int, default=32)
    runp.add_argument("--profile-layers", action="store_true",
                      help="add per-layer achieved TOPS / GB/s to the "
                           "bundle (captures one graph per prefix of the "
                           "forward)")
    sub.add_parser("list")
    cmp_ = sub.add_parser("compare")
    cmp_.add_argument("a")
    cmp_.add_argument("b")
    plog = sub.add_parser("parse-log")
    plog.add_argument("log")
    args = ap.parse_args(argv)
    return {"init": cmd_init, "run": cmd_run, "list": cmd_list,
            "compare": cmd_compare, "parse-log": cmd_parse_log}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
