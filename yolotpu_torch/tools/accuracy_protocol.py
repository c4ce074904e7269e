"""Accuracy evidence run: protocol v2, >=3 seeds, mean +/- CI95, per tier.

The counterpart of ``tools/accuracy_protocol.py``. Trains the full yolov2
graph on protocol-v2 scenes (``yolotpu_torch/accuracy.py``) for N seeds on
``--device`` (the card by default; with no card it raises), quantizes each
trained store per tier as the runtime does, scores every tier on the 64
eval scenes at the same resolution through the port's engines (the integer
tiers on their kernels on a card; ``YOLO2_Q16_PLAN`` sets the int16
tier's plan), and writes ``yolotpu_torch/plans/accuracy_<tier>.json``:
the JAX package's schema, plus the card's name and power limit and the
engine's fingerprint (the kernel build hash that names
``build/yolotpu_torch/<hash>/`` and the int16 plan), so that stale
evidence can be told apart. The JAX package's ``plans/accuracy_*.json``
are its own and are never written here.

    python -m yolotpu_torch.tools.accuracy_protocol --size 416 --seeds 3 \\
        --steps 5000 --batch 8

CPU smoke (reduced):
    python -m yolotpu_torch.tools.accuracy_protocol --device cpu \\
        --size 64 --seeds 2 --steps 3 --tiers fp32,int16 --out-dir /tmp/ev
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

T95 = {2: 12.706, 3: 4.303, 4: 3.182, 5: 2.776, 6: 2.571, 8: 2.365}


def ci95(vals: list[float]) -> float:
    n = len(vals)
    if n < 2:
        return float("nan")
    t = T95.get(n, 2.0)
    return float(t * np.std(vals, ddof=1) / np.sqrt(n))


def quantize_tiers(spec, store, calib: list, tiers) -> None:
    """Quantize a trained fp32 store for the integer tiers as the runtime
    defaults do (int16 and w8a16 at the int16 activation Qs, int8 at its
    own)."""
    from ..quant import (calibrate_activations, calibrate_activations_int8,
                         quantize_weights, quantize_weights_int8,
                         quantize_weights_w8a16)
    act_q = calibrate_activations(spec, store, calib)
    quantize_weights(store, act_q)
    if "int8" in tiers:
        quantize_weights_int8(store,
                              calibrate_activations_int8(spec, store, calib))
    if "w8a16" in tiers:
        quantize_weights_w8a16(store, act_q)


def fingerprint(device) -> dict:
    """What names the engine that scored: the kernel build hash (the
    directory ``build/yolotpu_torch/<hash>/``), the int16 plan
    (``YOLO2_Q16_PLAN``, empty for the default), the card and its power
    limit."""
    import torch

    from ..cli.report import power_limit_w
    from ..ops import _build
    cuda = device.type == "cuda"
    return {"kernel_build": _build.source_digest(),
            "plan": os.environ.get("YOLO2_Q16_PLAN", ""),
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "power_limit_w": power_limit_w() if cuda else None,
            "torch_version": torch.__version__}


def main(argv=None) -> int:
    from ..models.engine_plan import plan_dir
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=416,
                    help="train AND eval resolution")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--compute", default="pallas",
                    help="int16/int8 engine compute mode (both 'pallas' and "
                         "'int32' name the kernels' exact contract)")
    ap.add_argument("--tiers", default="fp32,int16,int8,w8a16")
    ap.add_argument("--thresh", type=float, default=0.05)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=plan_dir(),
                    help="default: engine_plan.plan_dir() (YOLO2_PLAN_DIR)")
    ap.add_argument("--scratch",
                    default=os.path.join(REPO, "build", "accuracy_v2"))
    args = ap.parse_args(argv)

    os.environ.setdefault("YOLO2_NO_DUMP", "1")
    import torch

    from .. import accuracy as acc
    from .. import eval as yeval
    from ..models import zoo
    from ..runtime.engine import Engine
    from ..weights import WeightStore

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("accuracy_protocol --device cuda: no CUDA device "
                           "is available to this process")
    tiers = [t.strip() for t in args.tiers.split(",") if t.strip()]
    spec = zoo.build("yolov2", width=args.size, height=args.size)
    os.makedirs(args.scratch, exist_ok=True)
    pairs = acc.write_eval_set(
        os.path.join(args.scratch, f"eval{args.size}"), args.size)
    calib = acc.calib_images(args.size)
    finger = fingerprint(device)
    log = lambda m: print(f"# {m}", flush=True)  # noqa: E731
    log(f"protocol {acc.PROTOCOL['name']} hash={acc.protocol_hash()} "
        f"size={args.size} seeds={args.seeds} steps={args.steps} "
        f"batch={args.batch} on {finger['device']} "
        f"({finger['power_limit_w']} W)")

    results: dict[str, list[float]] = {t: [] for t in tiers}
    step_ms: list[float] = []
    for seed in range(args.seeds):
        t0 = time.time()
        cache = os.path.join(
            args.scratch, f"store_{acc.TRAIN_RECIPE}_s{seed}_{args.size}_"
            f"{args.steps}_b{args.batch}.npz")
        if os.path.exists(cache):
            z = np.load(cache)
            store = WeightStore(spec=spec)
            for l in spec.conv_layers():
                store.fp32[l.idx] = (z[f"w{l.idx}"], z[f"b{l.idx}"])
            log(f"seed {seed}: loaded cached weights {cache}")
        else:
            ms: list[float] = []
            store, losses = acc.train_flagship_store(
                spec, seed=seed, size=args.size, steps=args.steps,
                batch=args.batch, log=log, device=device, step_ms=ms)
            np.savez(cache,
                     **{f"w{i}": w for i, (w, _) in store.fp32.items()},
                     **{f"b{i}": b for i, (_, b) in store.fp32.items()})
            step_ms += ms[1:]
            log(f"seed {seed}: trained in {time.time() - t0:.0f}s, "
                f"{float(np.median(ms[1:] or ms)):.3f} ms a step at the "
                f"median; losses={losses}")
        quantize_tiers(spec, store, calib, tiers)
        for tier in tiers:
            te = time.time()
            compute = args.compute if tier in ("int16", "int8") else "int32"
            eng = Engine(spec, store, precision=tier, device=device,
                         compute=compute, warmup=False)
            r = yeval.evaluate_engine_batched(eng, pairs, num_classes=80,
                                              thresh=args.thresh)
            results[tier].append(r["mAP_50"])
            log(f"seed {seed} {tier}: mAP_50={r['mAP_50']:.4f} "
                f"({time.time() - te:.0f}s)")

    os.makedirs(args.out_dir, exist_ok=True)
    fp32_vals = results.get("fp32", [])
    print("\n| tier | mAP_50 mean | CI95 | delta vs fp32 | delta CI95 |")
    print("|---|---|---|---|---|")
    for tier in tiers:
        vals = results[tier]
        mean = float(np.mean(vals))
        ci = ci95(vals)
        if fp32_vals and tier != "fp32":
            deltas = [v - f for v, f in zip(vals, fp32_vals)]
            dmean, dci = float(np.mean(deltas)), ci95(deltas)
        else:
            deltas, dmean, dci = [], 0.0, 0.0
        print(f"| {tier} | {mean:.4f} | ±{ci:.4f} | {dmean:+.4f} "
              f"| ±{dci:.4f} |")
        doc = {
            "tier": tier,
            "protocol": acc.PROTOCOL["name"],
            "protocol_hash": acc.protocol_hash(),
            "resolution": args.size,
            "train": {"size": args.size, "steps": args.steps,
                      "batch": args.batch, "seeds": args.seeds,
                      "recipe": acc.TRAIN_RECIPE,
                      "step_ms_median": (round(float(np.median(step_ms)), 3)
                                         if step_ms else None)},
            "eval_scenes": acc.PROTOCOL["eval_scenes"],
            "classes": acc.PROTOCOL["classes"],
            "engine": {"backend": "device",
                       "compute": (args.compute
                                   if tier in ("int16", "int8")
                                   else "int32"),
                       "thresh": args.thresh,
                       "kernel_build": finger["kernel_build"],
                       "plan": finger["plan"] if tier == "int16" else ""},
            "backend_platform": "gpu" if device.type == "cuda" else "cpu",
            "device": finger["device"],
            "power_limit_w": finger["power_limit_w"],
            "torch_version": finger["torch_version"],
            "mAP_50_per_seed": [round(v, 4) for v in vals],
            "mAP_50_mean": round(mean, 4),
            "mAP_50_ci95": round(ci, 4) if np.isfinite(ci) else None,
            "fp32_mAP_50_per_seed": [round(v, 4) for v in fp32_vals],
            "delta_vs_fp32_mean": round(dmean, 4),
            "delta_vs_fp32_ci95": (round(dci, 4)
                                   if deltas and np.isfinite(dci) else None),
            "date": time.strftime("%Y-%m-%d"),
        }
        path = os.path.join(args.out_dir, f"accuracy_{tier}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        log(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
