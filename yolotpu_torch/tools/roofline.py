"""Per-layer roofline evidence run on the card.

The counterpart of ``tools/roofline.py``: profiles a tier's forward by
prefixes (``runtime.profiler.profile_prefix``: each prefix one captured
CUDA graph, timed in turns with the whole forward) at ``--batch``, holds
every layer against its bound on the H100 (``roofline_table`` against
``H100_CHIP``: MACs x 8-bit products over the tensor cores' peak, or fp32
operations over the fp32 peak, and minimal bytes over the memory rate),
prints the table and writes ``roofline_<precision>_<card>.json`` with the
card's name and power limit into ``--out-dir`` (``engine_plan.plan_dir()``,
``yolotpu_torch/plans/`` unless ``YOLO2_PLAN_DIR`` names another). ``--device cpu`` runs
the same walk eagerly on the host clock (no device number).

    python -m yolotpu_torch.tools.roofline [--batch 8] [--precision int16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    from ..models.engine_plan import device_kind_slug, plan_dir
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--precision", default="int16")
    ap.add_argument("--compute", default="pallas")
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=plan_dir(),
                    help="default: engine_plan.plan_dir() (YOLO2_PLAN_DIR)")
    args = ap.parse_args(argv)

    import torch

    from ..cli.report import power_limit_w
    from ..models import zoo
    from ..runtime.engine import load_or_synthesize
    from ..runtime.profiler import (profile_prefix, render_roofline,
                                    roofline_table)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("roofline --device cuda: no CUDA device is "
                           "available to this process")
    spec = zoo.build("yolov2", width=args.width, height=args.height)
    rng = np.random.default_rng(0)
    calib = [rng.random((3, spec.net.height, spec.net.width),
                        dtype=np.float32)]
    store = load_or_synthesize(spec, None, args.precision, synthetic=True,
                               calib_images=calib)

    t0 = time.time()
    rep = profile_prefix(spec, store, precision=args.precision,
                         compute=args.compute, batch=args.batch,
                         chain=args.chain, progress=True, device=device)
    doc = roofline_table(rep, spec, args.batch, precision=args.precision)
    doc["compute"] = args.compute
    doc["device_kind"] = torch.cuda.get_device_name(device) if cuda else "cpu"
    doc["power_limit_w"] = power_limit_w() if cuda else None
    doc["wall_s"] = round(time.time() - t0, 1)
    doc["date"] = time.strftime("%Y-%m-%d")
    print(render_roofline(doc), flush=True)

    slug = device_kind_slug(doc["device_kind"])
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir,
                        f"roofline_{args.precision}_{slug}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
