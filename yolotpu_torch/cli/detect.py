"""``yolov2_detect``-compatible detection CLI on PyTorch (int16-exact tier).

The counterpart of ``yolotpu/cli/detect.py``, keeping its flag contract for
the int16 tier (--model --cfg --input/positional --output --thresh --nms
--weights-dir --synthetic-weights --seed --net-size) and adding --device.
The default output prefix is ``results/<stem>_prediction``; region dumps
follow YOLO2_DUMP_REGION[_RAW] / YOLO2_NO_DUMP as in the JAX CLI.

    python -m yolotpu_torch.cli.detect --synthetic-weights --device cuda img.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="yolov2_detect", description=__doc__)
    ap.add_argument("--cfg", default=None, help="darknet cfg path")
    ap.add_argument("--model", default="yolov2",
                    help="built-in model name (used when --cfg not given)")
    ap.add_argument("--input", default=None, help="input image")
    ap.add_argument("--output", default=None,
                    help="output file prefix without extension")
    ap.add_argument("--thresh", type=float, default=0.25)
    ap.add_argument("--nms", type=float, default=0.45)
    ap.add_argument("--weights-dir", default="weights",
                    help="directory with the .bin artifact set")
    ap.add_argument("--synthetic-weights", action="store_true",
                    help="generate seeded synthetic weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--net-size", type=int, default=None, metavar="N",
                    help="override the network input size (zoo models only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain PyTorch versions")
    ap.add_argument("positional", nargs="?", default=None,
                    help="input image (positional)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from yolotpu.graph import NetworkSpec
    from yolotpu.image import load_image, save_image
    from yolotpu.models import zoo
    from yolotpu.names import names_for
    from yolotpu.runtime import logging as ylog
    from yolotpu.runtime.drawing import draw_detections
    from yolotpu.runtime.engine import load_or_synthesize

    from ..runtime.engine import Engine

    args = build_argparser().parse_args(argv)
    input_path = args.input or args.positional
    if input_path is None:
        print("error: no input image (use --input or positional)", file=sys.stderr)
        return 2

    spec = (NetworkSpec.from_cfg(args.cfg, quiet=False) if args.cfg
            else zoo.build(args.model, width=args.net_size,
                           height=args.net_size))
    spec.describe()

    im = load_image(input_path)
    store = load_or_synthesize(spec, args.weights_dir, "int16",
                               synthetic=args.synthetic_weights, seed=args.seed)
    t0 = time.time()
    eng = Engine(spec, store, precision="int16", device=args.device)
    ylog.info(f"engine ready in {time.time() - t0:.1f}s (torch/{args.device}/int16)")

    dets, res = eng.detect(im, thresh=args.thresh, nms=args.nms)
    print(f"{os.path.basename(input_path)}: predicted in {res.seconds:.6f} seconds.")

    names = (names_for(spec.region.classes)
             or [str(i) for i in range(spec.region.classes)])
    shown = 0
    for d in dets:
        for j in range(d.classes):
            if d.prob[j] > args.thresh:
                print(f"{names[j]}: {100 * d.prob[j]:.0f}%")
                shown += 1

    prefix = args.output
    if prefix is None:
        stem = os.path.splitext(os.path.basename(input_path))[0]
        os.makedirs("results", exist_ok=True)
        prefix = os.path.join("results", f"{stem}_prediction")
    save_image(draw_detections(im, dets, names, args.thresh), prefix + ".png")
    ylog.info(f"saved {prefix}.png ({shown} labels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
