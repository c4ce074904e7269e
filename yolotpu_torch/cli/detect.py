"""``yolov2_detect``-compatible detection CLI on PyTorch.

The counterpart of ``yolotpu/cli/detect.py``, keeping its flag contract
(--model --cfg --names --input/positional --output --thresh --nms --hier
--topk --weights-dir --synthetic-weights --seed --net-size --precision
-v/--verbose) and adding --device. --precision takes fp32, int16, int8 and
w8a16 and defaults to fp32, as the JAX CLI does. --hier is accepted and
unused and --topk is passed to the engine, as in the JAX CLI; its
--dump-layers, --backend and --compute are not taken.
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
    ap.add_argument("--names", default=None, help="class names file")
    ap.add_argument("--input", default=None, help="input image")
    ap.add_argument("--output", default=None,
                    help="output file prefix without extension")
    ap.add_argument("--thresh", type=float, default=0.25)
    ap.add_argument("--nms", type=float, default=0.45)
    ap.add_argument("--hier", type=float, default=0.5)
    ap.add_argument("--topk", type=int, default=256,
                    help="the device NMS's candidate cap, passed to the engine")
    ap.add_argument("--weights-dir", default="weights",
                    help="directory with the .bin artifact set")
    ap.add_argument("--synthetic-weights", action="store_true",
                    help="generate seeded synthetic weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--net-size", type=int, default=None, metavar="N",
                    help="override the network input size (zoo models only)")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "int16", "int8", "w8a16"],
                    help="fp32, int16 exact, int8 (w8a8, head16) or w8a16; "
                         "synthetic weights are calibrated for the tier")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain PyTorch versions")
    ap.add_argument("-v", "--verbose", type=int, default=None)
    ap.add_argument("positional", nargs="?", default=None,
                    help="input image (positional)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from ..graph import NetworkSpec
    from ..image import load_image, save_image
    from ..models import zoo
    from ..names import load_names, names_for
    from ..runtime import logging as ylog
    from ..runtime.drawing import draw_detections
    from ..runtime.engine import Engine, load_or_synthesize

    args = build_argparser().parse_args(argv)
    if args.verbose is not None:
        ylog.set_level(args.verbose)
    input_path = args.input or args.positional
    if input_path is None:
        print("error: no input image (use --input or positional)", file=sys.stderr)
        return 2

    spec = (NetworkSpec.from_cfg(args.cfg, quiet=False) if args.cfg
            else zoo.build(args.model, width=args.net_size,
                           height=args.net_size))
    spec.describe()

    im = load_image(input_path)
    store = load_or_synthesize(spec, args.weights_dir, args.precision,
                               synthetic=args.synthetic_weights, seed=args.seed)
    t0 = time.time()
    eng = Engine(spec, store, precision=args.precision, device=args.device,
                 topk=args.topk)
    ylog.info(f"engine ready in {time.time() - t0:.1f}s "
              f"(torch/{args.device}/{args.precision})")

    dets, res = eng.detect(im, thresh=args.thresh, nms=args.nms)
    print(f"{os.path.basename(input_path)}: predicted in {res.seconds:.6f} seconds.")

    names = (load_names(args.names) if args.names
             else names_for(spec.region.classes)
             or [str(i) for i in range(spec.region.classes)])
    shown = 0
    for d in dets:
        for j in range(d.classes):
            if d.prob[j] > args.thresh:
                print(f"{names[j] if j < len(names) else j}: "
                      f"{100 * d.prob[j]:.0f}%")
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
