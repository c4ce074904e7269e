"""``yolov2_detect``-compatible detection CLI on PyTorch.

The counterpart of ``yolotpu/cli/detect.py``, keeping its flag contract
(--model --cfg --names --input/positional --output --thresh --nms --hier
--topk --dump-layers --backend --precision --compute --weights-dir
--synthetic-weights --seed --net-size -v/--verbose) and adding --device.
--precision takes fp32, int16, int8 and w8a16 and defaults to fp32, as the
JAX CLI does. --hier is accepted and unused and --topk is passed to the
engine, as in the JAX CLI. --backend xla (the default) and its alias hls
run the engine's device backend on --device; cpu and golden the numpy
oracle on the host. --compute exact implies the golden backend; f32 and
f32_highest, the TPU's approximate modes, are refused. --dump-layers DIR
(or env YOLO2_DUMP_LAYERS) writes every layer's output as DIR/layerNN.bin.
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
    ap.add_argument("--dump-layers", default=None, metavar="DIR",
                    help="write every layer's output as DIR/layerNN.bin "
                         "(raw CHW; env YOLO2_DUMP_LAYERS also works)")
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "hls", "cpu", "golden"],
                    help="xla and hls: the engine's device backend on "
                         "--device; cpu and golden: the numpy oracle")
    ap.add_argument("--compute", default="int32",
                    choices=["int32", "pallas", "f32", "f32_highest",
                             "exact"],
                    help="int32 and pallas: the exact int32 contract; exact: "
                         "the golden backend's HLS-core accumulation; f32 "
                         "and f32_highest (TPU modes) are refused")
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


def engine_backend(backend: str, compute: str) -> str:
    """The engine backend of a CLI --backend (xla/hls -> device, cpu ->
    golden); --compute exact implies golden, with a note, as in the JAX
    CLI."""
    backend = {"xla": "device", "hls": "device", "cpu": "golden"}.get(
        backend, backend)
    if compute == "exact" and backend != "golden":
        print("note: compute=exact implies the golden backend", file=sys.stderr)
        backend = "golden"
    return backend


def main(argv: list[str] | None = None) -> int:
    from ..graph import NetworkSpec
    from ..image import letterbox_image, load_image, save_image
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

    backend = engine_backend(args.backend, args.compute)
    im = load_image(input_path)
    store = load_or_synthesize(spec, args.weights_dir, args.precision,
                               synthetic=args.synthetic_weights, seed=args.seed)
    t0 = time.time()
    eng = Engine(spec, store, precision=args.precision, device=args.device,
                 backend=backend, compute=args.compute, topk=args.topk)
    ylog.info(f"engine ready in {time.time() - t0:.1f}s "
              f"(torch/{backend}/{args.device}/{args.precision})")

    dets, res = eng.detect(im, thresh=args.thresh, nms=args.nms)
    print(f"{os.path.basename(input_path)}: predicted in {res.seconds:.6f} seconds.")

    dump_dir = args.dump_layers or os.environ.get("YOLO2_DUMP_LAYERS")
    if dump_dir:
        eng.dump_layers(letterbox_image(im, spec.net.width, spec.net.height),
                        dump_dir)

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
