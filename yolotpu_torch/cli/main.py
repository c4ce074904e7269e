"""``yolo2_linux``-equivalent runtime CLI on PyTorch (image / camera / video
modes).

The counterpart of ``yolotpu/cli/main.py``, with its flag contract (after
the board app, ``linux_app/src/main.c:242-277``): -i image, --camera <dev>,
--video <path> (mutually exclusive), -w weights dir, -c config, -l labels,
-t/-n thresholds, -v verbosity, --precision, --backend, --compute,
--synthetic-weights, --max-frames, --infer-every, --batch-size,
--device-nms, --topk, --cam-width/height/fps/format,
--video-width/height/fps, --save-annotated-dir, --output-json,
--stream-mjpeg[-quality|-fps], --profile[-mode|-batch]; and --device (cuda
by default; cpu runs the kernels' plain versions). --backend xla runs the
engine's device backend, golden the numpy oracle. --profile prints the
per-layer table (``runtime.profiler``) on --device before the run:
``--profile-mode prefix`` times the real forward's prefixes, ``layer``
each layer alone, and ``auto`` picks prefix for --compute pallas, as
``yolotpu`` does.

The accelerator init sequence (mmap /dev/mem, udmabuf, chunked uncached
copies — main.c:559-735) becomes: build the engine, its weights on the card
and its forward captured as a CUDA graph once; per-frame traffic is one
host-to-device copy and one head (or top-K table) readback. ``main`` wires
argv -> engine -> ``StreamConfig`` through ``load_model``, ``build_engine``,
``labels_of`` and ``stream_config``, which a caller with its own frame
source can use as well.

    python -m yolotpu_torch.cli.main --synthetic-weights --video clip.mp4
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="yolo2_torch", description=__doc__)
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("--camera", default=None, metavar="DEV")
    ap.add_argument("--video", default=None, metavar="PATH")
    ap.add_argument("-w", "--weights-dir", default="weights")
    ap.add_argument("-c", "--config", default=None, help="darknet cfg")
    ap.add_argument("--model", default="yolov2")
    ap.add_argument("-l", "--labels", default=None)
    ap.add_argument("-t", "--thresh", type=float, default=0.25)
    ap.add_argument("-n", "--nms", type=float, default=0.45)
    ap.add_argument("-v", "--verbose", type=int, default=None)
    ap.add_argument("--precision", default="int16",
                    choices=["fp32", "int16", "int8", "w8a16"])
    ap.add_argument("--backend", default="xla", choices=["xla", "golden"],
                    help="xla: the engine's device backend on --device; "
                         "golden: the numpy oracle")
    ap.add_argument("--compute", default="int32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain PyTorch versions")
    ap.add_argument("--synthetic-weights", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--infer-every", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=1,
                    help="batched double-buffered device feed (>1)")
    ap.add_argument("--device-nms", action="store_true",
                    help="decode + class-wise NMS on device (top-K readback)")
    ap.add_argument("--topk", type=int, default=256,
                    help="device-NMS candidate cap (host path considers all "
                         "h*w*n; a saturation warning flags truncation)")
    ap.add_argument("--cam-width", type=int, default=640)
    ap.add_argument("--cam-height", type=int, default=480)
    ap.add_argument("--cam-fps", type=int, default=30)
    ap.add_argument("--cam-format", default="mjpeg", choices=["mjpeg", "yuyv"])
    ap.add_argument("--video-width", type=int, default=416)
    ap.add_argument("--video-height", type=int, default=416)
    ap.add_argument("--video-fps", type=int, default=0)
    ap.add_argument("--save-annotated-dir", default=None)
    ap.add_argument("--output-json", default=None)
    ap.add_argument("--stream-mjpeg", default=None, metavar="PORT|BIND:PORT")
    ap.add_argument("--stream-mjpeg-quality", type=int, default=80)
    ap.add_argument("--stream-mjpeg-fps", type=int, default=15)
    ap.add_argument("--profile", action="store_true",
                    help="per-layer timing table before the run")
    ap.add_argument("--profile-mode", default="auto",
                    choices=["auto", "prefix", "layer"],
                    help="prefix = the real forward's prefixes, one captured "
                         "graph each; layer = each layer alone; auto picks "
                         "prefix for --compute pallas")
    ap.add_argument("--profile-batch", type=int, default=8)
    return ap


def load_model(args: argparse.Namespace):
    """(spec, store) of the parsed argv: the cfg or zoo model, and its
    weights from --weights-dir or synthesized (--synthetic-weights)."""
    from ..graph import NetworkSpec
    from ..models import zoo
    from ..runtime.engine import load_or_synthesize
    spec = (NetworkSpec.from_cfg(args.config) if args.config
            else zoo.build(args.model))
    return spec, load_or_synthesize(spec, args.weights_dir, args.precision,
                                    synthetic=args.synthetic_weights)


def build_engine(args: argparse.Namespace, spec, store):
    """The Engine of the parsed argv, warmed up at --batch-size."""
    from ..runtime import logging as ylog
    from ..runtime.engine import Engine
    from .detect import engine_backend
    t0 = time.time()
    eng = Engine(spec, store, precision=args.precision, device=args.device,
                 backend=engine_backend(args.backend, args.compute),
                 compute=args.compute, warmup_batch=max(1, args.batch_size),
                 device_nms=args.device_nms, thresh=args.thresh,
                 nms=args.nms, topk=args.topk)
    ylog.info(f"engine ready in {time.time() - t0:.1f}s")
    return eng


def labels_of(args: argparse.Namespace, spec) -> list[str]:
    """-l's labels, else the built-in names of the class count."""
    from ..names import load_names, names_for
    if args.labels:
        return load_names(args.labels)
    return (names_for(spec.region.classes)
            or [str(i) for i in range(spec.region.classes)])


def stream_config(args: argparse.Namespace, labels: list[str]):
    """The StreamConfig of the parsed argv (mode and source are set by the
    caller's frame source)."""
    from ..runtime.stream import StreamConfig
    mjpeg_port = mjpeg_bind = None
    if args.stream_mjpeg:
        mjpeg_bind, _, port = args.stream_mjpeg.rpartition(":")
        mjpeg_port = int(port)
    return StreamConfig(
        thresh=args.thresh, nms=args.nms, infer_every=args.infer_every,
        max_frames=args.max_frames, batch_size=args.batch_size,
        save_annotated_dir=args.save_annotated_dir,
        output_json=args.output_json, mjpeg_port=mjpeg_port,
        mjpeg_bind=mjpeg_bind or "0.0.0.0",
        mjpeg_fps=args.stream_mjpeg_fps,
        mjpeg_quality=args.stream_mjpeg_quality,
        labels=labels,
    )


def main(argv: list[str] | None = None) -> int:
    from ..runtime import logging as ylog
    from ..runtime.stream import StreamRunner

    args = build_argparser().parse_args(argv)
    if args.verbose is not None:
        ylog.set_level(args.verbose)

    modes = [m for m in (args.image, args.camera, args.video) if m]
    if len(modes) > 1:
        print("error: -i/--camera/--video are mutually exclusive", file=sys.stderr)
        return 2

    spec, store = load_model(args)
    eng = build_engine(args, spec, store)
    labels = labels_of(args, spec)

    if args.profile:
        from ..runtime.profiler import profile_layers, profile_prefix
        mode = args.profile_mode
        if mode == "auto":
            mode = "prefix" if args.compute == "pallas" else "layer"
        if mode == "prefix":
            rep = profile_prefix(spec, store, args.precision, args.compute,
                                 batch=args.profile_batch, progress=True,
                                 device=args.device)
        else:
            rep = profile_layers(spec, store, args.precision, args.compute,
                                 batch=args.profile_batch, progress=True,
                                 device=args.device)
        print(rep.render())

    # ---------------- image mode (main.c:769-876) ----------------------
    if args.camera is None and args.video is None:
        from ..image import load_image, save_image
        from ..runtime.drawing import draw_detections
        path = args.image or os.path.join(
            os.path.dirname(__file__), "..", "..", "examples", "scene0.png")
        im = load_image(path)
        dets, res = eng.detect(im, args.thresh, args.nms)
        print(f"inference time: {res.seconds * 1e3:.2f} ms")
        for d in dets:
            j, p = d.best_class()
            if p > args.thresh:
                bx, by, bw, bh = d.bbox
                print(f"{labels[j] if j < len(labels) else j}: {100 * p:.0f}%  "
                      f"bbox=({bx:.3f},{by:.3f},{bw:.3f},{bh:.3f})")
        if args.output_json:
            from ..runtime.jsonl import JsonlWriter
            jw = JsonlWriter(args.output_json)
            jw.write_record("image", path, 0, 0, im.shape[2], im.shape[1],
                            dets, labels, args.thresh)
            jw.close()
        out_dir = args.save_annotated_dir or "results"
        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(path))[0]
        drawn = draw_detections(im, dets, labels, args.thresh)
        save_image(drawn, os.path.join(out_dir, f"{stem}_annotated.png"))
        return 0

    # ---------------- streaming modes ----------------------------------
    cfg = stream_config(args, labels)
    if args.camera is not None:
        from ..runtime.v4l2 import open_camera
        cfg.mode, cfg.source = "camera", args.camera
        src = open_camera(args.camera, args.cam_width, args.cam_height,
                          args.cam_fps, args.cam_format)
    else:
        from ..runtime.video import open_video
        cfg.mode, cfg.source = "video", args.video
        src = open_video(args.video, args.video_width, args.video_height,
                         args.video_fps)
    runner = StreamRunner(eng, cfg)
    try:
        runner.run(src)
    finally:
        src.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
