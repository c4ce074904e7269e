"""``yolov2_weight_gen``-equivalent CLI: weight (de)reorganization.

Flag contract follows the reference tool
(``src/models/yolov2/yolov2_weight_gen.cpp:137-276``): --cfg --weights
--out --precision fp32|int16, with the in-place-overwrite guard (``:156-167``).
Adds --unreorg to invert the transform (reference artifacts -> darknet
order) and --tm/--tn for non-default tile geometry (the reference bakes
these into params.hpp via scripts/hw_params_gen.py).

``--from-darknet BLOB --out-dir DIR`` covers the nn-weight-extractor role the
reference outsources (``weights/README.md:33-67``): parse the darknet
``.weights`` header, fold batch-norm, and emit the full artifact contract
(weights.bin/bias.bin, plus the int16 set + Q tables when --calib images are
given for activation calibration). Its body, ``from_darknet``, also takes
calibration images that are already arrays, so a caller needs no image
decoder.

Mirrors ``yolotpu/cli/weight_gen.py``; host code in numpy, as there. The
files it writes are byte-equal to the JAX package's for the same argv.

    python -m yolotpu_torch.cli.weight_gen --from-darknet yolov2.weights \\
        --out-dir weights --calib dog.jpg --reorg-out
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..graph import NetworkSpec
from ..models import zoo
from ..weights import DEFAULT_TM, DEFAULT_TN, weight_reorg, weight_unreorg


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="yolov2_weight_gen", description=__doc__)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--model", default="yolov2")
    ap.add_argument("--weights", default=None, help="input weights .bin")
    ap.add_argument("--out", default=None, help="output .bin")
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "f32", "float", "int16", "i16", "fixed"])
    ap.add_argument("--unreorg", action="store_true",
                    help="invert: tile-stream order -> darknet order")
    ap.add_argument("--tm", type=int, default=DEFAULT_TM)
    ap.add_argument("--tn", type=int, default=DEFAULT_TN)
    ap.add_argument("--from-darknet", default=None, metavar="BLOB",
                    help="ingest a darknet .weights blob (BN folding) and "
                         "emit the artifact contract into --out-dir")
    ap.add_argument("--out-dir", default="weights")
    ap.add_argument("--calib", nargs="*", default=None, metavar="IMAGE",
                    help="calibration images: also emit int16 artifacts + Q "
                         "tables (requires --from-darknet)")
    ap.add_argument("--bn-eps", type=float, default=1e-6)
    ap.add_argument("--bn-eps-inside", action="store_true",
                    help="AlexeyAB-style sqrt(var+eps) folding instead of "
                         "pjreddie sqrt(var)+eps")
    ap.add_argument("--reorg-out", action="store_true",
                    help="with --from-darknet: also write the FPGA "
                         "tile-reorganized weight files")
    args = ap.parse_args(argv)

    if args.from_darknet:
        calib = None
        if args.calib is not None:
            if not args.calib:
                print("error: --calib needs at least one image", file=sys.stderr)
                return 1
            from ..image import load_image
            calib = [load_image(p) for p in args.calib]
        from_darknet(_spec(args), args.from_darknet, args.out_dir, calib,
                     reorg_out=args.reorg_out, tm=args.tm, tn=args.tn,
                     bn_eps=args.bn_eps, bn_eps_inside=args.bn_eps_inside)
        return 0

    is_int16 = args.precision in ("int16", "i16", "fixed")
    dtype = np.int16 if is_int16 else np.float32
    win = args.weights or (
        "weights/weight_int16.bin" if is_int16 else "weights/weights.bin")
    wout = args.out or (
        "weights/weights_reorg_int16.bin" if is_int16
        else "weights/weights_reorg.bin")
    if os.path.abspath(win) == os.path.abspath(wout):
        print("error: refusing to overwrite input file in place", file=sys.stderr)
        return 1

    spec = _spec(args)
    flat = np.fromfile(win, dtype)
    out_parts = []
    pos = 0
    for l in spec.conv_layers():
        nw = l.nweights
        if pos + nw > flat.size:
            print(f"error: weights file truncated at conv layer {l.idx}",
                  file=sys.stderr)
            return 1
        wl = flat[pos:pos + nw]
        if args.unreorg:
            block = weight_unreorg(wl, l.n, l.c, l.size, args.tm, args.tn).reshape(-1)
        else:
            block = weight_reorg(wl.reshape(l.n, l.c, l.size, l.size),
                                 args.tm, args.tn)
        out_parts.append(block)
        pos += nw
        if is_int16 and (nw & 1):       # per-layer odd-count padding
            out_parts.append(np.zeros(1, dtype))
            pos += 1
    os.makedirs(os.path.dirname(os.path.abspath(wout)), exist_ok=True)
    np.concatenate(out_parts).astype(dtype).tofile(wout)
    print(f"Reorganized weights written to {wout}")
    return 0


def _spec(args: argparse.Namespace) -> NetworkSpec:
    return NetworkSpec.from_cfg(args.cfg) if args.cfg else zoo.build(args.model)


def from_darknet(spec: NetworkSpec, blob: str, out_dir: str,
                 calib: list[np.ndarray] | None = None, *,
                 reorg_out: bool = False, tm: int = DEFAULT_TM,
                 tn: int = DEFAULT_TN, bn_eps: float = 1e-6,
                 bn_eps_inside: bool = False):
    """``--from-darknet``: the blob's weights with BN folded, written as
    weights.bin/bias.bin into ``out_dir`` (and weights_reorg.bin with
    ``reorg_out``); with ``calib``, CHW float images in [0, 1] of any size
    (letterboxed here to the network's), also calibrated, quantized and
    written as the int16 set and its Q tables. Returns the store."""
    from ..darknet import load_darknet_weights
    from ..image import letterbox_image
    from ..quant import calibrate_activations, quantize_weights

    store = load_darknet_weights(spec, blob, eps=bn_eps,
                                 eps_inside=bn_eps_inside)
    os.makedirs(out_dir, exist_ok=True)
    store.save_fp32(out_dir)
    if reorg_out:
        store.save_fp32(out_dir, reorg=True, tm=tm, tn=tn)
    print(f"fp32 artifacts (BN folded) written to {out_dir}")
    if calib is not None:
        boxed = [letterbox_image(im, spec.net.width, spec.net.height)
                 for im in calib]
        act_q = calibrate_activations(spec, store, boxed)
        quantize_weights(store, act_q)
        store.save_int16(out_dir)
        if reorg_out:
            store.save_int16(out_dir, reorg=True, tm=tm, tn=tn)
        print(f"int16 artifacts + Q tables written to {out_dir}")
    return store


if __name__ == "__main__":
    sys.exit(main())
