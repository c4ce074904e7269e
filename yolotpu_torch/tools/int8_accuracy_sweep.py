"""int8 tier accuracy diagnosis at flagship depth.

The counterpart of ``tools/int8_accuracy_sweep.py``. Trains the full
yolov2 graph at 128x128 on 24 synthetic two-class scenes once (400 steps
at batch 4, lr 2e-4, ``LossConfig(rescore=False)``, clip 1.0, He init from
seed 3) on ``--device`` (the card by default; with no card it raises),
then scores the fp32, int16 and w8a16 tiers and the w8a8 tier across
quantization recipes (activation margin 2.0, 1.4, 1.0 x per-layer or
per-channel weights) on 16 eval scenes through the port's engines. Prints
one JSON line per configuration. The trained weights are cached in
``INT8_SWEEP_STORE`` (default ``build/int8_sweep_store.npz`` in the
checkout).

    python -m yolotpu_torch.tools.int8_accuracy_sweep [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
S = 128
CLASS_COLORS = {0: (210, 40, 40), 1: (40, 60, 210)}
MB = 8
TRAIN_STEPS = 400


def make_scene(r, w=S, h=S, n_obj=2):
    """The JAX sweep's scene: gray with uint8 noise (wrapping, as its own
    does) and n_obj flat rectangles of the two classes."""
    img = np.full((h, w, 3), 128, np.uint8)
    img += r.integers(-8, 8, img.shape).astype(np.uint8)
    boxes, classes = [], []
    for _ in range(n_obj):
        cls = int(r.integers(0, 2))
        bw, bh = int(r.integers(40, 64)), int(r.integers(40, 64))
        x0 = int(r.integers(2, w - bw - 2))
        y0 = int(r.integers(2, h - bh - 2))
        img[y0:y0 + bh, x0:x0 + bw] = CLASS_COLORS[cls]
        boxes.append(((x0 + bw / 2) / w, (y0 + bh / 2) / h, bw / w, bh / h))
        classes.append(cls)
    return img, np.asarray(boxes, np.float32), np.asarray(classes, np.int32)


def train_store(spec, scenes, rng, device):
    """The sweep's training run: (WeightStore of trained fp32 weights)."""
    import torch

    from ..models import yolov2 as m
    from ..train import LossConfig, make_train_step, zeros_like_velocity
    from ..weights import WeightStore

    def batch_from(idxs):
        B = len(idxs)
        imgs = np.zeros((B, S, S, 3), np.float32)
        bx = np.zeros((B, MB, 4), np.float32)
        cl = np.zeros((B, MB), np.int32)
        mk = np.zeros((B, MB), np.float32)
        for k, i in enumerate(idxs):
            img, boxes, classes = scenes[i]
            imgs[k] = img.astype(np.float32) / 255.0
            n = len(classes)
            bx[k, :n], cl[k, :n], mk[k, :n] = boxes, classes, 1.0
        return {k: torch.from_numpy(v).to(device) for k, v in
                {"images": imgs, "boxes": bx, "classes": cl,
                 "mask": mk}.items()}

    params = m.params_fp32(spec, WeightStore.synthetic(spec, seed=3), device)
    step = make_train_step(spec, lr=2e-4, momentum=0.9,
                           cfg=LossConfig(rescore=False), clip_norm=1.0)
    vel = zeros_like_velocity(params)
    order = np.arange(len(scenes))
    for it in range(TRAIN_STEPS):
        rng.shuffle(order)
        params, vel, loss = step(params, vel, batch_from(order[:4]))
        if it % 100 == 0:
            print(f"# train it={it} loss={float(loss):.3f}", flush=True)
    store = WeightStore(spec=spec)
    for l in spec.conv_layers():
        p = params[f"conv{l.idx}"]
        store.fp32[l.idx] = (
            np.ascontiguousarray(p["w"].cpu().numpy().transpose(3, 2, 0, 1),
                                 dtype=np.float32),
            p["b"].cpu().numpy().astype(np.float32))
    return store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    os.environ.setdefault("YOLO2_NO_DUMP", "1")
    import torch
    from PIL import Image

    from .. import eval as yeval
    from ..image import load_image
    from ..models import zoo
    from ..quant import (calibrate_activations, quantize_weights,
                         quantize_weights_int8, quantize_weights_w8a16)
    from ..runtime.engine import Engine
    from ..weights import WeightStore

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("int8_accuracy_sweep --device cuda: no CUDA "
                           "device is available to this process")
    spec = zoo.build("yolov2", width=S, height=S)
    rng = np.random.default_rng(0)
    scenes = [make_scene(rng) for _ in range(24)]
    cache = os.environ.get("INT8_SWEEP_STORE", os.path.join(
        REPO, "build", "int8_sweep_store.npz"))
    if os.path.exists(cache):
        z = np.load(cache)
        store = WeightStore(spec=spec)
        for l in spec.conv_layers():
            store.fp32[l.idx] = (z[f"w{l.idx}"], z[f"b{l.idx}"])
        print(f"# loaded trained weights from {cache}", flush=True)
    else:
        store = train_store(spec, scenes, rng, device)
        os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
        np.savez(cache, **{f"w{i}": w for i, (w, _) in store.fp32.items()},
                 **{f"b{i}": b for i, (_, b) in store.fp32.items()})
        print(f"# saved trained weights to {cache}", flush=True)

    with tempfile.TemporaryDirectory(prefix="int8sweep") as out_dir:
        eval_rng = np.random.default_rng(99)
        pairs = []
        for i in range(int(os.environ.get("INT8_SWEEP_EVAL_N", "16"))):
            img, boxes, classes = make_scene(eval_rng)
            ip = os.path.join(out_dir, f"eval{i}.png")
            lp = os.path.join(out_dir, f"eval{i}.txt")
            Image.fromarray(img).save(ip)
            with open(lp, "w") as f:
                for b, c in zip(boxes, classes):
                    f.write(f"{c} {b[0]} {b[1]} {b[2]} {b[3]}\n")
            pairs.append((ip, lp))
        calib = [np.full((3, S, S), 0.5, np.float32), load_image(pairs[0][0])]

        def score(cfg: str, precision: str) -> None:
            eng = Engine(spec, store, precision=precision, device=device,
                         warmup=False)
            r = yeval.evaluate_engine_batched(eng, pairs, num_classes=80,
                                              thresh=0.05)
            print(json.dumps({"cfg": cfg, "mAP_50": r["mAP_50"]}), flush=True)

        score("fp32", "fp32")
        act_q16 = calibrate_activations(spec, store, calib)   # margin 2.0
        quantize_weights(store, act_q16)
        score("int16", "int16")
        quantize_weights_w8a16(store, act_q16)
        score("w8a16", "w8a16")
        for margin in (2.0, 1.4, 1.0):
            act_q16m = calibrate_activations(spec, store, calib, margin=margin)
            act_q8 = [q - 8 for q in act_q16m]
            for pc in (False, True):
                quantize_weights_int8(store, act_q8, per_channel=pc)
                score(f"int8 margin={margin} pc={pc}", "int8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
