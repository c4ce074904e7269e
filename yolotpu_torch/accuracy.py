"""Accuracy protocol v2: synthetic detection scenes with statistical power.

The counterpart of ``yolotpu/accuracy.py``: a numpy copy of its protocol
(``PROTOCOL``, ``CLASS_COLORS``, ``protocol_hash``, which gives the JAX
package's hash, ``TRAIN_RECIPE``, the scene sampling and rendering,
``write_eval_set``, ``batch_builder``, ``calib_images``), and
``train_flagship_store`` on the port's training step. Scenes: 8 classes of
flat-colour rectangles on a noisy gray background, relative scale
0.12-0.45, aspect 0.5-2.0, 1-4 objects with bounded occlusion, in relative
geometry so the same distribution renders at any resolution; 2048 train
scenes, 64 eval scenes. Evidence files carry the protocol hash so that
stale evidence can be told apart (``tools/accuracy_protocol.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Protocol definition (versioned, hashed)
# ---------------------------------------------------------------------------

PROTOCOL = {
    "name": "scenes-v2",
    "classes": 8,
    # the JAX package's notes: 64 or 512 train scenes were memorized; 2048
    # scenes with flips make held-out mAP track train mAP
    "train_scenes": 2048,
    "eval_scenes": 64,
    "objects_per_scene": [1, 4],
    "rel_size": [0.12, 0.45],
    "aspect": [0.5, 2.0],
    "max_occlusion_iou": 0.4,
    "background": 128,
    "noise": 8,
    "eval_seed": 99,
    "train_scene_seed": 7,
}

# 8 visually distinct class colors (RGB)
CLASS_COLORS = {
    0: (210, 40, 40),    # red
    1: (40, 60, 210),    # blue
    2: (40, 180, 60),    # green
    3: (230, 200, 40),   # yellow
    4: (160, 40, 200),   # purple
    5: (40, 200, 200),   # cyan
    6: (240, 130, 30),   # orange
    7: (250, 250, 250),  # white
}


def protocol_hash() -> str:
    """Stable hash of the protocol parameters; evidence files carry it so
    their readers (``cli.report``'s accuracy block) can reject stale
    evidence."""
    blob = json.dumps(PROTOCOL, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# Training-recipe tag of the JAX package: "bce1" BCE objectness, "bce2"
# + the warmup/cosine lr schedule, "bce3" + per-sample horizontal flips.
TRAIN_RECIPE = "bce3"


# ---------------------------------------------------------------------------
# Scene generation (relative geometry; renders at any resolution)
# ---------------------------------------------------------------------------

def _box_iou_rel(a, b) -> float:
    ax0, ay0, ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2, \
        a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0, bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2, \
        b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / max(union, 1e-12)


def sample_scene_geometry(rng: np.random.Generator):
    """One scene's object list in RELATIVE coords: [(cls, cx, cy, w, h)].
    Diversity knobs per PROTOCOL; occlusion bounded by max_occlusion_iou."""
    lo_n, hi_n = PROTOCOL["objects_per_scene"]
    n = int(rng.integers(lo_n, hi_n + 1))
    lo_s, hi_s = PROTOCOL["rel_size"]
    lo_a, hi_a = PROTOCOL["aspect"]
    objs: list[tuple] = []
    for _ in range(n):
        for _try in range(20):
            cls = int(rng.integers(0, PROTOCOL["classes"]))
            area_side = float(rng.uniform(lo_s, hi_s))
            aspect = float(np.exp(rng.uniform(np.log(lo_a), np.log(hi_a))))
            w = min(0.94, area_side * np.sqrt(aspect))
            h = min(0.94, area_side / np.sqrt(aspect))
            cx = float(rng.uniform(w / 2 + 0.02, 1.0 - w / 2 - 0.02))
            cy = float(rng.uniform(h / 2 + 0.02, 1.0 - h / 2 - 0.02))
            box = (cx, cy, w, h)
            if all(_box_iou_rel(box, o[1:]) <= PROTOCOL["max_occlusion_iou"]
                   for o in objs):
                objs.append((cls,) + box)
                break
    return objs


def render_scene(objs, size: int, rng: np.random.Generator):
    """Render a geometry list at ``size`` x ``size`` -> (img_u8, boxes, cls).
    Later objects draw over earlier ones (partial occlusion); ground truth
    keeps the FULL box of every object, as real datasets do."""
    img = np.full((size, size, 3), PROTOCOL["background"], np.int16)
    img += rng.integers(-PROTOCOL["noise"], PROTOCOL["noise"],
                        img.shape).astype(np.int16)
    boxes, classes = [], []
    for cls, cx, cy, w, h in objs:
        x0 = max(0, int(round((cx - w / 2) * size)))
        y0 = max(0, int(round((cy - h / 2) * size)))
        x1 = min(size, int(round((cx + w / 2) * size)))
        y1 = min(size, int(round((cy + h / 2) * size)))
        img[y0:y1, x0:x1] = np.asarray(CLASS_COLORS[cls], np.int16)
        boxes.append((cx, cy, w, h))
        classes.append(cls)
    return (np.clip(img, 0, 255).astype(np.uint8),
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32))


def make_scenes(n: int, size: int, seed: int):
    """n rendered scenes: [(img_u8, boxes_rel, classes)]."""
    rng = np.random.default_rng(seed)
    return [render_scene(sample_scene_geometry(rng), size, rng)
            for _ in range(n)]


def write_eval_set(out_dir: str, size: int):
    """PROTOCOL's eval set rendered at ``size``, written as PNG + darknet
    label pairs (the evaluate_engine input format). Deterministic across
    runs/resolutions (fixed eval_seed; geometry sampled before rendering)."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    pairs = []
    scenes = make_scenes(PROTOCOL["eval_scenes"], size, PROTOCOL["eval_seed"])
    for i, (img, boxes, classes) in enumerate(scenes):
        ip = os.path.join(out_dir, f"eval{i:03d}.png")
        lp = os.path.join(out_dir, f"eval{i:03d}.txt")
        Image.fromarray(img).save(ip)
        with open(lp, "w") as f:
            for b, c in zip(boxes, classes):
                f.write(f"{c} {b[0]} {b[1]} {b[2]} {b[3]}\n")
        pairs.append((ip, lp))
    return pairs


# ---------------------------------------------------------------------------
# Flagship training on the protocol (shared by the tests and the tool)
# ---------------------------------------------------------------------------

MAX_BOXES = 8


def batch_builder(scenes, size: int):
    """Closure building train batches from rendered scenes."""
    def batch_from(idxs):
        B = len(idxs)
        imgs = np.zeros((B, size, size, 3), np.float32)
        bx = np.zeros((B, MAX_BOXES, 4), np.float32)
        cl = np.zeros((B, MAX_BOXES), np.int32)
        mk = np.zeros((B, MAX_BOXES), np.float32)
        for k, i in enumerate(idxs):
            img, boxes, classes = scenes[i]
            imgs[k] = img.astype(np.float32) / 255.0
            n = min(len(classes), MAX_BOXES)
            bx[k, :n], cl[k, :n], mk[k, :n] = boxes[:n], classes[:n], 1.0
        return {"images": imgs, "boxes": bx, "classes": cl, "mask": mk}
    return batch_from


def lr_scale_at(it: int, steps: int, warmup: int) -> float:
    """The "bce2" schedule: linear warmup over min(warmup, steps // 10)
    steps (at least 1), then cosine decay to a 5% floor."""
    wu = min(warmup, max(steps // 10, 1))
    if it < wu:
        return (it + 1) / wu
    t = (it - wu) / max(steps - wu, 1)
    return 0.05 + 0.95 * 0.5 * (1.0 + np.cos(np.pi * t))


def flip_mask(rng: np.random.Generator, batch: int) -> np.ndarray:
    """One step's horizontal flips: each sample with probability 1/2."""
    return rng.random(batch) < 0.5


def train_flagship_store(spec, seed: int, size: int, steps: int = 400,
                         batch: int = 4, lr: float = 1e-3,
                         warmup: int = 200, log=None,
                         device: torch.device | str = "cuda",
                         step_ms: list | None = None):
    """Train the full graph on PROTOCOL scenes from He init (the store of
    ``WeightStore.synthetic(spec, seed)``) on ``device`` and return
    (WeightStore with the trained fp32 weights, the losses logged at every
    ``steps // 8`` steps and the last). The training scenes are shared
    across seeds (only the init, the shuffle and the flips vary).

    The recipe is ``yolotpu``'s ("bce3"): ``LossConfig(rescore=False)``,
    SGD with momentum 0.9, ``clip_norm=1.0``, the warmup and cosine
    ``lr_scale`` (``lr_scale_at``); each step takes ``batch`` scenes by the
    same numpy shuffle (``default_rng(seed)``), so the port picks JAX's
    indices; each sample is flipped horizontally with probability 1/2, the
    image mirrored on W and cx -> 1 - cx. The flips are not JAX's: JAX
    draws them from ``jax.random``, whose stream no other library gives;
    here one mask a step comes from ``flip_mask`` on ``default_rng(seed +
    1000)`` on the host, so a CPU run and a card run take identical
    batches.

    The uint8 train set is staged on the device once; each step gathers its
    scenes by the host's indices and divides by 255 there
    (``convops.normalize_u8``). With ``step_ms`` a list, each step's
    device time (CUDA events around the gather, forward, backward and
    update; host clock on the CPU) is appended to it."""
    from .models import yolov2 as m
    from .ops import convops
    from .train import LossConfig, make_train_step, zeros_like_velocity
    from .weights import WeightStore

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_flagship_store(device='cuda'): no CUDA "
                           "device is available to this process")
    scenes = make_scenes(PROTOCOL["train_scenes"], size,
                         PROTOCOL["train_scene_seed"])
    n = len(scenes)
    imgs = np.stack([s[0] for s in scenes])
    bx = np.zeros((n, MAX_BOXES, 4), np.float32)
    cl = np.zeros((n, MAX_BOXES), np.int32)
    mk = np.zeros((n, MAX_BOXES), np.float32)
    for i, (_, boxes, classes) in enumerate(scenes):
        k = min(len(classes), MAX_BOXES)
        bx[i, :k], cl[i, :k], mk[i, :k] = boxes[:k], classes[:k], 1.0
    imgs_d, bx_d, cl_d, mk_d = (torch.from_numpy(a).to(device)
                                for a in (imgs, bx, cl, mk))
    rng = np.random.default_rng(seed)
    flips = np.random.default_rng(seed + 1000)

    params = m.params_fp32(spec, WeightStore.synthetic(spec, seed=seed),
                           device)
    vel = zeros_like_velocity(params)
    step = make_train_step(spec, lr=lr, momentum=0.9,
                           cfg=LossConfig(rescore=False), clip_norm=1.0)
    order = np.arange(n)
    losses = []
    every = max(1, steps // 8)
    cuda = device.type == "cuda"
    for it in range(steps):
        rng.shuffle(order)
        idxs = torch.from_numpy(order[:batch].copy()).to(device)
        flip = torch.from_numpy(flip_mask(flips, batch)).to(device)
        if step_ms is not None:
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            else:
                t0 = time.perf_counter()
        ims = convops.normalize_u8(imgs_d[idxs])
        boxes = bx_d[idxs]
        ims = torch.where(flip[:, None, None, None], ims.flip(2), ims)
        boxes = torch.cat([torch.where(flip[:, None, None],
                                       1.0 - boxes[..., 0:1], boxes[..., 0:1]),
                           boxes[..., 1:]], dim=-1)
        params, vel, loss = step(params, vel, {
            "images": ims, "boxes": boxes, "classes": cl_d[idxs],
            "mask": mk_d[idxs]}, np.float32(lr_scale_at(it, steps, warmup)))
        if step_ms is not None:
            if cuda:
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
            else:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        if it % every == 0 or it == steps - 1:
            losses.append(float(loss))
            if log:
                log(f"seed={seed} it={it} loss={losses[-1]:.3f}")
    store = WeightStore(spec=spec)
    for l in spec.conv_layers():
        p = params[f"conv{l.idx}"]
        store.fp32[l.idx] = (
            np.ascontiguousarray(p["w"].cpu().numpy().transpose(3, 2, 0, 1),
                                 dtype=np.float32),
            p["b"].cpu().numpy().astype(np.float32))
    return store, losses


def calib_images(size: int):
    """The protocol's calibration set: mid-gray plus one rendered scene
    (matches what the runtime's synthetic calibration sees)."""
    scene = make_scenes(1, size, PROTOCOL["eval_seed"])[0][0]
    return [np.full((3, size, size), 0.5, np.float32),
            scene.astype(np.float32).transpose(2, 0, 1) / 255.0]
