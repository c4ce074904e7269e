"""A run's inputs, made from its seed: the fp32 weights, the calibration
image and the pool of frames, each in a few large calls of one
``torch.Generator`` on the run's device, then handed to the host once, as
the system under test takes them (numpy arrays). The same seed gives the
same inputs on the same device. Both the system and the reference get these
arrays and nothing else."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .netcfg import Layer, convs, region

HEAD_ROLES = ("xy", "wh", "obj", "cls")


@dataclass
class Inputs:
    weights: dict[int, tuple[np.ndarray, np.ndarray]]  # idx: (w nckk, b)
    calib: np.ndarray      # (3, H, W) float32 in [0, 1)
    pool: np.ndarray       # (P, fh, fw, 3) uint8


def head_roles(reg: Layer) -> np.ndarray:
    """Each output channel of the region's conv -> its role index in
    HEAD_ROLES (x, y; w, h; objectness; a class)."""
    per = reg.coords + 1 + reg.classes
    j = np.arange(reg.num * per) % per
    return np.select([j < 2, j < reg.coords, j == reg.coords], [0, 1, 2], 3)


def make_inputs(layers: list[Layer], wcfg: dict, engine: dict,
                pool_shape: tuple, raw: bool, seed: int,
                device: torch.device) -> Inputs:
    """Weights He-normal (std sqrt(2 / fan_in)), biases normal with
    ``wcfg["bias_std"]``; calibration image uniform in [0, 1); frames
    uniform uint8 of ``pool_shape`` (``raw``: frames the system letterboxes).
    The region's conv is then set so that on the calibration image each of
    its output channels has the mean (``head_mean``) and spread
    (``head_std``) of its role, whatever the seed's weights do to the
    features' scale (``fit_head``), and so that the pool's first
    ``fit_frames`` frames hold ``detections_per_frame`` detections a frame
    under the ``engine``'s settings (``fit_count``): every seed serves a
    detector's few confident boxes, and the same load."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cs = convs(layers)
    sizes = [l.out_c * l.c * l.size ** 2 for l in cs]
    flat_w = torch.randn(sum(sizes), generator=gen, device=device)
    flat_b = torch.randn(sum(l.out_c for l in cs), generator=gen,
                         device=device) * wcfg["bias_std"]
    shapes, wpos, bpos = {}, 0, 0
    for l, n in zip(cs, sizes):
        flat_w[wpos:wpos + n].mul_((2.0 / (l.c * l.size ** 2)) ** 0.5)
        shapes[l.idx] = (wpos, n, bpos, (l.out_c, l.c, l.size, l.size))
        wpos, bpos = wpos + n, bpos + l.out_c
    calib = torch.rand((3, layers[0].h, layers[0].w), generator=gen,
                       device=device)
    pool = torch.randint(0, 256, pool_shape, generator=gen, device=device,
                         dtype=torch.uint8)
    hw, hb = flat_w.cpu().numpy(), flat_b.cpu().numpy()
    weights = {i: (hw[w0:w0 + n].reshape(shape), hb[b0:b0 + shape[0]])
               for i, (w0, n, b0, shape) in shapes.items()}
    calib = calib.cpu().numpy()
    fit_head(layers, weights, calib, wcfg, device)
    fit_count(layers, weights, pool[:wcfg["fit_frames"]], raw, wcfg, engine)
    return Inputs(weights, calib, pool.cpu().numpy())


def _grid(v: np.ndarray, step: float) -> np.ndarray:
    return np.round(v / step) * step


def fit_head(layers: list[Layer], weights: dict, calib: np.ndarray,
             wcfg: dict, device: torch.device) -> None:
    """Rescale and shift the region conv's rows in place: on the calibration
    image (a float64 forward up to the head's input) each output channel's
    response gets its role's ``head_std`` and ``head_mean``. The factors are
    rounded to a grid (1/64 of an octave, 1/1024), so that the last bits of
    the forward cannot move them."""
    from .references.darknet_int import float_forward
    head = region(layers).idx - 1
    x = torch.from_numpy(calib).to(device).permute(1, 2, 0)[None]
    feats = float_forward(layers[:head], weights, x, every=True)[head - 1]
    f = feats.reshape(-1, feats.shape[-1]).cpu().numpy()
    w, b = weights[head]
    z = f @ w.reshape(w.shape[0], -1).astype(np.float64).T
    roles = head_roles(region(layers))
    std = np.array([wcfg["head_std"][HEAD_ROLES[r]] for r in roles])
    mean = np.array([wcfg["head_mean"].get(HEAD_ROLES[r], 0.0)
                     for r in roles])
    scale = 2.0 ** _grid(np.log2(std / np.maximum(z.std(axis=0), 1e-12)),
                         1 / 64)
    w *= scale.astype(np.float32)[:, None, None, None]
    b[:] = _grid(mean - z.mean(axis=0) * scale, 1 / 1024)


def fit_count(layers: list[Layer], weights: dict, frames: torch.Tensor,
              raw: bool, wcfg: dict, engine: dict) -> None:
    """Shift the biases of the region conv's objectness rows, in place, by
    one amount on a 1/1024 grid, the least at which the float64 detector
    (the reference's decode, top-K and NMS under the ``engine``'s settings)
    finds ``wcfg["detections_per_frame"]`` valid detections a frame or more
    on average over ``frames`` (uint8, raw ones letterboxed)."""
    from .references.darknet_int import (decode, detections, float_forward,
                                         letterbox, to_unit)
    reg = region(layers)
    head = reg.idx - 1
    net_h, net_w = layers[0].h, layers[0].w
    x = letterbox(frames, net_w, net_h) if raw else to_unit(frames)
    feats = float_forward(layers[:head], weights, x, every=True)[head - 1]
    w, b = weights[head]
    z = feats @ torch.from_numpy(w.reshape(w.shape[0], -1)).to(
        feats.device, torch.float64).T
    is_obj = head_roles(reg) == HEAD_ROLES.index("obj")
    target = wcfg["detections_per_frame"]

    def count(shift: float) -> float:
        bias = b.astype(np.float64) + shift * is_obj
        boxes, obj, probs = (t.cpu().numpy() for t in decode(
            z + torch.from_numpy(bias).to(z.device), reg))
        return float(np.mean([
            len(detections(boxes[f], obj[f], probs[f], engine["thresh"],
                           engine["nms"], engine["topk"])[1])
            for f in range(len(boxes))]))

    lo, hi = -8.0, 8.0      # count(lo) < target <= count(hi), on the grid
    while hi - lo > 1 / 1024:
        mid = _grid((lo + hi) / 2, 1 / 1024)
        if count(mid) < target:
            lo = mid
        else:
            hi = mid
    b[is_obj] += np.float32(hi)


def request_order(seed: int, choices: int):
    """The pool entries the requests take, one after another: an endless
    seeded draw (numpy's generator on the host), in blocks."""
    rng = np.random.default_rng([seed, 1])
    while True:
        yield from rng.integers(0, choices, 4096).tolist()
