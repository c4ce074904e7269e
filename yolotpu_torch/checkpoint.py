"""Checkpoint/resume for training state.

The counterpart of ``yolotpu/checkpoint.py``, in its format: one atomic
``ckpt_<step:08d>.npz`` per save holding ``step``, ``params/conv{i}/w``
(HWIO), ``params/conv{i}/b`` and ``velocity/...``, pruned to the newest
``keep``; ``latest_checkpoint`` and ``load_checkpoint``; and the export to
the reference's ``weights.bin``/``bias.bin`` contract through the port's
``WeightStore.save_fp32``. A checkpoint written by either package loads in
the other. Trees may hold torch tensors (on any device) or numpy arrays;
what is loaded comes back as numpy arrays.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in sorted(tree.items()):
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = _numpy(v)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _checkpoints(ckpt_dir: str) -> list[str]:
    return sorted(p for p in os.listdir(ckpt_dir)
                  if p.startswith("ckpt_") and p.endswith(".npz"))


def save_checkpoint(ckpt_dir: str, step: int, params: dict,
                    velocity: dict | None = None, keep: int = 3) -> str:
    """Atomic write of step state; prunes old checkpoints beyond ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {"step": np.asarray(step)}
    flat.update(_flatten(params, "params/"))
    if velocity is not None:
        flat.update(_flatten(velocity, "velocity/"))
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:   # a file object: no .npz appended
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in _checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def load_checkpoint(path: str) -> tuple[int, dict, dict | None]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("step"))
    tree = _unflatten(flat)
    return step, tree.get("params", {}), tree.get("velocity")


def export_weight_artifacts(params: dict, spec, out_dir: str) -> None:
    """HWIO fp32 params -> the reference's weights.bin/bias.bin contract."""
    from .weights import WeightStore
    store = WeightStore(spec=spec)
    for l in spec.conv_layers():
        p = params[f"conv{l.idx}"]
        w = _numpy(p["w"]).transpose(3, 2, 0, 1)   # HWIO -> (n, c, k, k)
        store.fp32[l.idx] = (np.ascontiguousarray(w, np.float32),
                             _numpy(p["b"]).astype(np.float32))
    store.save_fp32(out_dir)
