"""YOLOv2 training in PyTorch: region loss + SGD step.

The counterpart of ``yolotpu/train.py``, with its semantics (darknet's
region-layer training in fixed-shape, vectorized form):

- predictions decode as in ``get_region_box``; every anchor whose best IoU
  against any truth is at most ``thresh`` is pulled toward objectness 0
  (``noobject_scale``), except the slot a truth is assigned to;
- each truth is assigned the anchor of its cell with the best shape IoU
  (the first on ties, as ``argmax``); that slot gets the coordinate terms
  in (tx, ty, tw, th) space, objectness toward the IoU (``rescore``,
  with no gradient through the target) or 1, and the class cross-entropy;
  two truths on one slot add their terms and gradients;
- objectness terms are BCE on the logit (darknet applies its delta to the
  pre-activation), the x/y terms MSE on the sigmoid;
- truths are padded to ``max_boxes`` with a validity mask.

The gradient is JAX's where the two libraries' conventions differ: a tie
of ``maximum``/``minimum`` splits it evenly (``torch.maximum`` against a
zero tensor, not ``clamp_min``, which passes it whole), and ``|x|`` at 0
takes +1 as ``jnp.abs`` does (``torch.abs`` takes 0). The fp32 forward is
``models.yolov2.head_fp32``, whose convs keep TF32 off in the backward.
The step is a plain function of (params, velocity, batch, lr_scale); the
parameter trees are ``params_fp32``'s, {"conv{idx}": {"w": HWIO, "b"}}.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .graph import NetworkSpec, RegionSpec
from .models import yolov2 as m
from .parallel import comm
from .parallel.mesh import tp_sharded


@dataclass(frozen=True)
class LossConfig:
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    thresh: float = 0.6
    rescore: bool = True


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _box_iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of center-format boxes; a (..., 4), b (..., 4), broadcast."""
    zero = a.new_zeros(())
    inter_w = torch.minimum(a[..., 0] + a[..., 2] / 2,
                            b[..., 0] + b[..., 2] / 2) - \
        torch.maximum(a[..., 0] - a[..., 2] / 2, b[..., 0] - b[..., 2] / 2)
    inter_h = torch.minimum(a[..., 1] + a[..., 3] / 2,
                            b[..., 1] + b[..., 3] / 2) - \
        torch.maximum(a[..., 1] - a[..., 3] / 2, b[..., 1] - b[..., 3] / 2)
    inter = torch.maximum(inter_w, zero) * torch.maximum(inter_h, zero)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / torch.maximum(union, a.new_full((), 1e-9))


def _bce(logit: torch.Tensor, target) -> torch.Tensor:
    """BCE on the logit, in the stable form of ``yolotpu``'s."""
    return (torch.maximum(logit, logit.new_zeros(())) - logit * target
            + torch.log1p(torch.exp(-_abs(logit))))


def region_loss(head: torch.Tensor, truth_boxes: torch.Tensor,
                truth_cls: torch.Tensor, truth_mask: torch.Tensor,
                spec: RegionSpec, cfg: LossConfig = LossConfig()) -> torch.Tensor:
    """head: (B, h, w, n*(5+classes)) raw conv output, fp32.
    truth_boxes: (B, M, 4) xywh relative [0,1]; truth_cls: (B, M) int;
    truth_mask: (B, M) {0,1}. Returns the loss summed over the batch and
    divided by B, a 0-dim tensor."""
    B, lh, lw, _ = head.shape
    n, classes = spec.num, spec.classes
    dev = head.device
    x = head.reshape(B, lh, lw, n, 5 + classes)
    anchors = torch.tensor(spec.biases, dtype=torch.float32,
                           device=dev).reshape(n, 2)

    sx, sy = torch.sigmoid(x[..., 0]), torch.sigmoid(x[..., 1])
    tw, th = x[..., 2], x[..., 3]
    obj_logit = x[..., 4]
    logits = x[..., 5:]

    col = torch.arange(lw, dtype=torch.float32, device=dev)[None, None, :, None]
    row = torch.arange(lh, dtype=torch.float32, device=dev)[None, :, None, None]
    pred = torch.stack([(col + sx) / lw, (row + sy) / lh,
                        torch.exp(tw) * anchors[:, 0] / lw,
                        torch.exp(th) * anchors[:, 1] / lh], dim=-1)

    # noobject mask: every anchor whose best IoU vs any truth <= thresh (a
    # comparison, so no gradient flows through it)
    ious_all = _box_iou_xywh(pred.detach()[:, :, :, :, None, :],
                             truth_boxes[:, None, None, None, :, :])
    ious_all = torch.where(truth_mask[:, None, None, None, :] > 0, ious_all,
                           ious_all.new_zeros(()))
    noobj = (ious_all.amax(dim=-1) <= cfg.thresh).float()

    # per-truth responsible anchor: best shape IoU at (0, 0), the first on
    # ties
    tw_h = truth_boxes[..., 2:4]
    shape_truth = torch.cat([torch.zeros_like(tw_h), tw_h], dim=-1)
    anc_wh = torch.stack([anchors[:, 0] / lw, anchors[:, 1] / lh], dim=-1)
    shape_anc = torch.cat([torch.zeros_like(anc_wh), anc_wh], dim=-1)
    shape_iou = _box_iou_xywh(shape_truth[:, :, None, :],
                              shape_anc[None, None, :, :])
    best_n = torch.argmax(shape_iou, dim=-1)

    # astype(int32) truncates toward zero, as .long() does
    ci = (truth_boxes[..., 0] * lw).long().clamp(0, lw - 1)
    cj = (truth_boxes[..., 1] * lh).long().clamp(0, lh - 1)
    M = truth_boxes.shape[1]
    bidx = torch.arange(B, device=dev)[:, None].expand(B, M)
    g = (bidx, cj, ci, best_n)

    mask = truth_mask.float()
    # the assigned slot is not also pulled toward 0 (darknet recomputes its
    # delta in the object term): .at[g].max(mask), duplicates included
    slot = ((bidx * lh + cj) * lw + ci) * n + best_n
    assigned = torch.zeros(B * lh * lw * n, device=dev).scatter_reduce(
        0, slot.reshape(-1), mask.reshape(-1), reduce="amax").reshape(
        noobj.shape)
    loss_noobj = cfg.noobject_scale * torch.sum(
        noobj * (1.0 - assigned) * _bce(obj_logit, 0.0))

    # predictions at the assigned slots (a slot two truths share gathers
    # twice, and its gradients add)
    t_tx = truth_boxes[..., 0] * lw - ci
    t_ty = truth_boxes[..., 1] * lh - cj
    a_w = anchors[best_n, 0] / lw
    a_h = anchors[best_n, 1] / lh
    eps = truth_boxes.new_full((), 1e-9)
    t_tw = torch.log(torch.maximum(truth_boxes[..., 2], eps) / a_w)
    t_th = torch.log(torch.maximum(truth_boxes[..., 3], eps) / a_h)

    loss_coord = cfg.coord_scale * torch.sum(mask * (
        (sx[g] - t_tx) ** 2 + (sy[g] - t_ty) ** 2 +
        (tw[g] - t_tw) ** 2 + (th[g] - t_th) ** 2))

    iou_t = _box_iou_xywh(pred[g], truth_boxes)
    target_obj = iou_t if cfg.rescore else torch.ones_like(iou_t)
    loss_obj = cfg.object_scale * torch.sum(
        mask * _bce(obj_logit[g], target_obj.detach()))

    logp = torch.log_softmax(logits[g], dim=-1)
    # jax.nn.one_hot: a class outside [0, classes) is a row of zeros
    onehot = (truth_cls[..., None].long()
              == torch.arange(classes, device=dev)).float()
    loss_cls = cfg.class_scale * torch.sum(mask * -(onehot * logp).sum(-1))

    return (loss_noobj + loss_coord + loss_obj + loss_cls) / B


def make_train_step(spec: NetworkSpec, lr: float = 1e-3,
                    momentum: float = 0.9, cfg: LossConfig = LossConfig(),
                    clip_norm: float = 0.0, mesh=None,
                    tally: dict | None = None):
    """SGD+momentum step over fp32 params: ``train_step(params, velocity,
    batch, lr_scale=1.0) -> (new params, new velocity, loss)``, trees of
    ``params_fp32``'s shape on one device; batch {"images" (B, H, W, 3)
    float or uint8, "boxes" (B, M, 4), "classes" (B, M), "mask" (B, M)}
    tensors on that device. ``v = momentum*v - lr*lr_scale*g``, then
    ``p = p + v``. ``clip_norm`` > 0 clips the global gradient norm: the
    full graph's BN is folded into its weights, so nothing renormalizes
    activations and early steps otherwise explode. The arguments are not
    changed.

    With a (dp, tp) ``parallel.mesh.Mesh`` the step is this rank's part of
    the step over the whole batch: params and velocity are its blocks
    (``mesh.shard_params``), the batch its dp rows, and the step returns
    its blocks and the whole batch's loss. Each rank's loss is scaled to
    the global batch (``region_loss`` divides by its own B), the gradients
    are summed over dp, and the loss reported is the sum of the scaled
    losses; the tp-sharded convs run in ``head_fp32``'s Megatron pair. The
    clip's global norm sums each sharded leaf's squares over tp once and
    each replicated leaf's once, in the same leaf order. ``tally`` counts
    the collectives' bytes by kind."""
    rspec = spec.region
    if mesh is not None and mesh.axis_names != ("dp", "tp"):
        raise ValueError(f"the train step shards over a (dp, tp) mesh, not "
                         f"{mesh.shape}")
    dp = 1 if mesh is None else mesh.shape["dp"]
    sharded = set() if mesh is None else {
        f"conv{l.idx}" for l in spec.conv_layers() if tp_sharded(l.n, mesh)}

    def train_step(params: dict, velocity: dict, batch: dict,
                   lr_scale: float = 1.0):
        # jax.tree_util's leaf order, which the global norm sums in
        names = [(k, leaf) for k in sorted(params) for leaf in sorted(params[k])]
        p = {k: {leaf: v.detach().requires_grad_(True)
                 for leaf, v in params[k].items()} for k in params}
        with torch.enable_grad():
            head = m.head_fp32(spec, p, batch["images"], mesh, tally)
            loss = region_loss(head, batch["boxes"], batch["classes"],
                               batch["mask"], rspec, cfg)
            if dp > 1:
                loss = loss / dp   # this rank's share of the global batch
            grads = torch.autograd.grad(loss, [p[k][leaf]
                                               for k, leaf in names])
        with torch.no_grad():
            loss = loss.detach()
            if dp > 1:
                flat = comm.all_reduce_sum(
                    torch.cat([g.reshape(-1) for g in grads] + [loss[None]]),
                    mesh.group("dp"), tally, "dp_grad_reduce")
                loss = flat[-1]
                grads = [v.view_as(g) for v, g in zip(
                    flat[:-1].split([g.numel() for g in grads]), grads)]
            if clip_norm > 0:
                sq = [torch.sum(g.float() ** 2) for g in grads]
                tp_ix = [i for i, (k, _) in enumerate(names) if k in sharded]
                if tp_ix:
                    tot = comm.all_reduce_sum(
                        torch.stack([sq[i] for i in tp_ix]),
                        mesh.group("tp"), tally, "tp_norm_reduce")
                    for j, i in enumerate(tp_ix):
                        sq[i] = tot[j]
                gnorm = torch.sqrt(sum(sq))
                scale = torch.clamp_max(
                    clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
                grads = [g * scale for g in grads]
            # lr * lr_scale in float32, as the JAX step takes it
            step = float(np.float32(lr) * np.float32(lr_scale))
            new_p = {k: {} for k in params}
            new_v = {k: {} for k in params}
            for (k, leaf), g in zip(names, grads):
                v = momentum * velocity[k][leaf] - step * g
                new_v[k][leaf] = v
                new_p[k][leaf] = params[k][leaf] + v
        return new_p, new_v, loss

    return train_step


def zeros_like_velocity(params: dict) -> dict:
    return {k: {leaf: torch.zeros_like(v) for leaf, v in p.items()}
            for k, p in params.items()}
