"""On-device class-wise NMS with fixed shapes, in PyTorch.

The counterpart of ``yolotpu/ops/nms.py``: the decode and the darknet
threshold rule pick the top-K candidates by objectness, and a class-wise
greedy NMS over them leaves a fixed top-K table, so only a few KB per frame
leave the card. Darknet semantics (``src/core/yolo_post.cpp:54-85``): for
each class, boxes in descending score order; a box's class score is zeroed
when a higher-scoring surviving box of the same class overlaps it with
IoU > thresh.

The class-wise NMS, a ``vmap`` of a K-step ``lax.scan`` over the IoU matrix
in the JAX package, is the hand-written kernel ``nms_greedy``
(``csrc/nms_greedy.cu``): it takes the candidate boxes, tests every pair
once per frame into a bit table and walks each class's live boxes with one
warp, so the IoU matrix never exists on the card. The candidate selection,
the argmax and the final ordering stay torch ops. Every sort is stable and
descending, which is ``lax.top_k``'s and ``jnp.argsort(-x)``'s order: equal
values in index order (quantized heads give equal scores). ``nms_greedy``
on CPU tensors runs its plain version; on CUDA tensors it launches the
kernel or raises. ``LAUNCHES`` counts kernel launches, and only those.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = {"nms_greedy": 0}
MAX_K = 1024   # the walk's removed mask: one 32-bit word per lane of a warp
WARPS = 4      # classes (warps) per block of the walk: chip_smoke.py's sweep
SMEM_MAX = 232448   # dynamic shared memory one block may have on sm_90


def reset_launches() -> None:
    LAUNCHES["nms_greedy"] = 0


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) center-format boxes -> (..., N, M) IoU."""
    ax0, ay0 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax1, ay1 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx0, by0 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx1, by1 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = (torch.minimum(ax1[..., :, None], bx1[..., None, :])
          - torch.maximum(ax0[..., :, None], bx0[..., None, :])).clamp_min(0.0)
    ih = (torch.minimum(ay1[..., :, None], by1[..., None, :])
          - torch.maximum(ay0[..., :, None], by0[..., None, :])).clamp_min(0.0)
    inter = iw * ih
    union = ((a[..., 2] * a[..., 3])[..., :, None]
             + (b[..., 2] * b[..., 3])[..., None, :] - inter)
    return inter / union.clamp_min(1e-12)


def greedy_nms_mask(ious: torch.Tensor, scores: torch.Tensor,
                    thresh: float) -> torch.Tensor:
    """Survivor mask of greedy NMS over score-descending boxes, for any
    leading batch dims: ious (..., K, K) in that order, scores (..., K)
    (zeros are absent boxes) -> keep (..., K) bool. A box survives unless a
    surviving earlier box j overlaps it, ious[j, i] > thresh. A Python loop
    over the K steps, as the JAX package's scan."""
    k = scores.shape[-1]
    sup = ious > thresh
    keep = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    for i in range(k):
        killed = (sup[..., :i, i] & keep[..., :i]).any(-1)
        keep[..., i] = (scores[..., i] > 0) & ~killed
    return keep


def nms_greedy_plain(cprob: torch.Tensor, cboxes: torch.Tensor,
                     thresh: float) -> torch.Tensor:
    """The per-class greedy NMS (``nms.py:89-98``) as torch ops: cprob (B, K,
    C), cboxes (B, K, 4) -> (B, K, C), cprob where a box survives in its
    class and 0 where it does not. The IoU matrix, a stable per-class sort,
    then ``greedy_nms_mask`` over all frames and classes at once."""
    ious = box_iou_matrix(cboxes, cboxes)
    scores = cprob.transpose(1, 2)                          # (B, C, K)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    s_sorted = scores.gather(-1, order)
    bsz, c, k = order.shape
    rows = ious[torch.arange(bsz, device=ious.device)[:, None, None], order]
    i_s = rows.gather(-1, order[:, :, None, :].expand(bsz, c, k, k))
    keep_sorted = greedy_nms_mask(i_s, s_sorted, thresh)
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, scores, 0.0).transpose(1, 2)


def _check(cprob: torch.Tensor, cboxes: torch.Tensor) -> None:
    if cprob.dtype != torch.float32 or cboxes.dtype != torch.float32:
        raise TypeError(f"nms_greedy: want float32 cprob and cboxes; got "
                        f"{cprob.dtype}, {cboxes.dtype}")
    if cprob.ndim != 3 or cboxes.shape != (*cprob.shape[:2], 4):
        raise ValueError(f"nms_greedy: cprob{tuple(cprob.shape)} and "
                         f"cboxes{tuple(cboxes.shape)}; want (B, K, C), "
                         "(B, K, 4)")
    if cprob.device != cboxes.device or cprob.device.type not in ("cpu",
                                                                  "cuda"):
        raise ValueError(f"nms_greedy: operands on {cprob.device}, "
                         f"{cboxes.device}")


def row_stride(k: int) -> int:
    """32-bit words of one row of the kernel's suppression table in memory:
    ceil(K/32) rounded up to 4, so that every row is 16-byte aligned."""
    return ((k + 31) // 32 + 3) // 4 * 4


def walk_smem(k: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one block of the walk: the frame's
    table, and per warp its class's scores by box (an odd stride), its live
    boxes' scores, their box indices and order (u16) and its kept mask."""
    return 4 * k * row_stride(k) + warps * (4 * (k | 1) + 8 * k + 128)


def nms_greedy(cprob: torch.Tensor, cboxes: torch.Tensor,
               thresh: float) -> torch.Tensor:
    """cprob (B, K, C) f32 (class scores, already thresholded), cboxes (B,
    K, 4) f32 (center format) -> (B, K, C) f32: cprob where the box survives
    class c's greedy NMS at IoU ``thresh``, else 0. On the card: the
    ``nms_greedy`` kernel, K <= MAX_K, contiguous operands, WARPS classes a
    block of its walk (C where C is smaller)."""
    _check(cprob, cboxes)
    if cprob.device.type == "cpu":
        return nms_greedy_plain(cprob, cboxes, thresh)
    b, k, c = cprob.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"nms_greedy: K={k}; the kernel takes 1 to {MAX_K}")
    if not (cprob.is_contiguous() and cboxes.is_contiguous()):
        raise ValueError("nms_greedy: the kernel needs contiguous operands")
    if cboxes.data_ptr() % 16:
        raise ValueError("nms_greedy: the kernel reads each box as 16 bytes; "
                         "cboxes must be 16-byte aligned")
    warps = min(WARPS, c)
    if walk_smem(k, warps) > SMEM_MAX:
        raise ValueError(f"nms_greedy: K={k} with {warps} classes a block "
                         f"needs {walk_smem(k, warps)} bytes of shared memory;"
                         f" a block has {SMEM_MAX}")
    table = torch.empty((b, k, row_stride(k)), dtype=torch.int32,
                        device=cprob.device)
    out = torch.empty_like(cprob)
    return _build.launch("nms_greedy", "yq_nms_greedy", out, cprob.data_ptr(),
                         cboxes.data_ptr(), table.data_ptr(), out.data_ptr(),
                         b, k, c, warps, float(thresh), counts=LAUNCHES)


def candidates(boxes: torch.Tensor, obj: torch.Tensor, probs: torch.Tensor,
               thresh: float, topk: int):
    """The NMS's inputs: darknet's threshold rule on the top-K objectness
    candidates (``nms.py:76-87``). boxes (B, N, 4), obj (B, N), probs (B,
    N, C) -> cboxes (B, K, 4), cprob (B, K, C) = obj * p zeroed unless
    > thresh, and saturated (B,), K = min(topk, N)."""
    k = min(topk, obj.shape[1])
    obj_gated = torch.where(obj > thresh, obj, 0.0)
    saturated = (obj_gated > 0).sum(dim=1) > k
    top_obj, idx = (t[:, :k] for t in torch.sort(
        obj_gated, dim=1, descending=True, stable=True))
    cboxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    cprob = probs.gather(1, idx[..., None].expand(-1, -1, probs.shape[2]))
    cprob = cprob * top_obj[..., None]
    cprob = torch.where(cprob > thresh, cprob, 0.0)
    return cboxes, cprob, saturated


def topk_decode_nms(boxes: torch.Tensor, obj: torch.Tensor,
                    probs: torch.Tensor, thresh: float, nms_thresh: float,
                    topk: int = 256):
    """Batched selection: darknet's threshold rule, then class-wise NMS.

    boxes (B, N, 4), obj (B, N), probs (B, N, C), from
    ``region.decode_region``. Returns sel_boxes (B, K, 4), sel_scores
    (B, K), sel_classes (B, K) int32, sel_valid (B, K) bool and saturated
    (B,) bool. Scores follow darknet: prob = obj * p, zeroed unless
    > thresh (yolo_region.cpp:187-191), then class-wise NMS over the top-K
    objectness candidates. ``saturated[b]`` is True when frame b had more
    than K candidates over the threshold, where the host path, which takes
    all N, may differ."""
    cboxes, cprob, saturated = candidates(boxes, obj, probs, thresh, topk)
    cprob_nms = nms_greedy(cprob, cboxes, nms_thresh)
    best_c = cprob_nms.argmax(dim=2)                         # the first max
    best_p = cprob_nms.gather(2, best_c[..., None])[..., 0]
    valid = best_p > thresh
    o = torch.sort(best_p, dim=1, descending=True, stable=True).indices
    return (cboxes.gather(1, o[..., None].expand(-1, -1, 4)),
            best_p.gather(1, o), best_c.gather(1, o).to(torch.int32),
            valid.gather(1, o), saturated)
