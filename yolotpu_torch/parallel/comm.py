"""The collectives of the sharded forward and train step.

One set of calls serves gloo and NCCL. Neither takes int16 (gloo raises
"Invalid scalar type"; NCCL has no 16-bit integer type), so a tensor of a
type outside ``AS_IS`` travels as its ``uint8`` view and is viewed back:
the same bytes, so bit-exact. ``all_gather`` is the list form, which both
backends take on CPU and CUDA tensors alike.

Every call takes a ``tally`` ({kind: bytes}) and adds to ``kind`` the
bytes this rank receives: for an all-gather the other ranks' blocks, for
an all-reduce the tensor it reduces (nothing in a group of one, where the
call still runs).

The train step's tensor parallelism is Megatron's conjugate pair:
``copy_to_tp`` before a sharded conv (the identity; its backward sums the
input gradient over tp) and ``gather_from_tp`` after it (the all-gather
of the Cout blocks; its backward takes this rank's own block). Not
``torch.distributed.nn.functional.all_gather``: its backward sums the
blocks' gradients over the ranks, which multiplies by tp the gradient of
every replicated consumer (the head conv, the pools, the reorg, the
routes), since each tp rank already holds the whole of it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, Sharding

AS_IS = (torch.uint8, torch.int8, torch.int32, torch.int64, torch.float32,
         torch.float64)


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.dtype in AS_IS else x.view(torch.uint8)


def _count(tally: dict | None, kind: str, nbytes: int) -> None:
    if tally is not None:
        tally[kind] = tally.get(kind, 0) + nbytes


def all_gather(x: torch.Tensor, dim: int, group, tally: dict | None = None,
               kind: str = "gather") -> torch.Tensor:
    """The blocks x of every rank of ``group``, in group rank order,
    concatenated on ``dim``."""
    blocks = gather_list(x, group, tally, kind)
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=dim)


def gather_list(x: torch.Tensor, group, tally: dict | None = None,
                kind: str = "gather") -> list[torch.Tensor]:
    """[the x of each rank of ``group``], in group rank order."""
    n = dist.get_world_size(group)
    w = _wire(x)
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    _count(tally, kind, (n - 1) * w.numel() * w.element_size())
    return [o.view(x.dtype) for o in out]


def all_reduce_sum(x: torch.Tensor, group, tally: dict | None = None,
                   kind: str = "reduce") -> torch.Tensor:
    """x summed over ``group``, in place (x contiguous, a type of AS_IS)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    if dist.get_world_size(group) > 1:
        _count(tally, kind, x.numel() * x.element_size())
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tally):
        ctx.group, ctx.tally = group, tally
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (all_reduce_sum(grad.contiguous().clone(), ctx.group,
                               ctx.tally, "tp_grad_reduce"), None, None)


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tally):
        ctx.index = dist.get_rank(group)
        ctx.width = x.shape[-1]
        return all_gather(x, -1, group, tally, "tp_gather")

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(-1, ctx.index * ctx.width, ctx.width)
                .contiguous(), None, None)


def copy_to_tp(x: torch.Tensor, mesh: Mesh,
               tally: dict | None = None) -> torch.Tensor:
    """x, the whole input of a tp-sharded conv; its gradient summed over tp."""
    return _CopyToTP.apply(x, mesh.group("tp"), tally)


def gather_from_tp(x: torch.Tensor, mesh: Mesh,
                   tally: dict | None = None) -> torch.Tensor:
    """This rank's Cout block of a conv's output -> the whole output; the
    gradient back to the block is this rank's slice of it."""
    return _GatherFromTP.apply(x, mesh.group("tp"), tally)


def gather_params(local: dict, shardings: dict) -> dict:
    """The full tree of ``param_shardings``' blocks ``local``: each sharded
    leaf all-gathered over tp on its split axis (every rank calls this)."""
    out = {}
    for name, p in local.items():
        out[name] = {}
        for leaf, v in p.items():
            sh: Sharding = shardings[name][leaf]
            axis = next((d for d, a in enumerate(sh.spec) if a is not None),
                        None)
            out[name][leaf] = (v if axis is None else all_gather(
                v, axis, sh.mesh.group(sh.spec[axis])))
    return out
