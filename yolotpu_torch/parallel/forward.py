"""The integer tiers' forward over a mesh: the counterpart of
``build_forward(..., mesh=)`` in ``yolotpu/models/yolov2.py``.

Every local layer is ``YoloV2Q.step`` on this rank's tensors, so each
rank runs the same hand-written kernels as one card does, on its block:

- dp: the rank's rows of the batch (``mesh.batch_sharding``).
- tp: the model is built from the rank's Cout block of each conv that
  ``mesh.tp_sharded`` picks (weights and biases sliced, then packed for the
  tensor cores; the int8/w8a16 shift vectors sliced alike); after each
  such conv the blocks are all-gathered on the channel axis, so the
  requant chain, the reorg realign, the route concats, the replicated head
  conv and the decode/NMS all see the whole tensor.
- sp: the rank's rows of H (``mesh.spatial_batch_sharding``). A 3x3/s1
  conv with darknet's SAME padding runs on the slab and one halo row from
  each neighbour (an all-gather of every rank's first and last rows) and
  drops the extra output rows, so the kernel's own SAME zero padding acts
  only at the image's true edges; a 1x1/s1 conv with no padding and a
  2x2/s2 pool on an even slab are local (``serves_on_slab``). H is
  gathered before the first layer the split cannot serve exactly: a
  strided conv, any other size, any other padding (a VALID 3x3, a padded
  1x1), a 2x2/s2 pool on an odd slab (at 416 with sp=4 the slabs are 104,
  52, 26 and 13 rows, so the pool at layer 11), any other pool, the reorg,
  a route concat and the region layer; that is where the JAX package's
  ``_batch_only`` pins it. Under sp a conv that the tier fuses with the
  pool after it (the int16 and int8 tiers' fold) runs unfused, its pool
  as its own op: a halo row would put the kernel's pool windows off by
  one.

int32 sums are exact and the kernels deterministic, so every mesh gives
the replicated run's head and detections bit for bit (under sp the int16
tier's unfused pools too, since its fold's "acc" order is darknet's
wherever acc + 2^(shift-1) does not wrap int32).
"""

from __future__ import annotations

import torch

from ..graph import ConvSpec, MaxPoolSpec, NetworkSpec, RegionSpec, RouteSpec
from ..models.yolov2 import YoloV2Q, unfused
from ..weights import QTables
from . import comm
from .mesh import Mesh, Sharding, shard_params, tp_sharded


def serves_on_slab(l, rows: int) -> bool:
    """Whether layer ``l`` runs exactly on an H slab of ``rows`` rows (with
    a one-row halo from each neighbour for a 3x3 conv): a stride-1 1x1 or
    3x3 conv with darknet's padding (size // 2, so no padding or SAME), a
    2x2/s2 pool on an even slab, a route of one layer."""
    if isinstance(l, ConvSpec):
        return l.stride == 1 and l.size in (1, 3) and l.pad == l.size // 2
    if isinstance(l, MaxPoolSpec):
        return l.size == l.stride == 2 and rows % 2 == 0
    return isinstance(l, RouteSpec) and len(l.layers) == 1


class ShardedYoloV2Q:
    """``YoloV2Q`` over ``mesh``: this rank's part of it. ``params`` is the
    full tree (``params_int16`` and the like); ``forward(x)`` takes this
    rank's block of the frames and returns the outputs of this rank's
    frames, whole in H and C (``gather_batch`` joins the ranks' frames).
    ``tally`` counts the bytes each collective kind receives
    ({"tp_gather", "sp_halo", "sp_gather"}: bytes)."""

    def __init__(self, spec: NetworkSpec, qtables: QTables | None,
                 params: dict, mesh: Mesh, device: torch.device | str = "cuda",
                 precision: str = "int16",
                 outputs: tuple[str, ...] = ("head", "boxes")):
        if precision == "fp32" or "acts" in outputs:
            raise ValueError("the sharded forward runs the integer tiers' "
                             f"outputs head, boxes and detections, not "
                             f"{precision!r} {outputs}")
        self.mesh, self.spec = mesh, spec
        self.sp = mesh.shape.get("sp", 1)
        self.tp_convs = {l.idx for l in spec.conv_layers()
                         if tp_sharded(l.n, mesh)}
        self.model = YoloV2Q(spec, qtables, shard_params(params, mesh),
                             device, precision, outputs=outputs)
        if self.sp > 1:
            self.model.route = unfused(self.model.route)
            self.model.folded = set()
        # the per-channel shifts were laid out for the whole Cout
        for idx in self.tp_convs:
            s = getattr(self.model, f"s{idx}", None)
            if s is not None:
                setattr(self.model, f"s{idx}",
                        Sharding(mesh, ("tp",))(s).contiguous())
        self.tally: dict[str, int] = {}

    def _gather_h(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(x, 1, self.mesh.group("sp"), self.tally,
                               "sp_gather")

    def _halo(self, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        """x with its neighbours' edge rows above and below, and how many
        rows were added at the top and at the bottom."""
        rows = comm.gather_list(torch.cat([x[:, :1], x[:, -1:]], dim=1),
                                self.mesh.group("sp"), self.tally, "sp_halo")
        i = self.mesh.coords()["sp"]
        parts = ([rows[i - 1][:, 1:]] if i > 0 else []) + [x] + (
            [rows[i + 1][:, :1]] if i < self.sp - 1 else [])
        return torch.cat(parts, dim=1), int(i > 0), int(i < self.sp - 1)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> dict:
        m = self.model
        cur = m.quantize_input(x.contiguous())
        acts: dict[int, torch.Tensor] = {}
        slab = self.sp > 1      # cur (and every act) is an H slab
        head = None
        for l in self.spec.layers:
            if slab and not serves_on_slab(l, cur.shape[1]):
                gathered = {id(cur): self._gather_h(cur)}
                for k, v in acts.items():
                    if id(v) not in gathered:
                        gathered[id(v)] = self._gather_h(v)
                    acts[k] = gathered[id(v)]
                cur, slab = gathered[id(cur)], False
            if slab and isinstance(l, ConvSpec) and l.size == 3:
                xh, top, bottom = self._halo(cur)
                y = m.step(l, xh, acts)
                cur = y[:, top:y.shape[1] - bottom].contiguous()
            else:
                cur = m.step(l, cur, acts)
            if isinstance(l, ConvSpec) and l.idx in self.tp_convs:
                cur = comm.all_gather(cur, -1, self.mesh.group("tp"),
                                      self.tally, "tp_gather")
            if isinstance(l, RegionSpec):
                head = cur
            if l.idx in m._needed:
                acts[l.idx] = cur
        if slab:
            cur = self._gather_h(cur)
        if head is None:   # headless graph
            head = m._dequantize(cur, m.plan.output_q)
        return m.outputs_of(head)

    __call__ = forward


def gather_batch(out: dict, mesh: Mesh, tally: dict | None = None) -> dict:
    """Each output of every dp rank's frames, joined on the batch axis in
    dp order (every rank calls this; every rank gets the whole)."""
    return {k: comm.all_gather(v, 0, mesh.group("dp"), tally, "dp_gather")
            for k, v in out.items()}
