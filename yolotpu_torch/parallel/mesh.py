"""Device mesh and shardings for multi-GPU inference and training, on
``torch.distributed``.

The counterpart of ``yolotpu/parallel/mesh.py``, with its names and its
arithmetic. One process drives one mesh position (a rank), and a
``Mesh`` names the axes the ranks form:

- ``dp`` (data parallel): the batch dimension; each rank runs its frames.
- ``tp`` (tensor parallel): conv output channels. A conv whose Cout divides
  by tp keeps only its contiguous Cout block (HWIO axis 3) and its bias
  block; its output blocks are all-gathered on the channel axis
  (``parallel.forward``), which is the column-parallel form GSPMD gives the
  JAX package. Any other conv (the 425-channel head) is replicated.
- ``sp`` (spatial, ``make_mesh_sp``): activations split on H, with one halo
  row a side per 3x3 conv.

Rank r sits at mesh coordinates ``np.unravel_index(r, shape)``: (r // tp,
r % tp) on a (dp, tp) mesh, where ``np.array(devices).reshape(dp, tp)``
puts device r in the JAX package. A ``Sharding`` is a plain function that
gives a rank its block of a full tensor: the block that JAX's
``NamedSharding`` of the same spec gives that device. Each axis's process
group comes from ``dist.new_group``; a mesh made with no process group
initialised has no groups and only lays out the shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """Split n into (dp, tp): prefer tp in {1,2,4} and maximize dp."""
    for tp in (4, 2, 1):
        if n_devices % tp == 0 and tp <= n_devices:
            return n_devices // tp, tp
    return n_devices, 1


@dataclass(frozen=True)
class Mesh:
    """The axes {name: extent} in order, this process's rank (None for a
    layout with no processes) and its process group along each axis."""

    shape: dict[str, int]
    rank: int | None = None
    groups: dict[str, object] = field(default_factory=dict, repr=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """{axis: index} of ``rank`` (this process's by default)."""
        rank = self.rank if rank is None else rank
        if rank is None or not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.shape, idx)}

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        if axis not in self.groups:
            raise ValueError(f"mesh {self.shape} has no process group on "
                             f"{axis!r}: make it with torch.distributed "
                             "initialised")
        return self.groups[axis]


def _make(n_devices: int | None, axes: dict[str, int]) -> Mesh:
    """A mesh of ``axes``; with a process group initialised, over the whole
    world, one group per axis and line of the other axes (every rank calls
    ``new_group`` for every group, in one order)."""
    if not dist.is_initialized():
        return Mesh(axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = math.prod(axes.values())
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}: "
                         "launch one process per mesh position")
    ranks = np.arange(n).reshape(tuple(axes.values()))
    groups = {}
    for i, axis in enumerate(axes):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, axes[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(axes, rank, groups)


def _default_n() -> int:
    """The world when torch.distributed runs, else the visible cards (one
    at least, as the JAX package's CPU device)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The (dp, tp) mesh of ``factor_mesh(n)``."""
    n = n_devices or _default_n()
    dp, tp = factor_mesh(n)
    return _make(n, {"dp": dp, "tp": tp})


def make_mesh_sp(n_devices: int | None = None, sp: int | None = None) -> Mesh:
    """(dp, sp) mesh for spatially partitioned inference: activations split
    on H, one halo row a side for each 3x3 conv. ``sp`` defaults to the
    largest power of two up to 4 that divides n: deep layers shrink H
    (416 -> 13), and each extra sp shard adds a halo row per 3x3 conv."""
    n = n_devices or _default_n()
    if sp is None:
        sp = 1
        while sp * 2 <= 4 and n % (sp * 2) == 0:
            sp *= 2
    return _make(n, {"dp": n // sp, "sp": sp})


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: ``spec`` names, per dimension, the mesh
    axis (or tuple of axes, major first) it is split over, or None, as a
    JAX ``PartitionSpec``; trailing dimensions left out are replicated.
    ``sharding(x)`` is this rank's block of the full tensor x (a view),
    ``block(x, rank)`` any rank's."""

    mesh: Mesh
    spec: tuple = ()

    def block(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        at = self.mesh.coords(rank)
        for dim, axes in enumerate(self.spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            count = math.prod(self.mesh.shape[a] for a in axes)
            index = 0
            for a in axes:
                index = index * self.mesh.shape[a] + at[a]
            if x.shape[dim] % count:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                                 f"not split {count} ways over {axes}")
            size = x.shape[dim] // count
            x = x.narrow(dim, index * size, size)
        return x

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x, self.mesh.rank)


def tp_sharded(cout: int, mesh: Mesh) -> bool:
    """Whether a conv of ``cout`` output channels shards on the mesh's tp."""
    tp = mesh.shape.get("tp", 1)
    return tp > 1 and cout % tp == 0


def param_shardings(params: dict, mesh: Mesh) -> dict:
    """Shard conv weights on Cout over tp; biases likewise; replicate over dp.

    Weight layout is HWIO so Cout is axis 3 (fp32/int16 alike). Layers whose
    Cout is not divisible by the tp extent (e.g. the 425-channel head conv)
    stay replicated."""
    out = {}
    for name, p in params.items():
        if tp_sharded(p["w"].shape[3], mesh):
            out[name] = {"w": Sharding(mesh, (None, None, None, "tp")),
                         "b": Sharding(mesh, ("tp",))}
        else:
            out[name] = {"w": Sharding(mesh), "b": Sharding(mesh)}
    return out


def batch_sharding(mesh: Mesh) -> Sharding:
    """NHWC batch: shard N over dp, replicate spatial/channels."""
    return Sharding(mesh, ("dp", None, None, None))


def spatial_batch_sharding(mesh: Mesh) -> Sharding:
    """NHWC batch on a (dp, sp) mesh: N over dp, H over sp."""
    return Sharding(mesh, ("dp", "sp", None, None))


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's blocks of a full parameter tree, contiguous."""
    sh = param_shardings(params, mesh)
    return {name: {leaf: sh[name][leaf](v).contiguous()
                   for leaf, v in p.items()} for name, p in params.items()}


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)
