"""Meshes over the process group (counterpart of
``repro/launch/mesh.py``).

A :class:`Mesh` names the axes of a rank grid, row-major over the ranks of
the default process group that ``dist.comm.init`` made, and holds one
process group per axis and per folded run of adjacent axes
(``("pod", "data")``): the groups the collectives of a ``shard_map`` body
run over in JAX. The groups come from
``torch.distributed.device_mesh.init_device_mesh`` over that default
group, so they take its backend (gloo where ranks share a card; the
``"cpu"`` device type there, since DTensor placement plays no part), and
a folded run is the device mesh's ``_flatten`` of those axes. A group of
one rank is ``comm.SELF``: a collective over it is the identity.

Production topologies (TPU pods in the JAX package) are shapes only:
  single-pod:  (data=16, model=16)        = 256 ranks
  multi-pod:   (pod=2, data=16, model=16) = 512 ranks
No run of the port needs them; ``make_production_mesh`` returns a mesh
without groups for the sharding rules and the accounting. Under
``dist.comm.counting`` a mesh without groups hands out
``comm.CountedGroup`` objects (axes and size), so a step runs its collectives'
counts (``launch.op_analysis``) without a process group.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist import comm
from repro_torch.dist.comm import SELF


class Mesh:
    """Named axes over ranks, row-major (the last axis fastest)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 rank: Optional[int] = None, build_groups: bool = True):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} against axes {axes}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.size = 1
        for s in shape:
            self.size *= int(s)
        self.rank = rank
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if build_groups:
            self._build_groups()

    # -- coordinates ----------------------------------------------------------
    def coords_of(self, rank: int) -> Dict[str, int]:
        out, r = {}, rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.rank is None:
            raise RuntimeError("an abstract mesh has no rank")
        return self.coords_of(self.rank)[axis]

    # -- groups -----------------------------------------------------------------
    def _size_of(self, axes: Tuple[str, ...]) -> int:
        size = 1
        for a in axes:
            size *= self.shape[a]
        return size

    def _build_groups(self) -> None:
        if not dist.is_initialized():
            raise RuntimeError("Mesh: no process group; call "
                               "dist.comm.init first")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks, "
                             f"the process group {world}")
        self.rank = dist.get_rank()
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(
            kind, tuple(self.shape[a] for a in self.axis_names),
            mesh_dim_names=self.axis_names)
        n = len(self.axis_names)
        for lo in range(n):
            for hi in range(lo + 1, n + 1):
                axes = self.axis_names[lo:hi]
                size = self._size_of(axes)
                if size == 1:
                    continue
                if size == world:
                    self._groups[axes] = dist.group.WORLD
                elif len(axes) == 1:
                    self._groups[axes] = self.device_mesh.get_group(axes[0])
                else:
                    self._groups[axes] = \
                        self.device_mesh[axes]._flatten().get_group()

    def group(self, axes):
        """The process group along ``axes`` (a name or a tuple of names,
        in mesh order) holding this rank; ``comm.SELF`` where the group is
        this rank alone."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in key)
        if self._size_of(key) == 1:
            return SELF
        if self.device_mesh is None and comm.is_counting():
            return comm.CountedGroup(key, self._size_of(key))
        if self.device_mesh is None:
            raise RuntimeError(f"{self} is a shapes-only mesh: it has no "
                               f"process groups")
        if key not in self._groups:
            raise ValueError(f"{key} are not adjacent axes of {self}: JAX "
                             f"folds adjacent axes only")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production shapes, without process groups."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, build_groups=False)


def make_host_mesh(data: int = 1, model: int = 1,
                   pod: int = 0) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod > 0`` (the
    axis PowerSGD's cross-pod mean runs over), over the ranks of the
    initialised process group."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"))
    return Mesh((data, model), ("data", "model"))
