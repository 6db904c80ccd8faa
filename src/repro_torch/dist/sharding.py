"""Logical-axis sharding rules (counterpart of ``repro/dist/sharding.py``;
the rules are the port's own copy).

Model code and the calibration and compression paths name array dims by
*logical* names ("batch", "mlp", "group_batch", ...) and this module
resolves them against the active mesh (``launch.mesh.Mesh``): a logical
name maps to an ordered tuple of mesh axes; axes missing from the mesh
fold away, axes already consumed by an earlier dimension are skipped (the
first dim wins), and ``shape_aware_spec`` also drops axes, from the
right, whose combined size does not divide the dimension (8 kv heads on a
16-way model axis replicate instead of failing).

A spec is a :class:`P`, a tuple with one entry a dim: None (replicated),
an axis name, or a tuple of axis names (a folded group, row-major). The
port runs one process a rank, so a spec says which block of a tensor a
rank holds (``local_block``); nothing propagates shardings.
``constrain`` is a no-op: in JAX it only annotates an array for XLA's
partitioner and changes no value.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import pytree


class P(tuple):
    """A partition spec: ``P("data", None)``, as ``jax.sharding.
    PartitionSpec`` reads; as there, a one-axis tuple entry is that axis's
    name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# logical name -> ordered mesh axes (leftmost first; missing axes fold away)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "embed": ("data",),
    "seq": ("model",),
    "kv_seq": ("model",),
    "kv_seq_model": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "conv": (),
    "layer_stack": (),
    # leading axis of stacked same-shape compression-group batches (the
    # device decomposition): whole groups spread over the data axes;
    # replicated when the bucket does not divide
    "group_batch": ("pod", "data"),
    # streaming-calibration accumulators (core.capture's mesh path):
    # "calib_shard" stacks the per-shard whitening factors, tree-reduced
    # at finalize; "gram_rows" is the row dim of a sharded (D, D) Gram,
    # each rank holding a (D/n_shards, D) block (DESIGN.md §1.6)
    "calib_shard": ("pod", "data"),
    "gram_rows": ("pod", "data"),
}

_CTX = threading.local()


def _rules() -> Dict[str, Tuple[str, ...]]:
    return getattr(_CTX, "rules", DEFAULT_RULES)


def current_mesh():
    """The mesh pinned by the innermost ``use_rules``, else None."""
    return getattr(_CTX, "mesh", None)


class use_rules:
    """Context manager: overlay ``rules`` on the defaults and (optionally)
    pin the mesh that the model resolves against (``models.mlp`` runs its
    expert-parallel body under a mesh with a ``model`` axis)."""

    def __init__(self, rules: Optional[Dict] = None, mesh=None):
        self._rules = dict(DEFAULT_RULES)
        self._rules.update(rules or {})
        self._mesh = mesh

    def __enter__(self):
        self._prev = (getattr(_CTX, "rules", None),
                      getattr(_CTX, "mesh", None))
        _CTX.rules = self._rules
        _CTX.mesh = self._mesh
        return self

    def __exit__(self, *exc):
        rules, mesh = self._prev
        if rules is None:
            del _CTX.rules
        else:
            _CTX.rules = rules
        _CTX.mesh = mesh
        return False


def _mesh_axes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def _resolve(name: Optional[str], mesh_shape: Dict[str, int],
             used: set) -> Tuple[str, ...]:
    if name is None:
        return ()
    want = _rules().get(name, ())
    return tuple(a for a in want if a in mesh_shape and a not in used)


def _entry(axes: Tuple[str, ...]):
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return axes


def logical_spec(axes: Sequence[Optional[str]], mesh) -> P:
    """Resolve logical names to a spec (no shape checks)."""
    mesh_shape = _mesh_axes(mesh)
    used: set = set()
    entries = []
    for name in axes:
        got = _resolve(name, mesh_shape, used)
        used.update(got)
        entries.append(_entry(got))
    return P(*entries)


def shape_aware_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                     mesh) -> P:
    """Like ``logical_spec`` but drops (from the right) mesh axes whose
    combined size does not evenly divide the dim, so awkward shapes
    replicate. A divisibility-reduced composite keeps its tuple form, as
    in JAX (a one-axis tuple reads as that axis, as ``P`` reads it)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} against axes {tuple(axes)}")
    mesh_shape = _mesh_axes(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        resolved = _resolve(name, mesh_shape, used)
        got = resolved
        while got:
            total = 1
            for a in got:
                total *= mesh_shape[a]
            if dim % total == 0:
                break
            got = got[:-1]
        used.update(got)
        entries.append(got if got and got != resolved else _entry(got))
    return P(*entries)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """A no-op: JAX's ``with_sharding_constraint`` annotates and changes no
    value; a rank's tensors are already its blocks."""
    return x


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def axis_group_size(mesh, axes: Sequence[str]) -> int:
    """Total number of shards along a folded mesh-axis group."""
    size = 1
    for a in axes:
        size *= dict(mesh.shape)[a]
    return size


def combined_axis_index(axes: Sequence[str], mesh) -> int:
    """This rank's row-major index along a folded axis group (the block of
    a sharded-Gram accumulator a rank owns is ``index * block_rows``)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord(a)
    return idx


class NamedSharding:
    """A spec on a mesh: which block of a leaf each rank holds."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def shardings_for_tree(params, specs, mesh):
    """A tree of :class:`NamedSharding` for a (params, axis-name specs)
    tree pair, each spec made shape-aware. As ``jax.tree.map`` reads the
    pair, a spec is the whole subtree of ``specs`` at a leaf's path (a
    tuple of names)."""
    def spec_at(path):
        node = specs
        for kind, k in path:
            node = getattr(node, k) if kind == "name" else node[k]
        return node

    flat = pytree.flatten_with_path(params)
    return pytree.unflatten(params, [
        NamedSharding(mesh, shape_aware_spec(tuple(v.shape), spec_at(pth),
                                             mesh))
        for pth, v in flat])


def local_block(t: torch.Tensor, spec: Optional[Sequence], mesh
                ) -> torch.Tensor:
    """The block of ``t`` this rank holds under ``spec`` (None or an empty
    spec: all of it). Dim i is cut into as many blocks as its entry's
    axes have shards, and the rank takes the block at its row-major index
    along them."""
    if spec is None:
        return t
    out = t
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        n = axis_group_size(mesh, axes)
        size = out.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{n} ways over {axes}")
        blk = size // n
        out = out.narrow(dim, combined_axis_index(axes, mesh) * blk, blk)
    return out
