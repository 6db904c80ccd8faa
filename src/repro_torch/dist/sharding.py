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
rank holds (``local_block``, ``shard_tree``; ``gather_tree`` is the
inverse); nothing propagates shardings. ``constrain`` is a no-op: in JAX
it only annotates an array for XLA's partitioner and changes no value.
What JAX's partitioner derives from ``jit`` shardings for a train step,
the port writes out: :class:`Placement` gathers a rank's blocks on use
and reduces their gradients, and the model code computes on the shares
it keeps, each marked with a :class:`Share` (``models.transformer``);
where the rules lay "seq" over ``model`` the residual stream keeps the
rank's rows of each sequence (``Placement.seq_share``: sequence
parallelism). Serving reuses it: the prefill and decode step take a rank's blocks of
the parameters, its batch rows and its block of the cache, placed by
``CACHE_AXES`` (``shard_cache``; the K/V rows and ``cross_kv``'s encoder
rows split over ``model``, a :class:`SeqSplit`; a recurrent matrix
memory's heads where ``model`` divides them), as JAX's dry-run places
them (``lower_cell``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import pytree
from repro_torch.dist import comm


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


# ---------------------------------------------------------------------------
# Serving's inputs: the batch and the decode cache (JAX's dry-run places
# them so: ``repro/launch/dryrun.py`` ``batch_shardings``, ``CACHE_AXES``)
# ---------------------------------------------------------------------------
CACHE_AXES = {
    # kv cache (n, B, L, K, hd): batch over dp, cache seq over model
    5: ("layer_stack", "batch", "kv_seq_model", None, None),
    4: ("layer_stack", "batch", None, None),
    3: ("layer_stack", "batch", None),
    2: ("layer_stack", "batch"),
}


def cache_axes(t: torch.Tensor) -> tuple:
    """The logical axes of a cache leaf (JAX's ``cache_shardings``)."""
    nd = t.dim()
    if nd == 1:                       # pos (B,)
        return ("batch",)
    return CACHE_AXES.get(nd, ("layer_stack", "batch") + (None,) * (nd - 2))


def batch_axes(name: str, t: torch.Tensor) -> tuple:
    """The logical axes of a batch entry (JAX's ``batch_shardings``):
    rows over the batch axes, the sequence over ``model``."""
    if name == "positions" and t.dim() == 3:
        return (None, "batch", "seq")
    if t.dim() == 1:                  # lengths (B,)
        return ("batch",)
    return ("batch", "seq") + (None,) * (t.dim() - 2)


def cache_shardings(cache, mesh):
    """A :class:`NamedSharding` for every leaf of a decode cache under
    ``CACHE_AXES``, shape-aware: an ``L`` that ``model`` does not divide
    stays whole."""
    return pytree.tree_map(lambda t: NamedSharding(
        mesh, shape_aware_spec(tuple(t.shape), cache_axes(t), mesh)), cache)


def shard_cache(cache, mesh):
    """Every leaf of a whole decode cache's block on this rank under
    ``CACHE_AXES`` (``shard_tree``'s counterpart for the cache). Returns
    (blocks, the :class:`NamedSharding` tree)."""
    shardings = cache_shardings(cache, mesh)
    return pytree.tree_map(lambda t, s: local_block(t, s.spec, mesh).clone(),
                           cache, shardings), shardings


def shard_batch(batch: Dict, mesh):
    """This rank's block of every entry of a global batch under the
    rules (``batch_axes``, shape-aware: rows over the batch axes, the
    sequence over ``model``). Returns (blocks, {name:
    :class:`NamedSharding`})."""
    shardings = {k: NamedSharding(mesh, shape_aware_spec(
        tuple(v.shape), batch_axes(k, v), mesh)) for k, v in batch.items()}
    return {k: local_block(torch.as_tensor(v), shardings[k].spec,
                           mesh).clone()
            for k, v in batch.items()}, shardings


def batch_rows(blocks: Dict, shardings: Dict) -> Dict:
    """The batch rows a rank computes from its blocks (``shard_batch``):
    every dim split over ``model`` (the sequence) all-gathered over the
    model group, so each rank holds its rows' whole sequences, which the
    model's vocab-parallel embedding, rope angles and loss read (the
    residual stream then keeps the rank's rows: ``Placement.
    seq_share``)."""
    out = {}
    for k, t in blocks.items():
        sh = shardings[k]
        for dim, entry in enumerate(sh.spec):
            if _axes_of(entry) == ("model",):
                t = comm.all_gather(t, dim, sh.mesh.group(("model",)))
        out[k] = t
    return out


@dataclass(frozen=True)
class SeqSplit:
    """A decode cache's rows split over ``model``: this rank holds rows
    ``[offset, offset + rows)`` of each slot's ``length`` (the global
    ``L``); ``group`` is the model group."""
    group: Any
    offset: int
    rows: int
    length: int


# ---------------------------------------------------------------------------
# Sharded state: each rank holds its block of every leaf
# ---------------------------------------------------------------------------
# the mesh axes the batch is split over (the logical "batch"); a parameter
# block split over them is FSDP's, over "model" tensor or expert parallel
BATCH_AXES = ("pod", "data")


def shard_tree(tree, specs, mesh):
    """Every leaf's block on this rank, ``local_block`` under its
    shape-aware spec over all of the mesh's axes (an axis that does not
    divide a dim replicates it, as in JAX): the counterpart of
    ``jax.device_put(tree, shardings_for_tree(tree, specs, mesh))``. Each
    block is a copy in its own storage, so the whole leaf can be freed.
    Returns (blocks, the :class:`NamedSharding` tree)."""
    shardings = shardings_for_tree(tree, specs, mesh)
    blocks = pytree.tree_map(
        lambda t, s: local_block(t, s.spec, s.mesh).clone(), tree,
        shardings)
    return blocks, shardings


def gather_leaf(t: torch.Tensor, sharding) -> torch.Tensor:
    """A leaf whole from every rank's block ``t`` under ``sharding`` (a
    :class:`NamedSharding`): each sharded dim all-gathered over its axes'
    group, on ``t``'s device (a collective: every rank of the mesh calls
    it)."""
    for dim, entry in enumerate(sharding.spec):
        axes = _axes_of(entry)
        if axes:
            t = comm.all_gather(t, dim, sharding.mesh.group(axes))
    return t


def gather_tree(blocks, shardings):
    """The inverse of :func:`shard_tree`: every leaf whole on every rank
    (:func:`gather_leaf`)."""
    return pytree.tree_map(gather_leaf, blocks, shardings)


def _split_axes(spec) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
    return tuple((d, _axes_of(e)) for d, e in enumerate(spec) if e)


@dataclass(frozen=True)
class Share:
    """The mark :meth:`Placement.materialize` leaves, under the key
    ``"_tp"``, on what stays split over ``model`` for the model code to
    compute on its share (and, as "seq", a residual stream's rows of the
    sequence: ``Placement.seq_share``): ``kind`` is "col" (a linear's output columns:
    column-parallel), "row" (its input rows: row-parallel), "experts" (a
    layer's expert stacks: expert-parallel), "vocab" (the embedding's
    rows, the logits' columns), "inner" (a Mamba-2 or mLSTM sub-block
    whose ``ssm_inner`` leaves, its depthwise ``conv`` among them, stay
    split) or "whole" (such a sub-block gathered whole because it holds a
    factorized linear; the mark carries the group its state is split
    over); ``group`` is the model group, ``index`` this rank's coordinate
    in it and ``size`` its size."""
    kind: str
    group: Any
    index: int
    size: int

    def splits(self, heads: int) -> bool:
        """Whether ``heads`` fall on the split: each rank holds whole heads
        (case A: the rank computes its heads end to end), rather than a
        split that cuts a head (case B: the head-wise core runs whole on
        every rank). The cache rules split a state's heads in case A
        only (``CACHE_AXES``, shape-aware)."""
        return heads % self.size == 0

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` entries split evenly over the
        group."""
        b = n // self.size
        return slice(self.index * b, (self.index + 1) * b)


def share_of(p: Dict, kind: str) -> Optional[Share]:
    """``p``'s :class:`Share` if it is of ``kind``, else None."""
    s = p.get("_tp")
    return s if s is not None and s.kind == kind else None


def _has_factorized(node) -> bool:
    return isinstance(node, dict) and (("B" in node and "C" in node) or any(
        _has_factorized(v) for v in node.values()))


class Placement:
    """A model's parameters sharded over a mesh for a train step or for
    serving (FSDP and tensor, vocab and expert parallelism), as JAX's
    ``jit`` shardings place them: ``specs`` is the tree of every
    parameter's shape-aware :class:`P` (``shardings_for_tree`` on the
    whole parameters; their blocks are what a rank holds). ``cache_len``
    is the full decode cache's global ``L`` (``max_len``), which a decode
    step under the placement needs to find its block (``seq_split``), and
    ``enc_len`` an encoder-decoder cache's global encoder rows ``T``, whose
    ``cross_kv`` rows split the same way.

    On use (``models.transformer``'s ``placement=``), a block is gathered
    over the axes of the batch (``pod``, ``data``: FSDP) with
    ``comm.gather``, whose backward reduce-scatters its gradient back to
    the block; a dim split over ``model`` stays split where the model code
    computes on its share (``keep_model``; marked with a :class:`Share`),
    and is otherwise gathered with ``comm.gather_replicated``. A leaf that no batch axis splits has its
    gradient summed over those axes afterwards (:meth:`reduce_grads`)."""

    def __init__(self, mesh, specs, cache_len: Optional[int] = None,
                 enc_len: Optional[int] = None):
        self.mesh, self.specs, self.cache_len = mesh, specs, cache_len
        self.enc_len = enc_len
        self.batch_axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
        self.model_size = mesh.shape.get("model", 1)
        self.model_index = mesh.coord("model") if self.model_size > 1 else 0
        self.batch_size = axis_group_size(mesh, self.batch_axes)
        self.batch_index = combined_axis_index(self.batch_axes, mesh)

    @property
    def model_group(self):
        return (self.mesh.group("model") if "model" in self.mesh.axis_names
                else comm.SELF)

    def share(self, kind: str) -> Share:
        return Share(kind, self.model_group, self.model_index,
                     self.model_size)

    def vocab_share(self) -> Optional[Share]:
        """The "vocab" :class:`Share` where the embedding's rows split over
        ``model``, else None."""
        split = any(axes == ("model",)
                    for _, axes in _split_axes(self.spec_at("embed")))
        return self.share("vocab") if split else None

    @property
    def batch_group(self):
        return (self.mesh.group(self.batch_axes) if self.batch_size > 1
                else comm.SELF)

    def seq_split(self, length: int) -> Optional[SeqSplit]:
        """This rank's block of a cache of ``length`` rows a slot where
        the rules split it over ``model`` (``CACHE_AXES``' "kv_seq_model",
        shape-aware: None where ``model`` does not divide it, and the
        cache stays whole): a K/V cache's rows, or ``cross_kv``'s encoder
        rows."""
        spec = shape_aware_spec((length,), ("kv_seq_model",), self.mesh)
        if self.model_size == 1 or _axes_of(spec[0]) != ("model",):
            return None
        rows = length // self.model_size
        return SeqSplit(self.model_group, self.model_index * rows, rows,
                        length)

    def seq_share(self, length: int) -> Optional[Share]:
        """The "seq" :class:`Share` of a residual stream of ``length``
        rows a sequence where the rules lay the sequence over ``model``
        (JAX's ``constrain(x, "batch", "seq", None)``, shape-aware: None
        where ``model`` does not divide it, at ``model`` 1, or under
        ``use_rules({"seq": ()})``): each rank then holds rows
        ``block(length)`` of every sequence between sub-blocks (sequence
        parallelism, ``models.transformer``). Read in the caller's thread:
        the rules are thread-local."""
        spec = shape_aware_spec((length,), ("seq",), self.mesh)
        if self.model_size == 1 or _axes_of(spec[0]) != ("model",):
            return None
        return self.share("seq")

    def spec_at(self, *keys):
        node = self.specs
        for k in keys:
            node = node[k]
        return node

    def use(self, t: torch.Tensor, spec, keep_model: bool = False
            ) -> torch.Tensor:
        """The tensor a step computes with from this rank's block ``t``
        under ``spec``: whole over the batch axes, and over ``model``
        unless ``keep_model``."""
        for dim, axes in _split_axes(spec):
            if all(a in self.batch_axes for a in axes):
                t = comm.gather(t, dim, self.mesh.group(axes))
            elif axes == ("model",):
                if not keep_model:
                    t = comm.gather_replicated(t, dim, self.model_group,
                                               self.model_index)
            else:
                raise NotImplementedError(
                    f"a dim split over {axes}: the batch axes and model "
                    f"in one entry")
        return t

    def materialize(self, tree, specs, keep_model=lambda path: False):
        """:meth:`use` over a layer's tree (``specs`` its spec tree;
        ``keep_model(path)`` for a leaf's path of dict keys). What stays
        split over ``model`` is marked for the model code with a
        :class:`Share` under ``"_tp"``: a linear (its ``w``) "col" where its
        output columns split, "row" where its input rows do; a dict of
        stacks (the experts') "experts", and a recurrent sub-block (a dict
        with a split ``conv``) "inner". A factorized linear (``B``, ``C``)
        is always gathered whole: the low-rank kernels round ``x@B`` to C's
        dtype before ``@C``, so a share of B's rows would round partial
        sums that one process rounds whole, and it never reaches the model
        code as an unmarked share. A recurrent sub-block that holds one is
        gathered whole with it and marked "whole"."""
        def model_split(spec) -> list:
            return [d for d, axes in _split_axes(spec) if axes == ("model",)]

        def walk(node, spec, path):
            if isinstance(node, dict):
                held = [k for k, v in node.items()
                        if isinstance(v, (torch.Tensor, dict))]
                if any(k not in spec for k in held):
                    raise KeyError(
                        f"{'/'.join(path) or 'the tree'}: no spec for "
                        f"{[k for k in held if k not in spec]} (place a "
                        f"factorized model by its own specs)")
            if isinstance(node, dict) and "B" in node and "C" in node:
                return {k: self.use(v, spec[k]) if isinstance(
                    v, torch.Tensor) else v for k, v in node.items()}
            if isinstance(node, dict):
                stacks = "w" not in node and any(
                    isinstance(v, torch.Tensor) and k in spec
                    and keep_model(path + (k,)) and model_split(spec[k])
                    for k, v in node.items())
                if stacks and "conv" in node and _has_factorized(node):
                    out = self.materialize(node, spec)
                    out["_tp"] = self.share("whole")
                    return out
                out = {k: walk(v, spec[k], path + (k,)) if k in spec else v
                       for k, v in node.items()}
                w = spec.get("w") if "w" in node else None
                if w is not None and keep_model(path + ("w",)):
                    split = model_split(w)
                    if split:
                        out["_tp"] = self.share(
                            "col" if split[0] == len(w) - 1 else "row")
                elif stacks:
                    out["_tp"] = self.share("inner" if "conv" in node
                                            else "experts")
                return out
            if isinstance(node, torch.Tensor):
                return self.use(node, spec, keep_model(path))
            return node
        return walk(tree, specs, ())

    def _missing(self, spec) -> Tuple[str, ...]:
        held = {a for _, axes in _split_axes(spec) for a in axes}
        return tuple(a for a in self.batch_axes
                     if a not in held and self.mesh.shape[a] > 1)

    def reduce_grads(self, grads):
        """Each gradient block summed over the batch axes its leaf is not
        split over (the FSDP gathers' backward summed over the others), in
        one flat float32 bucket per group."""
        flat = pytree.flatten_with_path(grads)
        specs = [self.spec_at(*(k for _, k in p)) for p, _ in flat]
        out = [g for _, g in flat]
        by_axes: Dict[Tuple[str, ...], list] = {}
        for i, s in enumerate(specs):
            miss = self._missing(s)
            if miss:
                by_axes.setdefault(miss, []).append(i)
        for axes, idx in by_axes.items():
            bucket = torch.cat([out[i].reshape(-1).to(torch.float32)
                                for i in idx])
            bucket = comm.all_reduce_sum(bucket, self.mesh.group(axes))
            off = 0
            for i in idx:
                n = out[i].numel()
                out[i] = bucket[off:off + n].reshape(out[i].shape).to(
                    out[i].dtype)
                off += n
        return pytree.unflatten(grads, out)

    def counts_once(self, spec) -> bool:
        """Whether this rank's block of a leaf enters a sum over the whole
        mesh: a leaf replicated over an axis counts at coordinate 0 of that
        axis only."""
        held = {a for _, axes in _split_axes(spec) for a in axes}
        return all(self.mesh.coord(a) == 0 for a in self.mesh.axis_names
                   if a not in held and self.mesh.shape[a] > 1)

    def global_norm(self, grads) -> torch.Tensor:
        """The global norm of the whole gradient from every rank's blocks:
        the squares of the blocks that count once (:meth:`counts_once`),
        summed over the world."""
        flat = pytree.flatten_with_path(grads)
        sq = [torch.sum(g.to(torch.float32) ** 2) for p, g in flat
              if self.counts_once(self.spec_at(*(k for _, k in p)))]
        total = (torch.stack(sq).sum() if sq else
                 torch.zeros((), device=flat[0][1].device))
        return torch.sqrt(comm.all_reduce_sum(
            total, self.mesh.group(self.mesh.axis_names)))
