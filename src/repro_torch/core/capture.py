"""Calibration capture: per-linear input-activation statistics (counterpart
of ``repro/core/capture.py``).

The compression pipeline needs, for every compressible weight matrix
``W (d_in, d_out)``, the Gram matrix of its calibration inputs
``G = Σ_batches XᵀX`` in float64 (the paper keeps the whitening matrix S in
fp64) plus the mean-|X| vector (ASVD's scaling).

Mechanism: model parameters are converted to *list form* (stacked layer runs
→ per-layer trees), every linear's param dict gets a ``"_tag"`` string key,
and ``apply_linear`` reports ``(tag, x)`` to the active capture target
(``repro_torch.models.params.set_capture``). Two targets exist:

  Collector        the eager fp64 oracle: a plain float64 product per call on
                   the activation's device, outside any kernel, exactly as
                   the JAX package computes it outside Pallas.
  StreamingTape +  the streaming capture: every tagged activation is
  StreamingCalibrator  reduced to float32 statistics on the card as the
                   forward pass runs, the Gram through the ``gram_blocked``
                   kernel (``kernels.ops.gram``), added in place into
                   float32 accumulators; every ``flush_every`` batches the
                   host folds them into float64 sums and zeroes them
                   (DESIGN.md §7: float32 partials and an fp64 host sum keep
                   the paper's fp64 S matrix). ``whiten_tags`` keeps an
                   upper-triangular factor ``R`` (``RᵀR = G``) per tag by QR
                   updates instead of a Gram.

MoE routed experts are captured separately: the dispatch buffers
``(E, capacity, d)`` that feed the per-expert products are reported by
``repro_torch.models.mlp._expert_ffn`` through ``add_expert_batch`` under
``tag/in`` and ``tag/mid``, one statistic ``tag/in/expert{e}`` per expert.
A buffer's empty rows are zeros and are counted, as in JAX: an expert's
``count`` is the capacity times the batches, and its Gram and Σ|x| are
those of the rows it received.

The JAX package traces the streaming step under ``jax.jit`` and threads
donated accumulators through it; the port runs the same forward pass
eagerly under ``torch.no_grad()`` and adds into the accumulators in place.
On a mesh (``launch.mesh.Mesh``, one process a rank) each rank captures its
rows of every batch and the statistics meet through ``dist.comm``
(DESIGN.md §1.6; see ``StreamingCalibrator``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import numerics_device as numd
from repro_torch.dist import comm
from repro_torch.dist.sharding import (axis_group_size, combined_axis_index,
                                       logical_spec)
from repro_torch.kernels import ops as kops
from repro_torch.models.params import Params, set_capture
from repro_torch.models.transformer import encoder_config, tree_index
from repro_torch.obs import trace


class Collector:
    """Accumulates XᵀX (fp64) and Σ|x| per tag on the activations' device;
    leaving the ``with`` block moves the sums to the host as numpy float64
    (``gram``, ``absmean``, ``count``), the form the compression step
    reads. ``chol`` holds the streaming-whitening factors (upper-triangular
    R with RᵀR ≈ G) of tags captured with
    ``StreamingCalibrator(whiten_tags=...)``; those tags have no Gram."""

    def __init__(self):
        self.gram: Dict[str, np.ndarray] = {}
        self.absmean: Dict[str, np.ndarray] = {}
        self.count: Dict[str, int] = {}
        self.chol: Dict[str, np.ndarray] = {}
        self._acc: Dict[str, Dict[str, torch.Tensor]] = {}

    def add(self, tag: str, x: torch.Tensor) -> None:
        x2 = x.detach().reshape(-1, x.shape[-1]).double()
        g = x2.T @ x2
        a = x2.abs().sum(0)
        acc = self._acc.get(tag)
        if acc is None:
            self._acc[tag] = {"gram": g, "absx": a}
            self.count[tag] = x2.shape[0]
        else:
            acc["gram"] += g
            acc["absx"] += a
            self.count[tag] += x2.shape[0]

    def add_expert_batch(self, tag: str, xs: torch.Tensor) -> None:
        """xs: (E, capacity, d) dispatch buffers: one Gram per expert."""
        for e in range(xs.shape[0]):
            self.add(f"{tag}/expert{e}", xs[e])

    def to_host(self) -> None:
        """Move the device sums into the numpy dicts."""
        for tag, acc in self._acc.items():
            self.gram[tag] = acc["gram"].cpu().numpy()
            self.absmean[tag] = acc["absx"].cpu().numpy()
        self._acc = {}

    def mean_abs(self, tag: str) -> np.ndarray:
        return self.absmean[tag] / max(1, self.count[tag])

    def __enter__(self):
        set_capture(self)
        return self

    def __exit__(self, *exc):
        set_capture(None)
        self.to_host()
        return False


# ---------------------------------------------------------------------------
# Streaming (device) capture
# ---------------------------------------------------------------------------
class StreamingTape:
    """Capture target of the streaming calibrator: reduces every tagged
    activation to float32 statistics on its device while the forward pass
    runs. ``partials`` maps tag -> {"gram", "absx", "count"}; pass the
    calibrator's accumulators as ``partials`` and the statistics are added
    into them in place (the fold of the JAX step), otherwise zeroed
    partials are made per tag. Tags selected by ``whiten``, and the tags in
    ``raw``, keep their raw float32 row blocks in ``xblocks`` instead of a
    Gram: they feed the QR update of the whitening factor, or (on a mesh)
    the row-block fold of a sharded Gram.

    Grams go through ``kernels.ops.gram``: the ``gram_blocked`` kernel on a
    CUDA device, its plain version on a CPU or meta tensor."""

    def __init__(self, whiten=None,
                 partials: Optional[Dict[str, Dict]] = None, raw=None):
        self.whiten = whiten            # True (all tags) or a set of tags
        self.raw = raw or frozenset()
        self.partials: Dict[str, Dict] = ({} if partials is None
                                          else partials)
        self.xblocks: Dict[str, list] = {}

    def add(self, tag: str, x: torch.Tensor) -> None:
        x2 = x.detach().reshape(-1, x.shape[-1])
        d = x2.shape[1]
        part = self.partials.get(tag)
        if part is None:
            part = self.partials[tag] = _zero_entry(
                d, _tag_whitened(self.whiten, tag), x2.device)
        part["absx"] += x2.abs().sum(0, dtype=torch.float32)
        part["count"] += x2.shape[0]
        if _tag_whitened(self.whiten, tag) or tag in self.raw:
            self.xblocks.setdefault(tag, []).append(x2.float())
        else:
            kops.gram(x2, out=part["gram"])

    def add_expert_batch(self, tag: str, xs: torch.Tensor) -> None:
        """xs: (E, capacity, d) dispatch buffers: one Gram per expert."""
        for e in range(xs.shape[0]):
            self.add(f"{tag}/expert{e}", xs[e])

    def __enter__(self):
        set_capture(self)
        return self

    def __exit__(self, *exc):
        set_capture(None)
        return False


def _tag_whitened(whiten, tag: str) -> bool:
    """Shared predicate: ``whiten`` is True (all tags), a collection of
    tags, or None/falsy (off)."""
    return whiten is True or (whiten is not None and tag in whiten)


def _zero_entry(d: int, whitened: bool, device) -> Dict:
    stat = "chol" if whitened else "gram"
    return {stat: torch.zeros((d, d), dtype=torch.float32, device=device),
            "absx": torch.zeros((d,), dtype=torch.float32, device=device),
            "count": 0}


class _ShapeProbe:
    """Capture target for tag/dim discovery over a meta-device forward."""

    def __init__(self):
        self.dims: Dict[str, int] = {}

    def add(self, tag: str, x) -> None:
        self.dims[tag] = int(x.shape[-1])

    def add_expert_batch(self, tag: str, xs) -> None:
        for e in range(xs.shape[0]):
            self.dims[f"{tag}/expert{e}"] = int(xs.shape[-1])


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    return tree


def discover_capture_dims(tagged: Params, cfg: ModelConfig,
                          batch: Dict) -> Dict[str, int]:
    """Enumerate every capture tag and its feature dim without running the
    model: one forward pass over meta tensors (shapes only), the port's
    ``jax.eval_shape``."""
    from repro_torch.models import transformer as T
    probe = _ShapeProbe()
    set_capture(probe)
    try:
        with torch.no_grad():
            T.forward(_to_meta(tagged), cfg, _to_meta(
                {k: torch.as_tensor(v) for k, v in batch.items()}))
    finally:
        set_capture(None)
    return probe.dims


class StreamingCalibrator:
    """Device-side calibration capture (DESIGN.md §1.3, §1.6).

    Each ``ingest`` runs the forward pass on the card and adds every tag's
    float32 statistics into its accumulators in place (the Gram through the
    ``gram_blocked`` kernel). Every ``flush_every`` batches the float32
    accumulators are pulled to the host, added into float64 sums and
    zeroed, bounding float32 accumulation error while keeping the
    per-batch path free of host transfers.

    ``whiten_tags`` (True = every tag, or a collection of tags) enables
    STREAMING WHITENING for those tags: instead of a Gram, the calibrator
    keeps the upper-triangular Cholesky factor of the running Gram,
    ``R' = qr_r([R; X_batch])``, a QR update on the raw float32 rows. The
    Gram of a whitened tag never exists; ``finalize`` exposes the factor as
    ``Collector.chol[tag]``, which both the host whitener
    (``numerics.whitener_from_factor``) and the device decomposition
    (``numerics_device.decompose(factor=...)``) take as it is. Factors are
    never flushed: orthogonal updates do not square the condition number.

    On a mesh (``mesh=``, a ``launch.mesh.Mesh`` over the process group;
    JAX's ``shard_map`` steps) every rank runs this same program: it
    captures its rows of each batch (JAX's ``P(data_axes)`` split of the
    batch dim: rank index ``i`` along the folded data axes takes rows
    ``i·b/n .. (i+1)·b/n``) and each tag's accumulator takes a route:

      replicated  a (D, D) float32 Gram on every rank: the rank's partial
                  from the ``gram_blocked`` kernel, summed over the data
                  axes (``comm.all_reduce_sum``, JAX's ``psum``) when it
                  is flushed. The default for small D.
      sharded     ``D >= shard_grams_above`` (and divisible): each rank
                  holds a (D/n, D) row block and adds
                  ``X[:, off:off+D/n]ᵀ X`` of the all-gathered rows every
                  batch (``off`` = its index along the "gram_rows" axes
                  times D/n), a float32 ``torch.matmul`` as JAX's
                  ``dot_general`` outside Pallas. No rank ever holds a
                  (D, D) tensor for such a tag on the device; a flush
                  gathers the blocks into the host's float64 Gram, as
                  JAX's ``device_get`` does.
      whiten      each rank QR-updates its own factor over its rows;
                  ``finalize`` gathers the per-shard factors and merges
                  them with ``numerics_device.tree_reduce_factors``
                  (float64 on the host; exact: RᵀR = Σ_s R_sᵀR_s).

    Σ|x| and the row counts are summed over the data axes at each flush.
    ``finalize`` returns the same Collector on every rank.

    Example (on the CPU; the card is the default device of the model)::

        >>> from repro_torch.configs import get_config
        >>> from repro_torch.core.capture import (StreamingCalibrator,
        ...                                       to_list_params)
        >>> from repro_torch.models import transformer as T
        >>> import torch
        >>> cfg = get_config("llama-mini").replace(
        ...     n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        ...     head_dim=16, d_ff=64, vocab_size=128)
        >>> params, _ = T.init_model(cfg, seed=0, device="cpu")
        >>> cal = StreamingCalibrator(to_list_params(params, cfg), cfg)
        >>> for i in range(2):
        ...     cal.ingest({"tokens": torch.randint(0, 128, (2, 16))})
        >>> col = cal.finalize()
        >>> sorted(col.gram)[0], col.count[sorted(col.gram)[0]]
        ('decoder/run0/0/attn/wk', 64)
    """

    def __init__(self, list_params: Params, cfg: ModelConfig, *,
                 mesh=None, data_axes=("pod", "data"), flush_every: int = 8,
                 whiten_tags=None, shard_grams_above: int = 4096):
        self.cfg = cfg
        self.tagged = tag_linears(list_params)
        self.mesh = mesh
        self.flush_every = max(1, flush_every)
        self.shard_grams_above = shard_grams_above
        if whiten_tags is True:
            self.whiten = True
        elif whiten_tags:
            self.whiten = frozenset(whiten_tags)
        else:
            self.whiten = None
        self._dims: Optional[Dict[str, int]] = None
        self._routes: Dict[str, str] = {}
        self._accs: Optional[Dict[str, Dict]] = None
        self._since_flush = 0
        self._host: Dict[str, Dict] = {}
        if mesh is not None:
            axes = tuple(a for a in data_axes if a in mesh.axis_names)
            if not axes:
                raise ValueError(
                    f"mesh axes {mesh.axis_names} share nothing with "
                    f"data_axes {data_axes}")
            self.data_axes = axes
            self.n_shards = axis_group_size(mesh, axes)
            # accumulator layouts resolve through the logical rules: the
            # gram rows must shard a SUBSET of the data axes and the
            # factor stack must match them exactly (the fold rides the
            # batch split)
            self.row_axes = tuple(
                a for a in _spec_axes(logical_spec(("gram_rows",), mesh))
                if a in axes)
            stack = _spec_axes(logical_spec(("calib_shard",), mesh))
            if tuple(a for a in stack if a in axes) != axes:
                raise ValueError(
                    f"calib_shard rule {stack} must cover the capture "
                    f"data axes {axes}: each data shard QR-updates its "
                    f"own factor over its slice of the batch")
            self.shard_index = combined_axis_index(axes, mesh)
            self.data_group = mesh.group(axes)
            self.row_group = mesh.group(self.row_axes)
        else:
            self.data_axes = ()
            self.n_shards = 1
            self.row_axes = ()

    # -- routing ------------------------------------------------------------
    def _route_of(self, tag: str, d: int) -> str:
        if _tag_whitened(self.whiten, tag):
            return "whiten"
        if (self.mesh is not None and self.shard_grams_above
                and self.row_axes
                and d >= self.shard_grams_above
                and d % axis_group_size(self.mesh, self.row_axes) == 0):
            return "sharded"
        return "replicated"

    @property
    def routes(self) -> Dict[str, str]:
        """tag -> accumulator route ('whiten' | 'sharded' | 'replicated');
        populated after the first ``ingest``."""
        return dict(self._routes)

    @property
    def accumulators(self) -> Dict[str, Dict]:
        """This rank's float32 accumulators (a sharded tag's "gram" is its
        (D/n, D) row block)."""
        return self._accs or {}

    def _local_rows(self, batch: Dict) -> Dict:
        """This rank's rows of ``batch`` (dim 0 of every field)."""
        if self.mesh is None:
            return batch
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if v.shape[0] % self.n_shards:
                raise ValueError(
                    f"calibration batch field {k!r} of {v.shape[0]} rows "
                    f"does not split over {self.n_shards} data shards")
            b = v.shape[0] // self.n_shards
            out[k] = v[self.shard_index * b:(self.shard_index + 1) * b]
        return out

    def _fresh(self, tag: str, d: int, dev) -> Dict:
        route = self._routes[tag]
        rows = d
        if route == "sharded":
            rows = d // axis_group_size(self.mesh, self.row_axes)
        stat = "chol" if route == "whiten" else "gram"
        return {stat: torch.zeros((rows, d), dtype=torch.float32,
                                  device=dev),
                "absx": torch.zeros((d,), dtype=torch.float32, device=dev),
                "count": 0}

    def ingest(self, batch: Dict) -> None:
        """Fold one calibration batch into the device accumulators."""
        with trace.span("calib_ingest", since_flush=self._since_flush):
            batch = self._local_rows(batch)
            if self._accs is None:
                self._dims = discover_capture_dims(self.tagged, self.cfg,
                                                   batch)
                self._routes = {t: self._route_of(t, d)
                                for t, d in self._dims.items()}
                dev = self.tagged["embed"].device
                self._accs = {t: self._fresh(t, d, dev)
                              for t, d in self._dims.items()}
            from repro_torch.models import transformer as T
            raw = frozenset(t for t, r in self._routes.items()
                            if r == "sharded")
            tape = StreamingTape(whiten=self.whiten, partials=self._accs,
                                 raw=raw)
            with torch.no_grad(), tape:
                T.forward(self.tagged, self.cfg, batch)
                for tag, blocks in tape.xblocks.items():
                    acc = self._accs[tag]
                    if self._routes[tag] == "whiten":
                        acc["chol"] = torch.linalg.qr(torch.cat(
                            [acc["chol"], *blocks], dim=0), mode="r")[1]
                    else:
                        self._fold_rows(acc, torch.cat(blocks, dim=0))
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self.flush()

    def _fold_rows(self, acc: Dict, x: torch.Tensor) -> None:
        """A sharded Gram's row block: ``X[:, off:off+blk]ᵀ X`` of the rows
        of every data shard, in float32."""
        xa = comm.all_gather_rows(x, self.data_group)
        blk = acc["gram"].shape[0]
        off = combined_axis_index(self.row_axes, self.mesh) * blk
        acc["gram"] += torch.matmul(xa[:, off:off + blk].T, xa)

    def flush(self) -> None:
        """Pull the float32 accumulators to the host, fold them into
        float64, zero them. Whitening factors stay on the device."""
        if self._accs is None or self._since_flush == 0:
            return
        with trace.span("calib_flush", batches=self._since_flush):
            self._flush_inner()

    def _flush_inner(self) -> None:
        tags = list(self._accs)
        if self.mesh is not None:
            counts = comm.all_reduce_ints(
                [self._accs[t]["count"] for t in tags], self.data_group)
            absx = comm.all_reduce_sum(torch.cat(
                [self._accs[t]["absx"] for t in tags]), self.data_group)
            absx = absx.split([self._dims[t] for t in tags])
        else:
            counts = [self._accs[t]["count"] for t in tags]
            absx = [self._accs[t]["absx"] for t in tags]
        for i, tag in enumerate(tags):
            acc = self._accs[tag]
            new = {"absx": absx[i].cpu().double().numpy(),
                   "count": counts[i]}
            if "gram" in acc:
                new["gram"] = self._host_gram(tag, acc["gram"])
            host = self._host.get(tag)
            if host is None:
                self._host[tag] = new
            else:
                for k, v in new.items():
                    host[k] += v
            for k in ("absx", "gram"):
                if k in acc:
                    acc[k].zero_()
            acc["count"] = 0
        self._since_flush = 0

    def _host_gram(self, tag: str, g: torch.Tensor) -> np.ndarray:
        """The tag's whole float32 Gram since the last flush, as float64 on
        the host: this rank's own, summed over the data shards, or the
        sharded row blocks gathered one at a time."""
        route = self._routes[tag]
        if self.mesh is None:
            return g.cpu().double().numpy()
        if route == "sharded":
            blocks = comm.gather_rows_to_host(g, self.row_group)
            return torch.cat(blocks, dim=0).double().numpy()
        return comm.all_reduce_sum(g, self.data_group).cpu().double().numpy()

    def sync(self) -> None:
        """Block until the in-flight device work is done (benchmarking /
        completion barrier)."""
        if self._accs is not None:
            dev = self.tagged["embed"].device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def finalize(self) -> Collector:
        """Return the fp64 host-side statistics as a Collector (drop-in for
        the compression driver). Whitened tags expose their running
        Cholesky factor as ``col.chol[tag]`` and have no Gram entry; on a
        mesh the per-shard factors are tree-reduced first."""
        with trace.span("calib_finalize"):
            return self._finalize_inner()

    def _finalize_inner(self) -> Collector:
        self.flush()
        col = Collector()
        for tag, acc in self._host.items():
            if "gram" in acc:
                col.gram[tag] = acc["gram"]
            col.absmean[tag] = acc["absx"]
            col.count[tag] = acc["count"]
        for tag, acc in (self._accs or {}).items():
            if "chol" not in acc:
                continue
            if self.mesh is None:
                col.chol[tag] = acc["chol"].cpu().double().numpy()
            else:
                Rs = torch.stack(comm.gather_rows_to_host(
                    acc["chol"], self.data_group))
                col.chol[tag] = numd.tree_reduce_factors(Rs).numpy()
        return col


def _spec_axes(spec) -> tuple:
    """The mesh axes a one-entry spec resolves to (a name, a tuple or
    None)."""
    entry = spec[0] if len(spec) else None
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def streaming_calibrate(list_params: Params, cfg: ModelConfig,
                        batches: Iterable[Dict], *, mesh=None,
                        flush_every: int = 8,
                        whiten_tags=None,
                        shard_grams_above: int = 4096) -> Collector:
    """Run the device-side streaming capture over ``batches`` and return the
    finalized fp64 Collector (see ``StreamingCalibrator`` for the mesh,
    whitening and sharded-accumulator knobs)."""
    cal = StreamingCalibrator(list_params, cfg, mesh=mesh,
                              flush_every=flush_every,
                              whiten_tags=whiten_tags,
                              shard_grams_above=shard_grams_above)
    for batch in batches:
        cal.ingest(batch)
    return cal.finalize()


# ---------------------------------------------------------------------------
# List-form params + tagging
# ---------------------------------------------------------------------------
def _is_linear(d) -> bool:
    return isinstance(d, dict) and ("w" in d or ("B" in d and "C" in d))


def _stacks(cfg: ModelConfig):
    """(subtree name, its layer runs): the decoder's and, for an
    encoder-decoder model, the encoder's."""
    out = [("decoder", cfg.layer_runs())]
    if cfg.is_encoder_decoder:
        out.append(("encoder", encoder_config(cfg).layer_runs()))
    return out


def to_list_params(params: Params, cfg: ModelConfig) -> Params:
    """Stacked layer runs -> lists of per-layer trees (views of the stacked
    tensors), in the decoder and the encoder. Already-list runs pass
    through. Non-run subtrees are kept."""
    out = dict(params)
    for name, runs in _stacks(cfg):
        new = dict(params[name])
        for r, (_kind, n) in enumerate(runs):
            rp = new[f"run{r}"]
            new[f"run{r}"] = rp if isinstance(rp, list) else [
                tree_index(rp, i) for i in range(n)]
        out[name] = new
    return out


def to_stacked_params(list_params: Params, cfg: ModelConfig) -> Params:
    """Inverse of ``to_list_params`` (only valid if per-layer trees have
    identical leaf shapes — i.e. uncompressed or rank-padded)."""

    def stack(*trees):
        t0 = trees[0]
        if isinstance(t0, dict):
            return {k: stack(*(t[k] for t in trees)) for k in t0}
        if isinstance(t0, torch.Tensor):
            return torch.stack(trees)
        return t0

    out = dict(list_params)
    for name, runs in _stacks(cfg):
        new = dict(list_params[name])
        for r, _ in enumerate(runs):
            rp = new[f"run{r}"]
            if isinstance(rp, list):
                new[f"run{r}"] = stack(*rp)
        out[name] = new
    return out


def tag_linears(list_params: Params) -> Params:
    """Returns a shallow-copied tree where every linear dict carries its
    path as ``"_tag"`` (and MoE subtrees carry a dispatch tag)."""

    def walk(node, path):
        if _is_linear(node):
            d = dict(node)
            d["_tag"] = "/".join(map(str, path))
            return d
        if isinstance(node, dict):
            d = {k: walk(v, path + (k,)) for k, v in node.items()}
            if "w_gate" in node and "router" in node:   # routed-expert subtree
                d["_tag"] = "/".join(map(str, path))
            return d
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return node

    return walk(list_params, ())


def strip_tags(params: Params) -> Params:
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items() if k != "_tag"}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
