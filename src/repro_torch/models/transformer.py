"""Model assembly: embeddings, kind-run layer stacks, final norm, LM head;
full-sequence forward and loss, cached decode step and prefill
(counterpart of ``repro/models/transformer.py``).

A model is a sequence of layer *runs* — consecutive layers of the same kind
(see ``ModelConfig.layer_kinds``). A run's parameters are either stacked
along a leading axis (the form ``init_model`` builds) or a *list* of
per-layer trees — the deploy form of a D-Rank-compressed model whose
per-layer ranks differ. PyTorch runs eagerly, so both forms execute as a
Python loop over layers; a stacked run is indexed layer by layer (views, no
copies). Where the JAX package scans a stacked run (``cfg.scan_layers``),
``cfg.remat`` rematerializes each layer in the backward pass
(``torch.utils.checkpoint``); list-form and unrolled runs never are, as in
JAX.

This port serves decoder-only models of every layer kind the JAX package
has: ``attn`` and ``swa`` with a dense FFN or a Mixture-of-Experts layer
(``models.mlp.apply_moe``, expert parallelism 1); Hymba's ``hymba`` and
``hymba_g`` (attention and a Mamba-2 head in parallel, ``models.mamba``);
xLSTM's ``mlstm`` and ``slstm`` (``models.ssm``); and the
encoder-decoder wiring of seamless-m4t (``encode``: a non-causal encoder
stack over ``enc_embeds``, the audio stub, with sinusoidal positions on
both sides; a ``cross`` block in every decoder layer) and Qwen2-VL's
M-RoPE (``rotary.mrope_angles`` over (3, B, S) positions, with ``embeds``,
the vision stub, in place of token embeddings). The cache is the
contiguous per-slot pool (``init_cache``): k/v per attention layer, the
recurrent state of the other kinds and, for an encoder-decoder model, each
layer's read-only cross K/V (``cross_kv``), every leaf stacked per run and
updated in place by ``decode_step``. Pure-attention decoders also have the
paged block arena (``init_cache_paged``, read through a block table in
``decode_step(table=)`` and ``prefill_ext``); recurrent kinds and
encoder-decoder models have no paged layout, in JAX as here.

Under a ``dist.sharding.Placement`` (``placement=``; the sharded train
step) ``forward`` and ``lm_loss`` take a rank's blocks of the parameters:
a stacked run gathers one layer's at a time on use, the embedding, the
logits and the loss are vocab-parallel where the vocab splits over
``model``, and the attention, MLP, experts and the recurrent sub-blocks
(Mamba-2, mLSTM, sLSTM: ``models.mamba``, ``models.ssm``) compute on the
rank's share (``_tp_keep``; each share marked with a
``dist.sharding.Share``, which carries the model group); no weight split
over ``model`` is gathered over it but cross-attention's, which is
computed whole on every model rank. The residual stream lays its
sequence over ``model`` as JAX's ``constrain(x, "batch", "seq", None)``
does (sequence parallelism, where the rules resolve "seq" to ``model``
and it divides S: ``dist.sharding.Placement.seq_share``; under
``use_rules({"seq": ()})`` the stream stays replicated, the same
numbers): between sub-blocks each rank holds its rows of every sequence,
and the residual adds and the norms run on them (a norm's scale through
``models.params.row_local``: its gradient summed over ``model``). Each
sub-block all-gathers its normed input along the sequence on entry and
leaves onto the rank's rows (``models.params.enter_region``,
``leave_region``): Megatron's pairing, an all-gather in and a
reduce-scatter out, where the sub-block computes on shares (TP MLPs and
attention, the recurrent sub-blocks' row-parallel output projections;
EP's input); an all-gather in and the rank's rows of the output, whose
cotangent is all-gathered back, where it is computed whole on every model
rank (attention whose heads do not split, cross-attention, a factorized
sub-block, EP's replicated output). The embedding's vocab-parallel sum is
reduce-scattered onto the rank's rows; the final rows are all-gathered
again for the vocab-parallel logits and loss, which read every row of the
batch (``dist.sharding.batch_rows``). The prefill takes the same path and
its last live rows come from the ranks that hold them.

``prefill`` and ``decode_step`` take a placement too (serving with
sharded parameters, JAX's ``lower_cell`` shardings), for every family: a
rank's blocks of the parameters, its batch rows (its rows' whole
prompts) and its block of the cache (``dist.sharding.shard_cache`` under
``CACHE_AXES``: rows over the batch axes, each slot's K/V rows over
``model``, a recurrent state's heads over ``model`` where they divide,
``cross_kv``'s encoder rows over ``model``). Each layer's blocks are
gathered on use, one layer at a time; the dense and shared MLPs stay
tensor-parallel, the expert stacks expert-parallel and the recurrent
sub-blocks on their shares, each writing its block of the state; the
attention is gathered whole and reads and writes the rank's block of the
cache (``models.attention``'s note), a factorized linear is gathered
whole, and the logits are the rank's rows over the whole vocabulary. An
encoder-decoder prefill runs the encoder under the placement and keeps
the rank's rows of each layer's ``cross_kv``; decode's cross-attention
reads them and merges the model ranks' softmax states
(``attention.attend_cross``). A paged pool has no placement, in JAX as
here.

Batch dictionary convention (everything optional except one input):
``tokens`` (B, S) int (the decoder's, for an encoder-decoder model);
``embeds`` (B, S, D) float, precomputed frontend embeddings in place of
the token embedding; ``positions`` (B, S) int, or (3, B, S) under M-RoPE;
``enc_embeds`` (B, T, D) float or ``enc_tokens`` (B, T) int, the encoder's
input; ``labels`` and ``loss_mask`` for the loss; for prefill,
``lengths`` (B,) int; ``prefill_ext`` also takes ``starts`` (B,) int.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import pytree
from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.models import mamba, rotary, ssm
from repro_torch.models.attention import (attend_cross, attend_decode,
                                          attend_full, attend_prefill,
                                          attend_prefill_ext,
                                          cache_write_index, cross_kv,
                                          init_attention, init_kv_cache,
                                          local_write_index,
                                          paged_write_index)
from repro_torch.models.mlp import apply_mlp, apply_moe, init_mlp, init_moe
from repro_torch.models.params import (Builder, Params, apply_linear,
                                       enter_region, leave_region, norm,
                                       rms_norm, row_local, softcap)

KINDS = ("attn", "swa", "hymba", "hymba_g", "mlstm", "slstm")
# kinds whose layers carry recurrent state: prompts cannot be right-padded
RECURRENT = ("hymba", "hymba_g", "mlstm", "slstm")
# kinds with an attention sub-block and its k/v cache
_ATTN = ("attn", "swa", "hymba", "hymba_g")


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for a config dtype name ("bfloat16", "float32", ...)."""
    return getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raises for a layer kind, rope kind or frontend the JAX package does
    not have. The frontends are stubs there and here: their embeddings
    arrive precomputed (``embeds``, ``enc_embeds``)."""
    kinds = set(cfg.layer_kinds())
    if cfg.is_encoder_decoder:
        kinds |= set(encoder_config(cfg).layer_kinds())
    if (not kinds <= set(KINDS)
            or cfg.rope_kind not in ("rope", "mrope", "none")
            or cfg.frontend not in ("", "audio", "vision")):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)}, rope kind "
            f"{cfg.rope_kind!r} or frontend {cfg.frontend!r} unknown")


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``n_encoder_layers`` global layers."""
    return cfg.replace(n_layers=cfg.n_encoder_layers, sliding_window=0,
                       local_global_pattern=(0, 0))


def is_recurrent(cfg: ModelConfig) -> bool:
    """Whether any layer carries recurrent state (right padding of a prompt
    would run through it)."""
    return any(k in RECURRENT for k in cfg.layer_kinds())


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(b: Builder, cfg: ModelConfig, kind: str, n: int,
                cross: bool = False) -> None:
    """One run of `n` layers of `kind` (stacked along leading dim); with
    ``cross``, each layer has a cross-attention block (``ln_cross``,
    ``cross``) before its FFN."""
    stack = (n,)
    b.rmsnorm("ln1", cfg.d_model, stack)
    if kind in _ATTN:
        init_attention(b.sub("attn"), cfg, stack)
    if kind in ("hymba", "hymba_g"):
        mamba.init_ssm(b.sub("ssm"), cfg, stack)
        mamba.init_hymba_combine(b, cfg, stack)
    if kind == "mlstm":
        ssm.init_mlstm(b.sub("mlstm"), cfg, stack)
    if kind == "slstm":
        ssm.init_slstm(b.sub("slstm"), cfg, stack)
    if cross:
        b.rmsnorm("ln_cross", cfg.d_model, stack)
        init_attention(b.sub("cross"), cfg, stack, cross=True)
    # FFN (attention-ish kinds only; the xLSTM kinds carry their own)
    if kind in _ATTN:
        b.rmsnorm("ln2", cfg.d_model, stack)
        if cfg.moe.num_experts:
            init_moe(b, cfg, stack)
        elif cfg.d_ff:
            init_mlp(b.sub("mlp"), cfg, cfg.d_ff, stack)


def init_model(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> Tuple[Params, Params]:
    """Random weights from ``seed`` on ``device`` (the card by default).
    Returns (params, specs) — parallel trees in the JAX package's layout."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = None                  # the meta device: shapes only, no draws
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    b = Builder(gen, dev, param_dtype=dtype_of(cfg.param_dtype))
    b.normal("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
             scale=1.0 / cfg.d_model ** 0.5)
    dec = b.sub("decoder")
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        _init_block(dec.sub(f"run{r}"), cfg, kind, n,
                    cross=cfg.is_encoder_decoder)
    b.rmsnorm("final_norm", cfg.d_model)
    if not cfg.tie_embeddings:
        b.linear("lm_head", cfg.d_model, cfg.vocab_size, ("embed", "vocab"))
    if cfg.is_encoder_decoder:
        enc = b.sub("encoder")
        enc_cfg = encoder_config(cfg)
        for r, (kind, n) in enumerate(enc_cfg.layer_runs()):
            _init_block(enc.sub(f"run{r}"), enc_cfg, kind, n)
        enc.rmsnorm("enc_norm", cfg.d_model)
    return b.params, b.specs


def param_count(params: Params) -> int:
    return sum(t.numel() for t in pytree.tensors(params))


def tree_index(tree, i: int):
    """Layer i of a stacked run (params or cache): every tensor leaf
    indexed on its leading axis (a view); other leaves (capture tags) pass
    through."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_index(v, i) for v in tree))
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree


def _stack_trees(trees):
    """Per-layer trees stacked along a new leading axis."""
    return pytree.tree_map(lambda *a: torch.stack(a), *trees)


def _layers(run_p: Any, n: int):
    """Per-layer trees of a run, in either form."""
    if isinstance(run_p, list):
        return run_p
    return [tree_index(run_p, i) for i in range(n)]


def _params_device(params: Params) -> torch.device:
    return params["embed"].device


# ---------------------------------------------------------------------------
# Rope angles per kind
# ---------------------------------------------------------------------------
def _angles_for(cfg: ModelConfig, kind: str,
                positions: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if cfg.rope_kind == "none" or positions is None:
        return None
    local = kind in ("swa", "hymba") and cfg.rope_theta_local > 0
    theta = cfg.rope_theta_local if local else cfg.rope_theta
    if cfg.rope_kind == "mrope":
        return rotary.mrope_angles(positions, cfg.head_dim, theta,
                                   cfg.mrope_sections)
    return rotary.rope_angles(positions, cfg.head_dim, theta)


def _kind_window(cfg: ModelConfig, kind: str) -> int:
    if kind in ("swa", "hymba"):
        return cfg.sliding_window
    return 0


# ---------------------------------------------------------------------------
# Full-sequence block application (train / eval)
# ---------------------------------------------------------------------------
def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, sp=None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x plus the layer's FFN (MoE or dense) of ``ln2(x)``; x itself for a
    layer without one (the xLSTM kinds). Returns (x, the MoE aux loss, or
    None for a layer without MoE). ``sp``: x is the rank's rows of the
    sequence (sequence parallelism)."""
    if "moe" in p:
        out, aux = apply_moe(p, cfg, norm(p["ln2"], x, cfg.norm_eps, sp),
                             sp)
        return x + out, aux
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], cfg,
                          norm(p["ln2"], x, cfg.norm_eps, sp), sp)
    return x, None


def _cross(p: Params, cfg: ModelConfig, x: torch.Tensor,
           kv: Tuple[torch.Tensor, torch.Tensor], split=None, sp=None
           ) -> torch.Tensor:
    """x plus the layer's cross-attention of ``ln_cross(x)`` to the
    encoder's (k, v), (B, T_enc, KV, hd) each (with ``split``, a
    ``dist.sharding.SeqSplit``: this rank's rows of them)."""
    return x + attend_cross(p["cross"], cfg,
                            norm(p["ln_cross"], x, cfg.norm_eps, sp), *kv,
                            split=split, sp=sp)


def _block_fwd(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor,
               angles: Optional[torch.Tensor], causal: bool,
               enc_out: Optional[torch.Tensor] = None, sp=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, moe_aux or None). ``sp``: x is the rank's rows of the
    sequence, and so is the result (sequence parallelism)."""
    h = norm(p["ln1"], x, cfg.norm_eps, sp)
    win = _kind_window(cfg, kind)
    if kind in ("attn", "swa"):
        x = x + attend_full(p["attn"], cfg, h, angles, causal=causal,
                            window=win, sp=sp)
    elif kind in ("hymba", "hymba_g"):
        a = attend_full(p["attn"], cfg, h, angles, causal=causal, window=win,
                        sp=sp)
        s = mamba.apply_ssm(p["ssm"], cfg, h, sp=sp)
        x = x + mamba.hymba_combine(p, cfg, a, s, sp)
    elif kind == "mlstm":
        x = x + ssm.apply_mlstm(p["mlstm"], cfg, h, sp=sp)
    elif kind == "slstm":
        x = x + ssm.apply_slstm(p["slstm"], cfg, h, sp=sp)
    if "ln_cross" in p and enc_out is not None:
        x = _cross(p, cfg, x, cross_kv(p["cross"], cfg, enc_out), sp=sp)
    return _ffn(p, cfg, x, sp)


# "dots": keep the matmul outputs through the rematerialized block (JAX's
# dots_saveable policy); everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_spec(spec):
    """A stacked run's spec tree without its leading (layer) entry."""
    if isinstance(spec, dict):
        return {k: _layer_spec(v) for k, v in spec.items()}
    return type(spec)(*spec[1:])


# the sub-blocks the model code computes on shares over ``model`` in
# training and in serving: the dense and shared MLPs (column- and
# row-parallel), the expert stacks (expert parallelism), the Mamba-2 and
# mLSTM ``ssm_inner`` leaves and the sLSTM's ``w_in`` and FFN
# (``models.mamba``, ``models.ssm``)
_TP_BLOCKS = ("mlp", "moe", "moe_shared", "ssm", "mlstm", "slstm")


def _tp_keep(cfg: ModelConfig, model_size: int):
    """Which of a layer's leaves the model code computes on in shares over
    ``model`` in the sharded train step (``dist.sharding.Placement.
    materialize``'s ``keep_model``): the attention's q heads and wo where
    the heads split evenly, k and v where the kv heads do too (tensor
    parallelism), and every sub-block of ``_TP_BLOCKS``. Cross-attention
    is gathered and computed whole on every model rank."""
    q = cfg.n_heads % model_size == 0
    kv = q and cfg.n_kv_heads % model_size == 0

    def keep(path) -> bool:
        if path[0] == "attn":
            return kv if path[1] in ("wk", "wv") else q
        return path[0] in _TP_BLOCKS
    return keep


def _serve_keep(path) -> bool:
    """Serving's ``keep_model``: the sub-blocks of ``_TP_BLOCKS`` stay on
    their shares; the attention, self and cross, is gathered whole
    (``models.attention``'s note)."""
    return path[0] in _TP_BLOCKS


def _serve_layers(params: Params, r: int, n: int,
                  pl: Optional[SH.Placement]):
    """Run r's per-layer trees for prefill and decode; under a placement
    each from this rank's blocks, gathered on use (``_serve_keep``) one
    layer at a time, as the loop asks for it."""
    run_p = params["decoder"][f"run{r}"]
    if pl is None:
        return _layers(run_p, n)
    if isinstance(run_p, list):
        raise NotImplementedError("a placement holds stacked runs only")
    lspec = _layer_spec(pl.spec_at("decoder", f"run{r}"))
    return (pl.materialize(tree_index(run_p, i), lspec, _serve_keep)
            for i in range(n))


def _whole_vocab(params: Params, logits: torch.Tensor) -> torch.Tensor:
    """The logits over the whole vocabulary: a vocab-parallel block
    (``lm_logits`` under a placement) all-gathered over ``model``."""
    vocab = SH.share_of(params, "vocab")
    if vocab is None and "lm_head" in params:
        vocab = SH.share_of(params["lm_head"], "col")
    if vocab is None:
        return logits
    return comm.all_gather(logits, logits.dim() - 1, vocab.group)


def _run_layers(run_p: Any, n: int, x: torch.Tensor, body,
                cfg: ModelConfig, aux: torch.Tensor,
                placement: Optional[SH.Placement] = None, spec=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a run, list (compressed deploy) or stacked form.
    `body(p_layer, x) -> (x, moe aux or None)`; returns (x, ``aux`` plus
    the run's MoE aux losses). With gradients on, a stacked run of a scanned
    config rematerializes each layer per ``cfg.remat``
    ("block"/"full": keep only the layer's input; "dots": keep the matmul
    outputs too).

    Under a ``placement`` (``spec``: the run's spec tree) a stacked run
    holds this rank's blocks, and each layer's are gathered on use, one
    layer at a time, inside the rematerialized region: the backward
    gathers them again instead of keeping them, as XLA does under ``scan``
    with remat, and reduce-scatters their gradients. The layer code reads
    its shares' groups from their marks, so a recompute needs no context
    of the caller's thread (it runs in the autograd engine's)."""
    remat = (cfg.remat != "none" and cfg.scan_layers
             and not isinstance(run_p, list) and torch.is_grad_enabled())
    kw: Dict[str, Any] = {}
    if remat and cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)
    pl = placement
    if pl is not None:
        if isinstance(run_p, list):
            raise NotImplementedError("a placement holds stacked runs only")
        lspec, keep, inner = _layer_spec(spec), _tp_keep(cfg,
                                                         pl.model_size), body

        def body(p_blocks, xx):     # noqa: F811
            return inner(pl.materialize(p_blocks, lspec, keep), xx)
    for pl_ in _layers(run_p, n):
        if remat:
            # the model draws no random numbers, so no RNG state to keep
            x, a = ckpt.checkpoint(body, pl_, x, use_reentrant=False,
                                   preserve_rng_state=False, **kw)
        else:
            x, a = body(pl_, x)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor, sp=None) -> torch.Tensor:
    """The token rows of ``embed``. Under a placement that splits the
    vocab over ``model`` (``params`` marked "vocab"; ``embed`` is this
    rank's block of rows), each rank looks up the tokens it owns, zeros
    elsewhere, and the rows are summed over ``model``: all-reduced, or
    under ``sp`` (sequence parallelism) reduce-scattered onto the rank's
    rows of the sequence, which is what ``sp`` returns otherwise too."""
    emb = params["embed"].to(dtype_of(cfg.dtype))
    tokens = tokens.to(device=emb.device, dtype=torch.long)
    vocab = SH.share_of(params, "vocab")
    if vocab is not None:
        vl = emb.shape[0]
        t = tokens - vocab.index * vl
        x = emb[t.clamp(0, vl - 1)]
        x = leave_region(torch.where(((t >= 0) & (t < vl))[..., None], x,
                                     torch.zeros_like(x)), vocab.group, sp)
    else:
        if sp is not None:
            tokens = tokens[:, sp.block(tokens.shape[1])]
        x = row_local(emb, sp)[tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_logits(params: Params, cfg: ModelConfig,
              x: torch.Tensor, sp=None) -> torch.Tensor:
    """The logits of the last hidden rows; under a placement that splits
    the vocab over ``model``, this rank's block of the vocab (the tied
    ``embed``'s rows or ``lm_head``'s columns). Under ``sp`` x is the
    rank's rows of the sequence, normed there and all-gathered: the
    logits are every row's (``models.params.enter_region``)."""
    x = norm(params["final_norm"], x, cfg.norm_eps, sp)
    if cfg.tie_embeddings:
        vocab = SH.share_of(params, "vocab")
        x = enter_region(x, None if vocab is None else vocab.group, sp)
        logits = x @ params["embed"].to(x.dtype).T
    else:
        vocab = SH.share_of(params["lm_head"], "col")
        x = enter_region(x, None if vocab is None else vocab.group, sp)
        logits = apply_linear(params["lm_head"], x)
    return softcap(logits, cfg.logit_softcap)


def _default_positions(cfg: ModelConfig, batch: Dict,
                       device: torch.device) -> Optional[torch.Tensor]:
    if cfg.rope_kind == "none":
        return None
    if "positions" in batch:
        return torch.as_tensor(batch["positions"], device=device)
    src = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return rotary.make_positions(src.shape[0], src.shape[1], device,
                                 kind=cfg.rope_kind)


def _tokens(batch: Dict, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=device)


def _embed_input(params: Params, cfg: ModelConfig, batch: Dict,
                 device: torch.device, sp=None) -> torch.Tensor:
    """The decoder's input rows: ``embeds`` in the compute dtype when the
    batch has them (the frontend stub), else the token embedding; an
    encoder-decoder model adds the sinusoidal positions. Under ``sp`` the
    rank's rows of the sequence."""
    if "embeds" in batch:
        x = torch.as_tensor(batch["embeds"], device=device).to(
            dtype_of(cfg.dtype))
        if sp is not None:
            x = x[:, sp.block(x.shape[1])]
    else:
        x = embed_tokens(params, cfg, _tokens(batch, device), sp)
    if cfg.is_encoder_decoder:
        x = _add_sinusoidal(cfg, x, None if sp is None else _rows_pos(x, sp))
    return x


def _seq_len(batch: Dict) -> int:
    """The decoder's sequence length of a batch."""
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]


def _rows_pos(x: torch.Tensor, sp) -> torch.Tensor:
    """(B, S_local) positions of the rank's rows x (B, S_local, ...) of
    sequences of ``S_local · sp.size`` rows."""
    B, S = x.shape[0], x.shape[1]
    return (torch.arange(S, device=x.device)
            + sp.index * S)[None].expand(B, S)


def _add_sinusoidal(cfg: ModelConfig, x: torch.Tensor,
                    pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, D) plus the sinusoidal embedding of ``pos`` (B, S) (by
    default 0..S-1), cast to x's dtype before the add, as in JAX."""
    if pos is None:
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
    return x + rotary.sinusoidal_embed(pos, cfg.d_model).to(x.dtype)


def _stack_forward(stack_p: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: Optional[torch.Tensor],
                   enc_out: Optional[torch.Tensor], causal: bool,
                   placement: Optional[SH.Placement] = None, spec=None,
                   sp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every run of ``cfg``'s stack over x (``spec``: the stack's spec tree
    under a ``placement``; ``sp``: x is the rank's rows of the sequence).
    Returns (x, the MoE aux sum)."""
    aux = torch.zeros((), device=x.device)
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        angles = _angles_for(cfg, kind, positions)
        x, aux = _run_layers(
            stack_p[f"run{r}"], n, x,
            lambda pl, xx, kind=kind, angles=angles: _block_fwd(
                kind, cfg, pl, xx, angles, causal=causal, enc_out=enc_out,
                sp=sp),
            cfg, aux, placement, None if spec is None else spec[f"run{r}"])
    return x, aux


def _stack_spec(placement: Optional[SH.Placement], name: str):
    return None if placement is None else placement.spec_at(name)


def encode(params: Params, cfg: ModelConfig, batch: Dict, *,
           placement: Optional[SH.Placement] = None) -> torch.Tensor:
    """The encoder stack of an encoder-decoder model over ``enc_embeds``
    (the audio stub; cast to the compute dtype) or ``enc_tokens``:
    sinusoidal positions, non-causal self-attention (the flash kernel),
    ``enc_norm``. Returns (B, T, D). ``placement``: as ``forward``'s."""
    dev = _params_device(params)
    src = batch["enc_embeds"] if "enc_embeds" in batch else batch[
        "enc_tokens"]
    sp = None if placement is None else placement.seq_share(src.shape[1])
    if "enc_embeds" in batch:
        x = torch.as_tensor(batch["enc_embeds"], device=dev).to(
            dtype_of(cfg.dtype))
        if sp is not None:
            x = x[:, sp.block(x.shape[1])]
    else:
        x = embed_tokens(params, cfg, torch.as_tensor(batch["enc_tokens"],
                                                      device=dev), sp)
    x = _add_sinusoidal(cfg, x, None if sp is None else _rows_pos(x, sp))
    x, _ = _stack_forward(params["encoder"], encoder_config(cfg), x, None,
                          None, causal=False, placement=placement,
                          spec=_stack_spec(placement, "encoder"), sp=sp)
    x = norm(params["encoder"]["enc_norm"], x, cfg.norm_eps, sp)
    # every row, to every decoder layer's cross block (computed whole)
    return x if sp is None else enter_region(x, None, sp)


# ---------------------------------------------------------------------------
# Forward (train / eval, full sequence)
# ---------------------------------------------------------------------------
_TOP = ("embed", "final_norm", "lm_head")


def _use_top(pl, params: Params) -> Params:
    """``params`` with the leaves outside the layer runs gathered for use
    (the vocab stays split over ``model``: ``params`` marked "vocab"); the
    runs stay blocks, gathered a layer at a time."""
    out = dict(params)
    vocab = pl.vocab_share()
    if vocab is not None:
        out["_tp"] = vocab
    for k in _TOP:
        if k in params:
            out[k] = pl.materialize(params[k], pl.spec_at(k),
                                    lambda path: True)
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"], enc_norm=pl.materialize(
            params["encoder"]["enc_norm"], pl.spec_at("encoder", "enc_norm")))
    return out


def forward(params: Params, cfg: ModelConfig, batch: Dict, *,
            placement: Optional[SH.Placement] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward. Returns (logits (B,S,V), aux). Under a
    ``dist.sharding.Placement`` (``placement``) ``params`` are this rank's
    blocks, ``batch`` its rows (whole sequences), and the logits this
    rank's block of the vocab where the vocab splits over ``model``; the
    residual stream between sub-blocks holds the rank's rows of each
    sequence where the rules lay it over ``model`` (the module's note)."""
    check_supported(cfg)
    pl = placement
    sp = None
    if pl is not None:
        params = _use_top(pl, params)
        sp = pl.seq_share(_seq_len(batch))
    dev = _params_device(params)
    enc_out = (encode(params, cfg, batch, placement=pl)
               if cfg.is_encoder_decoder else None)
    x = _embed_input(params, cfg, batch, dev, sp)
    positions = _default_positions(cfg, batch, dev)
    x, aux = _stack_forward(params["decoder"], cfg, x, positions, enc_out,
                            causal=True, placement=pl,
                            spec=_stack_spec(pl, "decoder"), sp=sp)
    logits = lm_logits(params, cfg, x, sp)
    return logits, {"moe_aux": aux}


def loss_labels(cfg: ModelConfig, batch: Dict, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, mask) of ``lm_loss``: explicit ``labels`` or the tokens
    shifted left by one (the last position -1), masked where negative and
    by ``loss_mask``."""
    if "labels" in batch:
        labels = torch.as_tensor(batch["labels"], device=device).long()
    else:
        labels = F.pad(_tokens(batch, device)[:, 1:].long(), (0, 1),
                       value=-1)
    mask = (labels >= 0).to(torch.float32)
    if "loss_mask" in batch:
        mask = mask * torch.as_tensor(batch["loss_mask"], device=device)
    return labels, mask


def _log_softmax_terms(lf: torch.Tensor, labels: torch.Tensor,
                       vocab: Optional[SH.Share]):
    """(log-sum-exp, gold logit, argmax) of float32 logits. On this rank's
    block of a vocab split over ``model`` (``vocab``, its share): the max
    and the sum of exponentials reduced over ``model``, the gold logit
    from the rank that owns the label, and the argmax across the blocks
    with ``torch.argmax``'s tie rule (the first index)."""
    if vocab is None:
        return (torch.logsumexp(lf, dim=-1),
                torch.gather(lf, -1, labels[..., None])[..., 0],
                torch.argmax(lf.detach(), -1))
    vl = lf.shape[-1]
    g, v0 = vocab.group, vocab.index * vl
    m = comm.all_reduce_max(lf.detach().amax(-1), g)
    logz = m + torch.log(comm.tp_exit(torch.exp(lf - m[..., None]).sum(-1),
                                      g))
    t = labels - v0
    mine = (t >= 0) & (t < vl)
    gl = torch.gather(lf, -1, t.clamp(0, vl - 1)[..., None])[..., 0]
    gold = comm.tp_exit(torch.where(mine, gl, torch.zeros_like(gl)), g)
    with torch.no_grad():
        vals = comm.all_gather(lf.amax(-1)[None], 0, g)
        idxs = comm.all_gather((torch.argmax(lf, -1) + v0)[None], 0, g)
        first = (vals == vals.amax(0)).to(torch.int32).argmax(0)
        arg = torch.gather(idxs, 0, first[None])[0]
    return logz, gold, arg


def lm_loss_terms(params: Params, cfg: ModelConfig, batch: Dict, *,
                  placement: Optional[SH.Placement] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict]:
    """``lm_loss``'s two terms apart: (the mean CE, the MoE term
    ``aux_loss_weight · moe_aux / n_layers`` or None, metrics)."""
    logits, aux = forward(params, cfg, batch, placement=placement)
    dev = logits.device
    labels, mask = loss_labels(cfg, batch, dev)
    labels_c = labels.clamp_min(0)
    lf = logits.to(torch.float32)
    logz, gold, arg = _log_softmax_terms(
        lf, labels_c, None if placement is None else placement.vocab_share())
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    with torch.no_grad():
        acc = (arg == labels_c).to(torch.float32) * mask
        metrics = {
            "loss": loss.detach(),
            "ppl_log": loss.detach(),       # exp() applied host-side
            "accuracy": acc.sum() / denom,
            "tokens": mask.sum(),
        }
    term = None
    if cfg.moe.num_experts:
        term = cfg.moe.aux_loss_weight * aux["moe_aux"] / max(1, cfg.n_layers)
        metrics["moe_aux"] = aux["moe_aux"].detach()
    return loss, term, metrics


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict, *,
            placement: Optional[SH.Placement] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE. If batch has explicit `labels`, logits align 1:1 with
    them; otherwise labels are tokens shifted left by one (the last
    position padded with -1, masked). ``loss_mask`` multiplies the mask.
    An MoE model adds ``aux_loss_weight · moe_aux / n_layers`` and reports
    ``metrics["moe_aux"]``. Returns (loss, metrics); the metrics are
    detached and stay on the device. ``placement``: as ``forward``'s."""
    loss, term, metrics = lm_loss_terms(params, cfg, batch,
                                        placement=placement)
    if term is not None:
        loss = loss + term
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode (single step with caches)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None, enc_len: int = 0) -> Dict:
    """Cache tree: per-run stacked caches + per-sequence positions, in the
    JAX package's layout: ``kv`` for the attention kinds, ``ssm`` (a
    ``ScanState`` and the conv history) beside it for Hymba's, ``mlstm``
    and ``slstm`` for xLSTM's, ``cross_kv`` (k, v of (n, batch, enc_len,
    KV, hd)) for an encoder-decoder model; every leaf (n, batch, ...),
    each in its own storage. Every slot starts dead (pos = -1)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)

    def stacked(tree, n):
        return pytree.tree_map(
            lambda t: t[None].repeat(n, *([1] * t.dim())), tree)

    runs: Dict[str, Any] = {}
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        entry: Dict[str, Any] = {}
        if kind in _ATTN:
            entry["kv"] = stacked(init_kv_cache(
                cfg, batch, max_len, _kind_window(cfg, kind), dtype, dev), n)
        if kind in ("hymba", "hymba_g"):
            entry["ssm"] = stacked(
                mamba.init_ssm_cache(cfg, batch, dtype, dev), n)
        if kind == "mlstm":
            entry["mlstm"] = stacked(
                ssm.init_mlstm_cache(cfg, batch, dtype, dev), n)
        if kind == "slstm":
            entry["slstm"] = stacked(
                ssm.init_slstm_cache(cfg, batch, dtype, dev), n)
        if cfg.is_encoder_decoder:
            shape = (n, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            entry["cross_kv"] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
        runs[f"run{r}"] = entry
    return {"runs": runs,
            "pos": torch.full((batch,), -1, dtype=torch.int32, device=dev)}


def init_cache_paged(cfg: ModelConfig, batch: int, blocks: int,
                     block_len: int, device: DeviceLike = None) -> Dict:
    """Paged cache: one flat KV block arena per run instead of the per-slot
    (batch, max_len) pool. k/v are (n, blocks, block_len, KV, hd); arena
    block 0 is the never-allocated null block (what a dead table entry
    points at). The logical-to-physical map lives outside, in the
    engine's (batch, NB) block table. Pure-attention decoders only:
    recurrent kinds have no paged layout and windowed kinds keep the ring
    cache. Every slot starts dead (pos = -1)."""
    check_supported(cfg)
    kinds = {kind for kind, _ in cfg.layer_runs()}
    if cfg.is_encoder_decoder:
        raise ValueError("the paged cache is for decoder-only models")
    if kinds != {"attn"}:
        raise ValueError(f"the paged cache supports pure-attention stacks "
                         f"only, got layer kinds {sorted(kinds)}")
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    runs: Dict[str, Any] = {}
    for r, (_kind, n) in enumerate(cfg.layer_runs()):
        shape = (n, blocks, block_len, cfg.n_kv_heads, cfg.head_dim)
        runs[f"run{r}"] = {"kv": {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}}
    return {"runs": runs,
            "pos": torch.full((batch,), -1, dtype=torch.int32, device=dev)}


def _block_decode(kind: str, cfg: ModelConfig, p: Params, cache: Dict,
                  x: torch.Tensor, pos: torch.Tensor,
                  angles: Optional[torch.Tensor],
                  table: Optional[torch.Tensor] = None,
                  write_index=None, split=None, cross_split=None
                  ) -> torch.Tensor:
    """One layer's decode step. ``cache`` is the layer's view of the pool:
    the attention writes its k/v there in place, and each recurrent state
    leaf is overwritten in place (``copy_``) with its new value, so a
    captured graph that binds the pool reads and writes the pool's own
    tensors. Under a placement ``cache`` is the rank's block and the new
    state is too; ``split`` and ``cross_split`` say which rows of the K/V
    and of ``cross_kv`` it holds."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    win = _kind_window(cfg, kind)
    new: Dict[str, Any] = {}
    if kind in _ATTN:
        a, _ = attend_decode(p["attn"], cfg, h, pos, cache["kv"], angles,
                             window=win, table=table,
                             write_index=write_index, split=split)
    if kind in ("attn", "swa"):
        x = x + a
    elif kind in ("hymba", "hymba_g"):
        s, new["ssm"] = mamba.decode_ssm(p["ssm"], cfg, h, cache["ssm"])
        x = x + mamba.hymba_combine(p, cfg, a, s)
    elif kind == "mlstm":
        out, new["mlstm"] = ssm.decode_mlstm(p["mlstm"], cfg, h,
                                             cache["mlstm"])
        x = x + out
    elif kind == "slstm":
        out, new["slstm"] = ssm.decode_slstm(p["slstm"], cfg, h,
                                             cache["slstm"])
        x = x + out
    if "ln_cross" in p and "cross_kv" in cache:     # read-only in decode
        x = _cross(p, cfg, x, (cache["cross_kv"]["k"],
                               cache["cross_kv"]["v"]), cross_split)
    for name, tree in new.items():
        for dst, src in zip(pytree.tensors(cache[name]),
                            pytree.tensors(tree)):
            dst.copy_(src)
    return _ffn(p, cfg, x)[0]


def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                table: Optional[torch.Tensor] = None, *,
                placement: Optional[SH.Placement] = None,
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token per sequence. tokens (B,1) int, or embeds (B,1,D)
    float. Without ``positions`` the rope position is each row's cache
    index ``pos``, broadcast to t = h = w under M-RoPE as in JAX (not
    Qwen2-VL's offsets after an image); an encoder-decoder model adds the
    sinusoidal embedding of ``pos`` and attends to the cache's read-only
    ``cross_kv``. The cache (k/v and every recurrent state leaf) and
    ``cache["pos"]`` are updated in place:
    dead slots (pos = -1) stay dead, live slots advance. As in JAX every
    row is decoded, so a dead row's recurrent state evolves; admission
    overwrites a slot's every leaf and purge zeroes them. Nothing here
    reads the device on the host, so a step captures into a CUDA graph.
    With ``table`` (B, NB) int32 the cache is a paged arena
    (``init_cache_paged``) and every KV read and write goes through the
    table; dead slots write nothing. Returns (logits (B,1,V), cache).

    Under a ``dist.sharding.Placement`` (``placement``, with its
    ``cache_len``) ``params`` are this rank's blocks, ``cache`` its block
    (``dist.sharding.shard_cache``) and ``tokens`` its batch rows; the
    logits are those rows over the whole vocabulary; an encoder-decoder
    model's placement also needs its ``enc_len``. Still no host read."""
    pl = placement
    cross_split = None
    if pl is not None:
        if table is not None:
            raise NotImplementedError("a paged pool on a mesh: JAX places "
                                      "none")
        params = _use_top(pl, params)
    dev = _params_device(params)
    pos = cache["pos"]
    if tokens.is_floating_point():
        x = tokens.to(device=dev, dtype=dtype_of(cfg.dtype))
    else:
        x = embed_tokens(params, cfg, tokens)
    if cfg.is_encoder_decoder:
        x = _add_sinusoidal(cfg, x, pos[:, None])
    if positions is not None:
        rp = positions
    elif cfg.rope_kind == "mrope":
        rp = pos[None, :, None].expand(3, pos.shape[0], 1)
    else:
        rp = pos[:, None]
    if table is not None:
        table = table.to(device=dev, dtype=torch.int32)
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        angles = _angles_for(cfg, kind, rp)
        run_c = cache["runs"][f"run{r}"]
        wi = split = None
        if pl is not None and "cross_kv" in run_c:
            cross_split = _seq_split(pl.enc_len, run_c["cross_kv"]["k"],
                                     pl, "enc_len")
        if kind in _ATTN:
            kv = run_c["kv"]
            win = _kind_window(cfg, kind)
            if pl is not None:
                split = _seq_split(win or pl.cache_len, kv["k"], pl,
                                   "cache_len")
            # where this step writes: computed once for all layers of the run
            if table is not None:
                wi = paged_write_index(pos, table, kv["k"].shape[2])
            elif split is not None:
                wi = local_write_index(cache_write_index(
                    pos, split.length, win), split)
            else:
                wi = cache_write_index(pos, kv["k"].shape[2], win)
        for i, lp in enumerate(_serve_layers(params, r, n, pl)):
            x = _block_decode(kind, cfg, lp, tree_index(run_c, i), x, pos,
                              angles, table, wi, split, cross_split)
    logits = lm_logits(params, cfg, x)
    if pl is not None:
        logits = _whole_vocab(params, logits)
    pos.copy_(torch.where(pos >= 0, pos + 1, pos))
    return logits, cache


def _seq_split(length: Optional[int], leaf: torch.Tensor,
               pl: SH.Placement, what: str):
    """The rank's block of a run's cache rows (``length`` rows a slot:
    the window of a ring, the placement's ``cache_len`` for the full
    layout, its ``enc_len`` for ``cross_kv``), or None where they are
    whole; ``leaf`` (n, B, rows, ...) is what the rank holds."""
    if length is None:
        raise ValueError(f"decode under a placement needs its {what} (the "
                         f"cache's global rows)")
    split = pl.seq_split(length)
    held = length if split is None else split.rows
    if leaf.shape[2] != held:
        raise ValueError(f"the rank holds {leaf.shape[2]} cache rows a "
                         f"slot, its block of {length} is {held}")
    return split


# ---------------------------------------------------------------------------
# Prefill (full sequence -> cache)
# ---------------------------------------------------------------------------
def _block_prefill(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor,
                   angles: Optional[torch.Tensor], max_len: int,
                   lengths: Optional[torch.Tensor],
                   enc_out: Optional[torch.Tensor] = None, split=None,
                   cross_split=None, sp=None) -> Tuple[torch.Tensor, Dict]:
    """One layer of the prefill: (x, the layer's cache). A cross block's
    K/V of ``enc_out`` are computed once, attended to and kept as the
    layer's ``cross_kv`` (JAX applies wk/wv twice, to the same numbers);
    with ``cross_split`` the cache keeps the rank's rows of them. Under a
    placement every leaf of the layer's cache is the rank's block; under
    ``sp`` x is the rank's rows of the prompts, and each sub-block
    gathers every row (the K/V and a recurrent state are the whole
    prompt's)."""
    cache: Dict[str, Any] = {}
    h = norm(p["ln1"], x, cfg.norm_eps, sp)
    win = _kind_window(cfg, kind)
    if kind in _ATTN:
        a, cache["kv"] = attend_prefill(p["attn"], cfg, h, angles,
                                        causal=True, window=win,
                                        max_len=max_len, lengths=lengths,
                                        split=split, sp=sp)
    if kind in ("attn", "swa"):
        x = x + a
    elif kind in ("hymba", "hymba_g"):
        s, cache["ssm"] = mamba.apply_ssm(p["ssm"], cfg, h,
                                          return_cache=True, sp=sp)
        x = x + mamba.hymba_combine(p, cfg, a, s, sp)
    elif kind == "mlstm":
        out, cache["mlstm"] = ssm.apply_mlstm(p["mlstm"], cfg, h,
                                              return_cache=True, sp=sp)
        x = x + out
    elif kind == "slstm":
        out, cache["slstm"] = ssm.apply_slstm(p["slstm"], cfg, h,
                                              return_cache=True, sp=sp)
        x = x + out
    if "ln_cross" in p and enc_out is not None:
        k, v = cross_kv(p["cross"], cfg, enc_out)
        x = _cross(p, cfg, x, (k, v), sp=sp)
        if cross_split is not None:
            rows = slice(cross_split.offset,
                         cross_split.offset + cross_split.rows)
            k, v = k[:, rows], v[:, rows]
        cache["cross_kv"] = {"k": k, "v": v}
    return _ffn(p, cfg, x, sp)[0], cache


def prefill(params: Params, cfg: ModelConfig, batch: Dict,
            max_len: int, *, placement: Optional[SH.Placement] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt, build the decode cache. Returns (logits of the
    last live position (B, 1, V), cache).

    ``batch["lengths"]`` (B,) int, optional: per-row live prompt lengths
    when prompts are right-padded to a common length; cache slots past a
    row's length are zeroed, the logits are each row's last LIVE position,
    and cache ``pos`` starts at the per-row length. Recurrent kinds carry
    their state through padded steps, so callers pass ``lengths`` for
    pure attention stacks only (the batcher admits recurrent stacks at
    each prompt's exact length).

    Under a ``dist.sharding.Placement`` (``placement``) ``params`` are
    this rank's blocks and ``batch`` its rows (``dist.sharding.batch_rows``
    of its blocks); the cache returned is the rank's block under
    ``CACHE_AXES`` (each slot's rows split over ``model`` where it divides
    ``window or max_len``), its recurrent state and ``cross_kv`` its
    blocks too, and the logits its rows over the whole vocabulary. The
    residual runs on the rank's rows of the prompts where the rules lay
    the sequence over ``model`` (``Placement.seq_share``), and each row's
    last live position comes from the rank that holds it."""
    check_supported(cfg)
    pl = placement
    sp = None
    if pl is not None:
        params = _use_top(pl, params)
        sp = pl.seq_share(_seq_len(batch))
    dev = _params_device(params)
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    enc_out = cross_split = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch, placement=pl)
        if pl is not None:
            cross_split = pl.seq_split(enc_out.shape[1])
    x = _embed_input(params, cfg, batch, dev, sp)
    B, S = x.shape[0], _seq_len(batch)
    positions = _default_positions(cfg, batch, dev)
    runs: Dict[str, Any] = {}
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        angles = _angles_for(cfg, kind, positions)
        split = None
        if pl is not None and kind in _ATTN:
            split = pl.seq_split(_kind_window(cfg, kind) or max_len)
        caches = []
        for lp in _serve_layers(params, r, n, pl):
            x, c = _block_prefill(kind, cfg, lp, x, angles, max_len, lengths,
                                  enc_out, split, cross_split, sp)
            caches.append(c)
        runs[f"run{r}"] = _stack_trees(caches)
    if lengths is None:
        last = torch.full((B,), S - 1, dtype=torch.long, device=dev)
        pos0 = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        last = (lengths - 1).long()
        pos0 = lengths.clone()     # decode_step advances it in place
    if sp is None:
        x_last = x[torch.arange(B, device=dev), last][:, None]
    else:
        # the rank that holds a row's last live position sends it: the
        # others add exact zeros
        rows = x.shape[1]
        at = last - sp.index * rows
        mine = (at >= 0) & (at < rows)
        xl = x[torch.arange(B, device=dev), at.clamp(0, rows - 1)]
        x_last = comm.all_reduce_sum(torch.where(
            mine[:, None], xl, torch.zeros_like(xl)), sp.group)[:, None]
    logits = lm_logits(params, cfg, x_last)
    if pl is not None:
        logits = _whole_vocab(params, logits)
    return logits, {"runs": runs, "pos": pos0}


def prefill_ext(params: Params, cfg: ModelConfig, batch: Dict,
                arena: Dict, table: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Tail prefill for prefix-reuse admission (paged pool only): run the
    UNSHARED tail of each prompt against a shared prefix already resident
    in the paged arena, which is read, never written.

    batch: tokens (B, St) right-padded tail ids; lengths (B,) live tail
    lengths; starts (B,) prefix lengths (tail position i is absolute
    position starts + i). arena: an ``init_cache_paged`` tree; table:
    (B, NB) int block table (its first ``starts[b]`` positions are the
    prefix).

    Returns (logits of each row's last live tail position (B, 1, V), tail
    cache): tail k/v are (n, B, St, KV, hd) in slot layout (slot s = tail
    position s), which ``serve.aot.scatter_paged`` writes through the
    table at the absolute offsets; cache ``pos`` = starts + lengths.

    Not under M-RoPE: the tail positions are built as (B, S), which
    ``mrope_angles`` cannot take, and the JAX package fails there too
    (its ``prefill_ext`` builds the same (B, S) positions)."""
    check_supported(cfg)
    if cfg.rope_kind == "mrope":
        raise ValueError(
            f"{cfg.name}: prefill_ext (prefix reuse) builds (B, S) "
            f"positions, which M-RoPE's (3, B, S) angles cannot take; the "
            f"JAX reference cannot run it either")
    dev = _params_device(params)
    lengths = torch.as_tensor(batch["lengths"], device=dev).to(torch.int32)
    starts = torch.as_tensor(batch["starts"], device=dev).to(torch.int32)
    table = torch.as_tensor(table, device=dev)
    x = embed_tokens(params, cfg, _tokens(batch, dev))
    B, S, _ = x.shape
    positions = None
    if cfg.rope_kind != "none":
        positions = (starts[:, None]
                     + torch.arange(S, device=dev, dtype=torch.int32)[None])
    runs: Dict[str, Any] = {}
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        if kind != "attn":
            raise ValueError(f"prefill_ext supports pure-attention stacks "
                             f"only, got {kind}")
        angles = _angles_for(cfg, kind, positions)
        arena_kv = arena["runs"][f"run{r}"]["kv"]
        ks, vs = [], []
        for i, pl in enumerate(_layers(params["decoder"][f"run{r}"], n)):
            h = rms_norm(pl["ln1"], x, cfg.norm_eps)
            out, kv = attend_prefill_ext(
                pl["attn"], cfg, h, angles,
                {"k": arena_kv["k"][i], "v": arena_kv["v"][i]}, table,
                starts, lengths)
            x, _ = _ffn(pl, cfg, x + out)
            ks.append(kv["k"])
            vs.append(kv["v"])
        runs[f"run{r}"] = {"kv": {"k": torch.stack(ks),
                                  "v": torch.stack(vs)}}
    last = (lengths.clamp_min(1) - 1).long()
    x_last = x[torch.arange(B, device=dev), last][:, None]
    logits = lm_logits(params, cfg, x_last)
    return logits, {"runs": runs, "pos": starts + lengths}
