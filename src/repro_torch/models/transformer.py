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
from repro_torch.models import mamba, rotary, ssm
from repro_torch.models.attention import (attend_cross, attend_decode,
                                          attend_full, attend_prefill,
                                          attend_prefill_ext,
                                          cache_write_index, cross_kv,
                                          init_attention, init_kv_cache,
                                          paged_write_index)
from repro_torch.models.mlp import apply_mlp, apply_moe, init_mlp, init_moe
from repro_torch.models.params import (Builder, Params, apply_linear,
                                       rms_norm, softcap)

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
def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x plus the layer's FFN (MoE or dense) of ``ln2(x)``; x itself for a
    layer without one (the xLSTM kinds). Returns (x, the MoE aux loss, or
    None for a layer without MoE)."""
    if "moe" in p:
        out, aux = apply_moe(p, cfg, rms_norm(p["ln2"], x, cfg.norm_eps))
        return x + out, aux
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], cfg, rms_norm(p["ln2"], x, cfg.norm_eps))
    return x, None


def _cross(p: Params, cfg: ModelConfig, x: torch.Tensor,
           kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x plus the layer's cross-attention of ``ln_cross(x)`` to the
    encoder's (k, v), (B, T_enc, KV, hd) each."""
    return x + attend_cross(p["cross"], cfg,
                            rms_norm(p["ln_cross"], x, cfg.norm_eps), *kv)


def _block_fwd(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor,
               angles: Optional[torch.Tensor], causal: bool,
               enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, moe_aux or None)."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    win = _kind_window(cfg, kind)
    if kind in ("attn", "swa"):
        x = x + attend_full(p["attn"], cfg, h, angles, causal=causal,
                            window=win)
    elif kind in ("hymba", "hymba_g"):
        a = attend_full(p["attn"], cfg, h, angles, causal=causal, window=win)
        s = mamba.apply_ssm(p["ssm"], cfg, h)
        x = x + mamba.hymba_combine(p, cfg, a, s)
    elif kind == "mlstm":
        x = x + ssm.apply_mlstm(p["mlstm"], cfg, h)
    elif kind == "slstm":
        x = x + ssm.apply_slstm(p["slstm"], cfg, h)
    if "ln_cross" in p and enc_out is not None:
        x = _cross(p, cfg, x, cross_kv(p["cross"], cfg, enc_out))
    return _ffn(p, cfg, x)


# "dots": keep the matmul outputs through the rematerialized block (JAX's
# dots_saveable policy); everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _run_layers(run_p: Any, n: int, x: torch.Tensor, body,
                cfg: ModelConfig, aux: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a run, list (compressed deploy) or stacked form.
    `body(p_layer, x) -> (x, moe aux or None)`; returns (x, ``aux`` plus
    the run's MoE aux losses). With gradients on, a stacked run of a scanned
    config rematerializes each layer per ``cfg.remat``
    ("block"/"full": keep only the layer's input; "dots": keep the matmul
    outputs too)."""
    remat = (cfg.remat != "none" and cfg.scan_layers
             and not isinstance(run_p, list) and torch.is_grad_enabled())
    kw: Dict[str, Any] = {}
    if remat and cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saveable)
    for pl in _layers(run_p, n):
        if remat:
            # the model draws no random numbers, so no RNG state to keep
            x, a = ckpt.checkpoint(body, pl, x, use_reentrant=False,
                                   preserve_rng_state=False, **kw)
        else:
            x, a = body(pl, x)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"].to(dtype_of(cfg.dtype))
    x = emb[tokens.to(device=emb.device, dtype=torch.long)]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_logits(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
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
                 device: torch.device) -> torch.Tensor:
    """The decoder's input rows: ``embeds`` in the compute dtype when the
    batch has them (the frontend stub), else the token embedding; an
    encoder-decoder model adds the sinusoidal positions."""
    if "embeds" in batch:
        x = torch.as_tensor(batch["embeds"], device=device).to(
            dtype_of(cfg.dtype))
    else:
        x = embed_tokens(params, cfg, _tokens(batch, device))
    if cfg.is_encoder_decoder:
        x = _add_sinusoidal(cfg, x)
    return x


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
                   enc_out: Optional[torch.Tensor], causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every run of ``cfg``'s stack over x. Returns (x, the MoE aux sum)."""
    aux = torch.zeros((), device=x.device)
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        angles = _angles_for(cfg, kind, positions)
        x, aux = _run_layers(
            stack_p[f"run{r}"], n, x,
            lambda pl, xx, kind=kind, angles=angles: _block_fwd(
                kind, cfg, pl, xx, angles, causal=causal, enc_out=enc_out),
            cfg, aux)
    return x, aux


def encode(params: Params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """The encoder stack of an encoder-decoder model over ``enc_embeds``
    (the audio stub; cast to the compute dtype) or ``enc_tokens``:
    sinusoidal positions, non-causal self-attention (the flash kernel),
    ``enc_norm``. Returns (B, T, D)."""
    dev = _params_device(params)
    if "enc_embeds" in batch:
        x = torch.as_tensor(batch["enc_embeds"], device=dev).to(
            dtype_of(cfg.dtype))
    else:
        x = embed_tokens(params, cfg, torch.as_tensor(batch["enc_tokens"],
                                                      device=dev))
    x = _add_sinusoidal(cfg, x)
    x, _ = _stack_forward(params["encoder"], encoder_config(cfg), x, None,
                          None, causal=False)
    return rms_norm(params["encoder"]["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Forward (train / eval, full sequence)
# ---------------------------------------------------------------------------
def forward(params: Params, cfg: ModelConfig,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward. Returns (logits (B,S,V), aux)."""
    check_supported(cfg)
    dev = _params_device(params)
    enc_out = encode(params, cfg, batch) if cfg.is_encoder_decoder else None
    x = _embed_input(params, cfg, batch, dev)
    positions = _default_positions(cfg, batch, dev)
    x, aux = _stack_forward(params["decoder"], cfg, x, positions, enc_out,
                            causal=True)
    logits = lm_logits(params, cfg, x)
    return logits, {"moe_aux": aux}


def lm_loss(params: Params, cfg: ModelConfig,
            batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE. If batch has explicit `labels`, logits align 1:1 with
    them; otherwise labels are tokens shifted left by one (the last
    position padded with -1, masked). ``loss_mask`` multiplies the mask.
    An MoE model adds ``aux_loss_weight · moe_aux / n_layers`` and reports
    ``metrics["moe_aux"]``. Returns (loss, metrics); the metrics are
    detached and stay on the device."""
    logits, aux = forward(params, cfg, batch)
    dev = logits.device
    if "labels" in batch:
        labels = torch.as_tensor(batch["labels"], device=dev).long()
    else:
        labels = F.pad(_tokens(batch, dev)[:, 1:].long(), (0, 1),
                       value=-1)
    mask = (labels >= 0).to(torch.float32)
    if "loss_mask" in batch:
        mask = mask * torch.as_tensor(batch["loss_mask"], device=dev)
    labels_c = labels.clamp_min(0)
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels_c[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    with torch.no_grad():
        acc = (torch.argmax(lf, -1) == labels_c).to(torch.float32) * mask
        metrics = {
            "loss": loss.detach(),
            "ppl_log": loss.detach(),       # exp() applied host-side
            "accuracy": acc.sum() / denom,
            "tokens": mask.sum(),
        }
    if cfg.moe.num_experts:
        loss = loss + cfg.moe.aux_loss_weight * aux["moe_aux"] / max(
            1, cfg.n_layers)
        metrics["moe_aux"] = aux["moe_aux"].detach()
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
                  write_index=None) -> torch.Tensor:
    """One layer's decode step. ``cache`` is the layer's view of the pool:
    the attention writes its k/v there in place, and each recurrent state
    leaf is overwritten in place (``copy_``) with its new value, so a
    captured graph that binds the pool reads and writes the pool's own
    tensors."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    win = _kind_window(cfg, kind)
    new: Dict[str, Any] = {}
    if kind in _ATTN:
        a, _ = attend_decode(p["attn"], cfg, h, pos, cache["kv"], angles,
                             window=win, table=table,
                             write_index=write_index)
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
                               cache["cross_kv"]["v"]))
    for name, tree in new.items():
        for dst, src in zip(pytree.tensors(cache[name]),
                            pytree.tensors(tree)):
            dst.copy_(src)
    return _ffn(p, cfg, x)[0]


def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                table: Optional[torch.Tensor] = None,
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
    table; dead slots write nothing. Returns (logits (B,1,V), cache)."""
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
        wi = None
        if kind in _ATTN:
            kv = run_c["kv"]
            win = _kind_window(cfg, kind)
            # where this step writes: computed once for all layers of the run
            wi = (paged_write_index(pos, table, kv["k"].shape[2])
                  if table is not None else
                  cache_write_index(pos, kv["k"].shape[2], win))
        for i, pl in enumerate(_layers(params["decoder"][f"run{r}"], n)):
            x = _block_decode(kind, cfg, pl, tree_index(run_c, i), x, pos,
                              angles, table, wi)
    logits = lm_logits(params, cfg, x)
    pos.copy_(torch.where(pos >= 0, pos + 1, pos))
    return logits, cache


# ---------------------------------------------------------------------------
# Prefill (full sequence -> cache)
# ---------------------------------------------------------------------------
def _block_prefill(kind: str, cfg: ModelConfig, p: Params, x: torch.Tensor,
                   angles: Optional[torch.Tensor], max_len: int,
                   lengths: Optional[torch.Tensor],
                   enc_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """One layer of the prefill: (x, the layer's cache). A cross block's
    K/V of ``enc_out`` are computed once, attended to and kept as the
    layer's ``cross_kv`` (JAX applies wk/wv twice, to the same numbers)."""
    cache: Dict[str, Any] = {}
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    win = _kind_window(cfg, kind)
    if kind in _ATTN:
        a, cache["kv"] = attend_prefill(p["attn"], cfg, h, angles,
                                        causal=True, window=win,
                                        max_len=max_len, lengths=lengths)
    if kind in ("attn", "swa"):
        x = x + a
    elif kind in ("hymba", "hymba_g"):
        s, cache["ssm"] = mamba.apply_ssm(p["ssm"], cfg, h,
                                          return_cache=True)
        x = x + mamba.hymba_combine(p, cfg, a, s)
    elif kind == "mlstm":
        out, cache["mlstm"] = ssm.apply_mlstm(p["mlstm"], cfg, h,
                                              return_cache=True)
        x = x + out
    elif kind == "slstm":
        out, cache["slstm"] = ssm.apply_slstm(p["slstm"], cfg, h,
                                              return_cache=True)
        x = x + out
    if "ln_cross" in p and enc_out is not None:
        k, v = cross_kv(p["cross"], cfg, enc_out)
        x = _cross(p, cfg, x, (k, v))
        cache["cross_kv"] = {"k": k, "v": v}
    return _ffn(p, cfg, x)[0], cache


def prefill(params: Params, cfg: ModelConfig, batch: Dict,
            max_len: int) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt, build the decode cache. Returns (logits of the
    last live position (B, 1, V), cache).

    ``batch["lengths"]`` (B,) int, optional: per-row live prompt lengths
    when prompts are right-padded to a common length; cache slots past a
    row's length are zeroed, the logits are each row's last LIVE position,
    and cache ``pos`` starts at the per-row length. Recurrent kinds carry
    their state through padded steps, so callers pass ``lengths`` for
    pure attention stacks only (the batcher admits recurrent stacks at
    each prompt's exact length)."""
    check_supported(cfg)
    dev = _params_device(params)
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    enc_out = encode(params, cfg, batch) if cfg.is_encoder_decoder else None
    x = _embed_input(params, cfg, batch, dev)
    B, S, _ = x.shape
    positions = _default_positions(cfg, batch, dev)
    runs: Dict[str, Any] = {}
    for r, (kind, n) in enumerate(cfg.layer_runs()):
        angles = _angles_for(cfg, kind, positions)
        caches = []
        for pl in _layers(params["decoder"][f"run{r}"], n):
            x, c = _block_prefill(kind, cfg, pl, x, angles, max_len, lengths,
                                  enc_out)
            caches.append(c)
        runs[f"run{r}"] = _stack_trees(caches)
    if lengths is None:
        x_last = x[:, -1:]
        pos0 = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        x_last = x[torch.arange(B, device=dev), (lengths - 1).long()][:, None]
        pos0 = lengths.clone()     # decode_step advances it in place
    logits = lm_logits(params, cfg, x_last)
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
