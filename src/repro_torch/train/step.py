"""Train step: microbatched gradient accumulation, bf16 compute / fp32
optimizer state, remat per block, AdamW (counterpart of
``repro/train/step.py``).

Remat is the model's (``cfg.remat``, applied inside a stacked run in
``models.transformer``). A step reads nothing back to the host: losses,
metrics and the optimizer's stats stay tensors on the params' device, and
only ``evaluate_ppl`` (where the JAX module's loop logs) calls ``float``.

Data parallelism (``make_train_step(..., group=...)``, the ``data`` group
of a mesh): each rank computes its shard's loss and grads, and
``reduce_data_parallel`` turns them into the global batch's before AdamW.
``lm_loss`` divides by its shard's count of tokens, so the reduce weighs
each rank's loss, grads and accuracy by that count and divides by the
summed count (sums and counts, not means), in one flat float32 bucket
for all the grads: one collective a step, not one a leaf.

Sharded training (``make_train_step(..., mesh=...)``,
``sharded_train_step``): each rank holds its block of every parameter and
AdamW moment under the sharding rules (``shard_state``: FSDP over the
data axes, heads, MLP, vocab and experts over ``model``), gathers each on
use and reduce-scatters its gradient (``dist.sharding.Placement``), and
computes the heads, MLP columns, vocab block and experts it holds; the
residual stream holds the rank's rows of each sequence where the rules
lay it over ``model`` (sequence parallelism, ``models.transformer``).
JAX gets all three from ``jit`` shardings on one process
(``tests/test_dist.py``), with the same numbers.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch import pytree
from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.params import Params
from repro_torch.optim.adamw import (AdamWState, OptimizerConfig, adamw_init,
                                     adamw_update)


class TrainState(NamedTuple):
    params: Params
    opt: AdamWState


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1         # grad accumulation steps per train step
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None) -> Tuple[TrainState, Params]:
    """Random params from ``seed`` on ``device`` (the card by default; the
    ``meta`` device builds a template that holds no memory) and a fresh
    AdamW state. Returns (state, specs)."""
    params, specs = T.init_model(cfg, seed=seed, device=device)
    return TrainState(params=params, opt=adamw_init(params)), specs


def _microbatch(batch: Dict, n: int, i: int) -> Dict:
    """Slice microbatch i of n along the batch dim."""
    def sl(v):
        mb = v.shape[0] // n if v.ndim >= 2 and v.shape[0] >= n else None
        if mb is None:
            return v
        return v[i * mb:(i + 1) * mb]
    out = {}
    for k, v in batch.items():
        if k.startswith("enc_") or k == "positions":
            # positions may carry a leading component axis (m-rope: (3,B,S))
            if k == "positions" and v.ndim == 3:
                mb = v.shape[1] // n
                out[k] = v[:, i * mb:(i + 1) * mb]
                continue
        out[k] = sl(v)
    return out


def value_and_grad_of(fn, tree):
    """``fn(tree) -> (loss, aux)``, differentiated with respect to every
    tensor leaf of ``tree`` (each occurrence its own leaf, as ``jax.grad``
    sees a tree). A leaf the loss does not read (Hymba's SSM ``head_norm``,
    in JAX as here) gets zeros, as ``jax.grad`` gives it. Returns (loss,
    aux, grads shaped like ``tree``)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in pytree.leaves(tree)]
        loss, aux = fn(pytree.unflatten(tree, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), aux, pytree.unflatten(tree, grads)


def value_and_grad(params: Params, cfg: ModelConfig, batch: Dict):
    """(loss, metrics, grads) of ``T.lm_loss``; grads have the params'
    structure and dtypes."""
    return value_and_grad_of(lambda p: T.lm_loss(p, cfg, batch), params)


def loss_and_grads(params: Params, cfg: ModelConfig, batch: Dict,
                   microbatches: int = 1):
    """Microbatched value-and-grad: only one microbatch's logits are live
    at a time. Float32 grads are summed and divided by n; the metrics are
    averaged, with ``tokens`` multiplied back by n."""
    if microbatches <= 1:
        return value_and_grad(params, cfg, batch)
    mkeys = ("loss", "accuracy", "tokens")
    for i in range(microbatches):
        loss, metrics, grads = value_and_grad(
            params, cfg, _microbatch(batch, microbatches, i))
        grads = pytree.tree_map(lambda g: g.to(torch.float32), grads)
        if i == 0:          # JAX adds the first into zeros: the same bits
            acc_loss, acc_grads = loss, grads
            acc_metrics = {k: metrics[k] for k in mkeys}
        else:
            acc_loss = acc_loss + loss
            acc_grads = pytree.tree_map(torch.add, acc_grads, grads)
            acc_metrics = {k: acc_metrics[k] + metrics[k] for k in mkeys}
        del grads
    n = float(microbatches)
    grads = pytree.tree_map(lambda g: g / n, acc_grads)
    metrics = {k: v / n for k, v in acc_metrics.items()}
    metrics["tokens"] = metrics["tokens"] * n
    return acc_loss / n, metrics, grads


def reduce_data_parallel(loss: torch.Tensor, metrics: Dict, grads,
                         group) -> Tuple[torch.Tensor, Dict, Params]:
    """The global batch's loss, metrics and grads from every rank's
    shard: each rank's values weighed by its token count ``n_r`` and
    divided by ``N = Σ n_r``. The grads travel in one flat float32 bucket
    with the count and the weighted loss and accuracy at its end."""
    n = metrics["tokens"].to(torch.float32)
    leaves = pytree.leaves(grads)
    flat = torch.cat([g.reshape(-1).to(torch.float32) * n for g in leaves]
                     + [torch.stack([loss.to(torch.float32) * n,
                                     metrics["accuracy"] * n, n])])
    flat = comm.all_reduce_sum(flat, group)
    total = flat[-1]
    out, off = [], 0
    for g in leaves:
        out.append((flat[off:off + g.numel()] / total).reshape(g.shape)
                   .to(g.dtype))
        off += g.numel()
    metrics = dict(metrics)
    metrics["loss"] = flat[-3] / total
    metrics["ppl_log"] = metrics["loss"]
    metrics["accuracy"] = flat[-2] / total
    metrics["tokens"] = total
    return metrics["loss"], metrics, pytree.unflatten(grads, out)


def train_step(state: TrainState, batch: Dict, *, cfg: ModelConfig,
               tcfg: TrainConfig, group=None) -> Tuple[TrainState, Dict]:
    loss, metrics, grads = loss_and_grads(state.params, cfg, batch,
                                          tcfg.microbatches)
    if group is not None:
        loss, metrics, grads = reduce_data_parallel(loss, metrics, grads,
                                                    group)
    new_params, new_opt, stats = adamw_update(
        tcfg.optimizer, grads, state.opt, state.params)
    metrics = dict(metrics)
    metrics.update(stats)
    return TrainState(params=new_params, opt=new_opt), metrics


# ---------------------------------------------------------------------------
# The sharded step: FSDP, tensor and expert parallelism over a mesh
# ---------------------------------------------------------------------------
def state_specs(specs) -> TrainState:
    """The logical axes of a train state: AdamW's ``mu`` and ``nu`` take
    the params' (``specs``, from ``init_model``), ``step`` is
    replicated."""
    return TrainState(params=specs,
                      opt=AdamWState(step=(), mu=specs, nu=specs))


def placement(cfg: ModelConfig, mesh, params=None,
              specs=None) -> SH.Placement:
    """The parameters' shape-aware specs on ``mesh``: of ``params`` (whole
    or ``meta``: their shapes) under their logical ``specs`` where given
    (a D-Rank-compressed model's factorized linears), else of a ``meta``
    init of ``cfg``."""
    if params is None:
        params, specs = T.init_model(cfg, device="meta")
    shardings = SH.shardings_for_tree(params, specs, mesh)
    return SH.Placement(mesh, pytree.tree_map(lambda s: s.spec, shardings))


def shard_state(state: TrainState, specs, mesh):
    """This rank's blocks of a whole train state under the rules
    (``dist.sharding.shard_tree``). Returns (blocks, shardings)."""
    return SH.shard_tree(state, state_specs(specs), mesh)


def sharded_train_step(state: TrainState, batch: Dict, shardings: Dict, *,
                       cfg: ModelConfig, tcfg: TrainConfig,
                       placement: SH.Placement) -> Tuple[TrainState, Dict]:
    """One step on this rank's blocks of the state (``shard_state``) and
    its block of the batch, the numbers of JAX's step under ``jit``
    shardings. ``batch`` and ``shardings`` are ``dist.sharding.
    shard_batch``'s: the rank's block under the rules (rows over the batch
    axes, the sequence over ``model``), whose sequence is all-gathered over
    ``model`` first (``batch_rows``: the labels of a block's last position
    are the next block's first tokens). The rank's loss is scaled by
    ``n_r / N`` (its token count over the batch's, all-reduced over the
    batch axes first), so the gradients the FSDP gathers reduce-scatter
    are the global batch's, weighted as ``reduce_data_parallel`` weighs
    them; an MoE model's aux term is scaled by 1 / (the batch axes' size):
    JAX's transpose of its replicated aux hands every device that share.
    Microbatches accumulate float32 grads on the blocks. The metrics are
    ``reduce_data_parallel``'s, the loss the CE as ``lm_loss`` reports it
    (an MoE model's ``moe_aux``: data shard 0's, as JAX returns device
    0's), with the global norm over every rank's blocks."""
    pl = placement
    batch = SH.batch_rows(batch, shardings)
    nmb = max(1, tcfg.microbatches)
    _, mask = T.loss_labels(cfg, batch, state.opt.step.device)
    n = mask.sum()
    total = comm.all_reduce_sum(n, pl.batch_group)
    acc_grads, sums = None, None
    for i in range(nmb):
        mb = batch if nmb == 1 else _microbatch(batch, nmb, i)

        def fn(p, mb=mb):
            ce, term, m = T.lm_loss_terms(p, cfg, mb, placement=pl)
            loss = ce * (n / (total * nmb))
            if term is not None:
                loss = loss + term / (pl.batch_size * nmb)
            return loss, m
        _, m, grads = value_and_grad_of(fn, state.params)
        grads = pytree.tree_map(lambda g: g.to(torch.float32), grads)
        vals = {k: v for k, v in m.items() if k != "ppl_log"}
        if i == 0:
            acc_grads, sums = grads, vals
        else:
            acc_grads = pytree.tree_map(torch.add, acc_grads, grads)
            sums = {k: sums[k] + vals[k] for k in sums}
        del grads
    grads = pytree.tree_map(lambda g, p: g.to(p.dtype),
                            pl.reduce_grads(acc_grads), state.params)
    del acc_grads
    mean = {k: v / nmb for k, v in sums.items()}
    extra = ([mean["moe_aux"] * float(pl.batch_index == 0)]
             if "moe_aux" in mean else [])
    red = comm.all_reduce_sum(torch.stack(
        [mean["loss"] * n, mean["accuracy"] * n, n] + extra),
        pl.batch_group)
    metrics = {"loss": red[0] / red[2], "accuracy": red[1] / red[2],
               "tokens": red[2]}
    metrics["ppl_log"] = metrics["loss"]
    if extra:
        metrics["moe_aux"] = red[3]
    new_params, new_opt, stats = adamw_update(
        tcfg.optimizer, grads, state.opt, state.params,
        norm_fn=pl.global_norm)
    metrics.update(stats)
    return TrainState(params=new_params, opt=new_opt), metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, group=None,
                    mesh=None, params=None, specs=None):
    """The step function; with ``group`` (a data-parallel process group)
    the grads are reduced over it before AdamW; with ``mesh`` the state is
    sharded over it (``sharded_train_step``: pass ``shard_state``'s
    blocks, then ``shard_batch``'s block of the batch and its shardings).
    ``params`` and ``specs`` (shapes suffice) place a model that
    ``init_model`` does not build, a factorized one (``placement``)."""
    if mesh is not None:
        if group is not None:
            raise ValueError("make_train_step: group or mesh, not both")
        return functools.partial(sharded_train_step, cfg=cfg, tcfg=tcfg,
                                 placement=placement(cfg, mesh, params,
                                                     specs))
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg, group=group)


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------
def eval_step(params: Params, cfg: ModelConfig, batch: Dict) -> Dict:
    with torch.no_grad():
        _, metrics = T.lm_loss(params, cfg, batch)
    return metrics


def evaluate_ppl(params: Params, cfg: ModelConfig, batches) -> Dict:
    """Token-weighted perplexity over an iterable of batches."""
    tot_nll, tot_tok, tot_acc = 0.0, 0.0, 0.0
    for b in batches:
        m = eval_step(params, cfg, b)
        tok = float(m["tokens"])
        tot_nll += float(m["loss"]) * tok
        tot_acc += float(m["accuracy"]) * tok
        tot_tok += tok
    nll = tot_nll / max(1.0, tot_tok)
    return {"nll": nll, "ppl": math.exp(min(nll, 30.0)),
            "accuracy": tot_acc / max(1.0, tot_tok)}
