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
for all the grads: one collective a step, not one a leaf. JAX gets the
same from jit shardings on one process (``tests/test_dist.py``); sharding
the parameters themselves (FSDP, tensor parallelism over ``model``) is
not ported (ROADMAP Queue 1, item 11, second part).
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
    from repro_torch.dist import comm
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, group=None):
    """The step function; with ``group`` (a data-parallel process group)
    the grads are reduced over it before AdamW."""
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
