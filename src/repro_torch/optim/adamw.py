"""AdamW (decoupled weight decay), schedules, global-norm clipping
(counterpart of ``repro/optim/adamw.py``).

Functional, as the JAX module is: ``adamw_update`` returns new tensors and
leaves its inputs alone; the state is a plain tree (checkpointable through
``ckpt.store``). Float32 throughout, with the JAX module's order of
operations: the learning rate is taken at the step *before* the increment,
the bias corrections at the incremented step, ``eps`` is added outside the
square root, and weight decay applies to every leaf of two or more
dimensions (the stacked norm scales (n_layers, d) included). Not
``torch.optim.AdamW``: its decay mask and its rounding differ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import pytree


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32 scalar
    mu: Dict
    nu: Dict


def make_schedule(cfg: OptimizerConfig
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(1, cfg.total_steps - cfg.warmup_steps),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + torch.cos(math.pi * t))
        elif cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_frac) * t
        else:
            decay = torch.ones_like(t)
        return cfg.lr * warm * decay
    return sched


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2)
                          for x in pytree.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(norm), max_norm / (norm + 1e-9))
    return pytree.tree_map(lambda g: (g.to(torch.float32) * scale
                                      ).to(g.dtype), grads), norm


def adamw_init(params) -> AdamWState:
    leaves = pytree.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda: pytree.tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


def adamw_update(cfg: OptimizerConfig, grads, state: AdamWState, params,
                 ) -> Tuple[Dict, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, stats). Reads nothing back to the
    host."""
    sched = make_schedule(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.betas
    step = state.step + 1
    lr = sched(state.step)

    mu = pytree.tree_map(
        lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
        state.mu, grads)
    nu = pytree.tree_map(
        lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
        state.nu, grads)
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(torch.float32)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype)

    new_params = pytree.tree_map(upd, params, mu, nu)
    stats = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step=step, mu=mu, nu=nu), stats
