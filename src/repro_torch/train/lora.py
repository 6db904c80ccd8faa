"""LoRA fine-tuning on (compressed) models — the paper's Figure-3 recovery
path (counterpart of ``repro/train/lora.py``).

Adapters ride inside each linear's param dict ("lora_A"/"lora_B"/
"lora_scale", consumed by ``params.apply_linear`` as plain matmuls beside
the linear's own product), so the same model code serves dense, factorized
and adapted weights. Only the adapter leaves require grad, ``lora_scale``
included as in JAX; the base tree is never differentiated.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

from repro_torch import pytree
from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import Params
from repro_torch.optim.adamw import (OptimizerConfig, adamw_init,
                                     adamw_update)
from repro_torch.train.step import value_and_grad_of

_LORA_TARGETS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def _is_linear(d) -> bool:
    return isinstance(d, dict) and ("w" in d or ("B" in d and "C" in d))


def _dims(d) -> Tuple[int, int]:
    if "w" in d:
        return int(d["w"].shape[-2]), int(d["w"].shape[-1])
    return int(d["B"].shape[-2]), int(d["C"].shape[-1])


def init_lora(params: Params, cfg: ModelConfig, generator: torch.Generator,
              rank: int = 8, alpha: float = 32.0) -> Dict:
    """Returns a sparse adapter tree {joined-path: {"lora_A", "lora_B",
    "lora_scale"}} over every target linear (stacked runs get a leading
    stack dim; list runs get per-layer entries), float32 on the params'
    device. One ``generator`` draw per adapter, in the JAX walk's order."""
    adapters: Dict[str, Dict] = {}

    def walk(node, path):
        if _is_linear(node) and path and str(path[-1]) in _LORA_TARGETS:
            d_in, d_out = _dims(node)
            w = node.get("w", node.get("B"))
            lead = (w.shape[0],) if w.ndim == 3 else ()
            dev = w.device
            adapters["/".join(map(str, path))] = {
                "lora_A": 0.01 * torch.randn(
                    (*lead, d_in, rank), generator=generator, device=dev,
                    dtype=torch.float32),
                "lora_B": torch.zeros((*lead, rank, d_out),
                                      dtype=torch.float32, device=dev),
                "lora_scale": torch.tensor(alpha / rank, dtype=torch.float32,
                                           device=dev),
            }
            return
        if isinstance(node, dict):
            for kk, v in node.items():
                walk(v, path + (kk,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(params, ())
    return adapters


def merge_lora(params: Params, adapters: Dict) -> Params:
    """Non-destructively insert adapter leaves into the param tree (new
    containers, the same tensors: a group's shared basis stays one
    tensor)."""
    out = pytree.tree_map(lambda x: x, params)
    for pth, ad in adapters.items():
        node = out
        for kk in pth.split("/"):
            node = node[int(kk) if kk.isdigit() else kk]
        node.update(ad)
    return out


def lora_finetune(params: Params, cfg: ModelConfig,
                  batches: Iterable[Dict], steps: int,
                  rank: int = 8, alpha: float = 32.0, lr: float = 1e-4,
                  seed: int = 0) -> Tuple[Params, List[Dict]]:
    """Fine-tune adapters only, on the params' device; returns (merged
    params, history)."""
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed(seed)
    adapters = init_lora(params, cfg, gen, rank, alpha)
    ocfg = OptimizerConfig(lr=lr, warmup_steps=max(1, steps // 20),
                           total_steps=steps, weight_decay=0.0)
    opt = adamw_init(adapters)

    def step_fn(ad, opt, batch):
        _, metrics, grads = value_and_grad_of(
            lambda a: T.lm_loss(merge_lora(params, a), cfg, batch), ad)
        ad2, opt2, stats = adamw_update(ocfg, grads, opt, ad)
        return ad2, opt2, {**metrics, **stats}

    history = []
    it = iter(batches)
    for s in range(steps):
        batch = next(it)
        adapters, opt, m = step_fn(adapters, opt, batch)
        if s % 20 == 0 or s == steps - 1:
            history.append({"step": s, "loss": float(m["loss"])})
    return merge_lora(params, adapters), history
