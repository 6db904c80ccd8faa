"""Calibration capture: per-linear input-activation statistics (counterpart
of the eager half of ``repro/core/capture.py``).

The compression pipeline needs, for every compressible weight matrix
``W (d_in, d_out)``, the Gram matrix of its calibration inputs
``G = Σ_batches XᵀX`` in float64 (the paper keeps the whitening matrix S in
fp64) plus the mean-|X| vector (ASVD's scaling).

Mechanism: model parameters are converted to *list form* (stacked layer runs
→ per-layer trees), every linear's param dict gets a ``"_tag"`` string key,
and ``apply_linear`` reports ``(tag, x)`` to the active ``Collector``
(``repro_torch.models.params.set_capture``). The Gram is a plain float64
product on the activation's device, outside any kernel, exactly as the JAX
package computes it outside Pallas. The streaming calibrator (fp32 device
partials through the ``gram_blocked`` kernel) comes in a later slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.params import Params, set_capture
from repro_torch.models.transformer import tree_index


class Collector:
    """Accumulates XᵀX (fp64) and Σ|x| per tag on the activations' device;
    leaving the ``with`` block moves the sums to the host as numpy float64
    (``gram``, ``absmean``, ``count``), the form the compression step
    reads."""

    def __init__(self):
        self.gram: Dict[str, np.ndarray] = {}
        self.absmean: Dict[str, np.ndarray] = {}
        self.count: Dict[str, int] = {}
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
# List-form params + tagging
# ---------------------------------------------------------------------------
def _is_linear(d) -> bool:
    return isinstance(d, dict) and ("w" in d or ("B" in d and "C" in d))


def to_list_params(params: Params, cfg: ModelConfig) -> Params:
    """Stacked layer runs -> lists of per-layer trees (views of the stacked
    tensors). Already-list runs pass through. Non-run subtrees are kept."""
    out = dict(params)
    stack = params["decoder"]
    new = dict(stack)
    for r, (_kind, n) in enumerate(cfg.layer_runs()):
        rp = stack[f"run{r}"]
        new[f"run{r}"] = rp if isinstance(rp, list) else [
            tree_index(rp, i) for i in range(n)]
    out["decoder"] = new
    return out


def tag_linears(list_params: Params) -> Params:
    """Returns a shallow-copied tree where every linear dict carries its
    path as ``"_tag"``."""

    def walk(node, path):
        if _is_linear(node):
            d = dict(node)
            d["_tag"] = "/".join(map(str, path))
            return d
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
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
