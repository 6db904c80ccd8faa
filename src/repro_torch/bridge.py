"""Bring numpy parameter trees into the port.

``from_numpy`` turns a params tree of numpy arrays — for instance the JAX
package's params as ``jax.tree.map(np.asarray, params)`` — into the port's
tensors on a given device and dtype, in either run form (stacked runs or the
list form of a compressed model). This is how both packages compute on the
same weights. Leaves that share one buffer (a group's shared basis) become
one tensor again. A training state comes over the same way: a JAX
``TrainState`` as ``jax.tree.map(np.asarray, state)`` becomes the port's
``TrainState`` (params, ``opt.mu``, ``opt.nu``, and ``opt.step`` as an int32
scalar), each NamedTuple the port's class of the same name.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _key(a: np.ndarray):
    return (a.__array_interface__["data"][0], a.shape, a.strides, a.dtype.str)


def _port_namedtuple(name: str):
    """The port's NamedTuple class of the JAX package's ``name``."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.powersgd import PowerSGDState
    from repro_torch.train.step import TrainState
    classes = {c.__name__: c for c in (TrainState, AdamWState,
                                       PowerSGDState)}
    if name not in classes:
        raise TypeError(f"from_numpy: no port class for the NamedTuple "
                        f"{name!r}")
    return classes[name]


def from_numpy(tree, device: DeviceLike = None,
               dtype: Optional[torch.dtype] = None):
    """Copy of ``tree`` with every numpy array (or numpy scalar) turned into
    a tensor on ``device`` (the card by default). ``dtype`` casts the
    floating leaves; integer leaves keep their type. Dicts, lists, tuples
    and other leaves (capture tags) keep their structure; a NamedTuple
    becomes the port's class of the same name (``TrainState``,
    ``AdamWState``, ``PowerSGDState``)."""
    dev = resolve_device(device)
    memo = {}

    def make(a: np.ndarray) -> torch.Tensor:
        bf16 = a.dtype.name == "bfloat16"         # ml_dtypes, no torch twin
        src = a.astype(np.float32) if bf16 else a
        t = torch.tensor(np.ascontiguousarray(src).reshape(src.shape),
                         device=dev)        # 0-d stays 0-d
        if bf16:
            t = t.to(torch.bfloat16)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def conv(a: np.ndarray) -> torch.Tensor:
        # the tree keeps every array alive, so buffer addresses are unique
        key = _key(a)
        if key not in memo:
            memo[key] = make(a)
        return memo[key]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            vals = [walk(v) for v in node]
            if hasattr(node, "_fields"):
                return _port_namedtuple(type(node).__name__)(*vals)
            return tuple(vals)
        if isinstance(node, np.ndarray):
            return conv(node)
        if isinstance(node, np.generic):
            return make(np.asarray(node))
        return node

    return walk(tree)
