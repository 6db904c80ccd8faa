"""Parameter construction + the dense/factorized linear runtime
(counterpart of ``repro/models/params.py``).

Params are plain nested dicts of tensors, in the JAX package's key layout;
alongside every params tree ``Builder`` keeps a parallel *spec tree* whose
leaves are tuples of logical axis names. A linear is either

  dense       {"w": (d_in, d_out) [, "b": (d_out,)]}
  factorized  {"B": (d_in, r), "C": (r, d_out) [, "b": ...]}   # D-Rank deploy form

optionally with a leading stack dim (n_layers_in_run, ...) for stacked layer
runs. ``apply_linear`` dispatches on the keys, so a compressed checkpoint
drops into the same model code. The factorized product always goes through
``kernels.ops.lowrank_matmul``: the CUDA kernel on the card, the plain
version on the CPU.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.dist import comm
from repro_torch.kernels import ops as kops

Params = Dict[str, object]
Specs = Dict[str, object]

# Calibration capture: when enabled, every apply_linear on a param dict
# carrying a "_tag" key reports its input activations to the active capture
# target (repro_torch.core.capture.Collector).
_CAPTURE = threading.local()


def set_capture(collector) -> None:
    _CAPTURE.collector = collector


def get_capture():
    return getattr(_CAPTURE, "collector", None)


class Builder:
    """Collects (params, specs) pairs from one seeded ``torch.Generator``,
    drawn in construction order (the JAX package folds keys instead; the
    two streams differ, so tests bridge JAX's weights rather than compare
    inits)."""

    def __init__(self, generator: torch.Generator, device: torch.device,
                 param_dtype=torch.float32):
        self.generator = generator
        self.device = device
        self.param_dtype = param_dtype
        self.params: Params = {}
        self.specs: Specs = {}

    def sub(self, name: str) -> "Builder":
        b = Builder.__new__(Builder)
        b.generator = self.generator
        b.device = self.device
        b.param_dtype = self.param_dtype
        b.params = self.params.setdefault(name, {})
        b.specs = self.specs.setdefault(name, {})
        return b

    def normal(self, name: str, shape: Sequence[int],
               axes: Sequence[Optional[str]], scale: float = 0.02):
        assert len(shape) == len(axes), (name, shape, axes)
        if self.device.type == "meta":      # shapes only: nothing to draw
            self.params[name] = torch.empty(tuple(shape),
                                            dtype=self.param_dtype,
                                            device=self.device)
            self.specs[name] = tuple(axes)
            return
        arr = torch.randn(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32) * scale
        self.params[name] = arr.to(self.param_dtype)
        self.specs[name] = tuple(axes)

    def zeros(self, name, shape, axes):
        self.params[name] = torch.zeros(tuple(shape), dtype=self.param_dtype,
                                        device=self.device)
        self.specs[name] = tuple(axes)

    def ones(self, name, shape, axes):
        self.params[name] = torch.ones(tuple(shape), dtype=self.param_dtype,
                                       device=self.device)
        self.specs[name] = tuple(axes)

    def const(self, name, value: torch.Tensor, axes):
        """A fixed initial value (a gate bias, an SSM's decay rates), in
        its own storage."""
        self.params[name] = value.to(device=self.device,
                                     dtype=self.param_dtype).clone()
        self.specs[name] = tuple(axes)

    # -- composite helpers --------------------------------------------------
    def linear(self, name: str, d_in: int, d_out: int,
               axes: Tuple[Optional[str], Optional[str]],
               stack: Tuple[int, ...] = (), bias: bool = False,
               scale: Optional[float] = None):
        """Dense linear (the compressor may later replace it by B/C)."""
        sub = self.sub(name)
        s = 0.02 if scale is None else scale
        stack_axes = (None,) * len(stack)
        sub.normal("w", (*stack, d_in, d_out), (*stack_axes, *axes), scale=s)
        if bias:
            sub.zeros("b", (*stack, d_out), (*stack_axes, axes[1]))

    def rmsnorm(self, name: str, dim: int, stack: Tuple[int, ...] = ()):
        self.sub(name).ones("scale", (*stack, dim),
                            ((None,) * len(stack)) + (None,))


# ---------------------------------------------------------------------------
# Apply fns
# ---------------------------------------------------------------------------
def apply_linear(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out); dense or factorized. ``.to(dtype)``
    is free when the weights already hold the compute dtype (``Engine``
    casts them once)."""
    dtype = dtype or x.dtype
    cap = get_capture()
    if cap is not None and "_tag" in p:
        cap.add(p["_tag"], x)
    if "B" in p:
        y = kops.lowrank_matmul(x, p["B"].to(dtype), p["C"].to(dtype))
    else:
        y = x @ p["w"].to(dtype)
    if "lora_A" in p:        # LoRA adapter: y += scale * x A B
        y = y + p["lora_scale"].to(dtype) * (
            (x @ p["lora_A"].to(dtype)) @ p["lora_B"].to(dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def enter_region(x: torch.Tensor, group, sp=None) -> torch.Tensor:
    """A sub-block's input x (B, S, D) under a placement. ``group``: the
    model group of a tensor-parallel sub-block (each rank computes its
    share, its cotangent of x is partial), None for one computed whole;
    ``sp``: the residual's "seq" share (``dist.sharding.Placement.
    seq_share``), x then the rank's rows. Without ``sp``, ``comm.
    tp_enter`` (TP) or x itself; with it, x all-gathered along the
    sequence, with a reduce-scatter backward for TP (``comm.gather``:
    the ranks' partial cotangents summed onto each rank's rows) and a
    narrowing one for a whole sub-block (``comm.gather_replicated``:
    every rank holds the whole cotangent, ``leave_region``)."""
    if sp is None:
        return x if group is None else comm.tp_enter(x, group)
    if group is None:
        return comm.gather_replicated(x, 1, sp.group, sp.index)
    return comm.gather(x, 1, sp.group)


def leave_region(y: torch.Tensor, group, sp=None) -> torch.Tensor:
    """A sub-block's output onto the residual (``enter_region``'s
    counterpart): a TP sub-block's partial sums over ``group`` all-reduced
    (``comm.tp_exit``), or with ``sp`` reduce-scattered onto the rank's
    rows (``comm.tp_scatter``, all-gather backward); a whole sub-block's
    output as it is, or with ``sp`` the rank's rows of it
    (``comm.keep_block``, all-gather backward)."""
    if sp is None:
        return y if group is None else comm.tp_exit(y, group)
    if group is None:
        return comm.keep_block(y, 1, sp.group, sp.index)
    return comm.tp_scatter(y, 1, sp.group)


def row_local(t, sp=None):
    """A leaf that every model rank holds whole and applies to its own
    rows of the sequence alone (a norm's scale, a bias added after a
    reduce-scatter; a tree of them): with ``sp`` through ``comm.tp_enter``,
    so its gradient, each rank's rows' part, is summed over ``model``."""
    if sp is None:
        return t
    if isinstance(t, dict):
        return {k: row_local(v, sp) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return comm.tp_enter(t, sp.group)
    return t


def apply_row_parallel(p: Params, x: torch.Tensor, group,
                       sp=None) -> torch.Tensor:
    """A row-parallel linear (its input rows split over ``group``, x this
    rank's share of the features): the partial products summed over the
    group (``leave_region``: all-reduced, or reduce-scattered onto the
    rank's rows under ``sp``), the bias added once after the sum."""
    y = leave_region(apply_linear({k: v for k, v in p.items() if k != "b"},
                                  x), group, sp)
    if "b" in p:
        y = y + row_local(p["b"], sp).to(y.dtype)
    return y


def norm(p: Params, x: torch.Tensor, eps: float, sp=None) -> torch.Tensor:
    """``rms_norm`` of the residual's rows, the scale ``row_local``."""
    return rms_norm(row_local(p, sp), x, eps)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dtype)


def head_rms_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: normalize over the trailing head_dim."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
