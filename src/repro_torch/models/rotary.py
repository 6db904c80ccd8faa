"""Rotary embeddings (counterpart of ``repro/models/rotary.py``): standard
RoPE, Qwen2-VL's M-RoPE and the sinusoidal absolute positions of the
encoder-decoder models."""
from __future__ import annotations

from typing import Tuple

import torch


def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions: (..., S) int -> angles (..., S, head_dim//2)."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].float() * freqs


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions: (3, B, S) — (t, h, w) component ids (text tokens use
    t = h = w). sections: per-component count of rotary frequency pairs,
    summing to head_dim//2. Returns angles (B, S, head_dim//2) whose
    frequency axis is split into t/h/w sections: pair f takes its angle from
    the component ``repeat(arange(3), sections)[f]``, selected by a one-hot
    (hd/2, 3) product as in JAX."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} must sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    dev = positions.device
    freqs = _rope_freqs(head_dim, theta, dev)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (3, B, S, hd/2)
    # the component of each pair from the section bounds (device ops on
    # Python ints: no host-to-device copy, so a decode step captures)
    f = torch.arange(head_dim // 2, device=dev)
    comp = (f >= sections[0]).long() + (f >= sections[0] + sections[1]).long()
    sel = (comp[:, None] == torch.arange(3, device=dev)).to(ang.dtype)
    # JAX's einsum "cbsf,fc->bsf" as an elementwise product and sum: exact
    # in float32 whatever the matmul precision (TF32 would round angles)
    return (ang * sel.t()[:, None, None, :]).sum(0)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); angles: (B, S, hd//2). Rotates interleaved halves
    (GPT-NeoX convention: first half / second half)."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    cos = torch.cos(angles)[..., None, :]   # (B, S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(dtype)


def sinusoidal_embed(positions: torch.Tensor, dim: int,
                     max_wavelength: float = 10_000.0) -> torch.Tensor:
    """positions (..., S) -> (..., S, dim) sinusoidal absolute embedding in
    float32, [sin | cos] halves; the caller casts it to x's dtype."""
    half = dim // 2
    # -log(max_wavelength) in float32, as JAX computes it, kept on the host
    # so that the embedding needs no host-to-device copy
    neg_log = -float(torch.log(torch.tensor(max_wavelength,
                                            dtype=torch.float32)))
    freq = torch.exp(neg_log * torch.arange(half, dtype=torch.float32,
                                            device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def make_positions(batch: int, seq: int, device: torch.device,
                   offset: int = 0, kind: str = "rope") -> torch.Tensor:
    """Default position ids: (B, S), or (3, B, S) with t = h = w for
    ``kind == "mrope"``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = (pos + offset).expand(batch, seq)
    if kind == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos
