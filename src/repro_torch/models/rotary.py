"""Rotary embeddings (counterpart of ``repro/models/rotary.py``): standard
RoPE. M-RoPE and the sinusoidal encoder positions come with their model
families."""
from __future__ import annotations

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


def make_positions(batch: int, seq: int, device: torch.device,
                   offset: int = 0) -> torch.Tensor:
    """Default position ids (B, S)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    return (pos + offset).expand(batch, seq)
