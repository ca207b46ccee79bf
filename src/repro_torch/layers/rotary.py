"""Rotary position embeddings (port of ``repro.layers.rotary``).

The pairing is the JAX package's interleaved one (``x[..., 0::2]`` with
``x[..., 1::2]``), not Hugging Face's half split: parity is with ``repro``.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, rotary_pct: float = 1.0,
               device=None):
    """Inverse frequencies for the rotary fraction of the head dim."""
    rot = int(head_dim * rotary_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, theta: float, rotary_pct: float = 1.0):
    """x: (B, T, n_heads, head_dim); positions: (B, T) int."""
    inv, rot = rope_freqs(x.shape[-1], theta, rotary_pct, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv             # (B, T, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1).to(x.dtype)


def apply_rope_interleaved_neox(x, positions, theta: float):
    """NeoX-style half rotation over the whole last dim (MLA's rope
    sub-dim): the first half paired with the second. x (B, T, n, d);
    positions (B, T) int."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
