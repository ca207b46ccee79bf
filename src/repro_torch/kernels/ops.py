"""Public wrappers of the kernels: the model calls these.

Each wrapper sends a CPU tensor to the kernel's plain version and a CUDA
tensor to the CUDA kernel, which raises on what it cannot take; there is no
fallback from the kernel to the plain version. ``plain=True`` asks for the
plain version on any device: the comparisons of the kernels with their
plain versions on the card use it.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import (paged_attention_kernel,
                                                  paged_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain

KERNELS = (rmsnorm_kernel, paged_attention_kernel)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def rmsnorm(x, gamma, *, full_dim: Optional[int] = None, eps: float = 1e-6,
            plain: bool = False):
    """RMSNorm over the last dim of x (K3); ``full_dim`` is the width the
    mean divides by (the whole feature dim of an x-sharded row)."""
    fn = rmsnorm_plain if plain or x.device.type == "cpu" else rmsnorm_kernel
    return fn(x, gamma, full_dim=full_dim, eps=eps)


def flash_attention_paged(q, k_pages, v_pages, table, q_pos, q_len, *,
                          window: int = 0, plain: bool = False):
    """Paged variable-length attention in the model's layouts (K5): q
    (R, T, nq, hd), pools (P, page, nkv, hd), table (R, n_pages) int32,
    q_pos (R, T) int32, q_len (R,) int32 -> (R, T, nq, hd)."""
    fn = (paged_attention_plain if plain or q.device.type == "cpu"
          else paged_attention_kernel)
    return fn(q, k_pages, v_pages, table, q_pos, q_len, window=window)
