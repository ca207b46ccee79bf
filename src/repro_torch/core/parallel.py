"""4D tensor-parallel primitives, forward only (port of
``repro.core.parallel``).

The functions keep the JAX package's schedule: the z all-gather of a
weight before its local GEMM, the all-reduce over the contraction axis
after it, the vocab-parallel embedding and the tied LM head. On the
one-device mesh every collective is the identity (``core.mesh``). Local
GEMMs are ``torch.matmul``, as the JAX package leaves its ``_mm`` to XLA
outside any kernel; ``rms_norm`` runs kernel K3.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import mesh as M
from repro_torch.kernels import ops


def tp_matmul(x, w, axes: M.MeshAxes, in_shard: Optional[str] = "x",
              out_shard: Optional[str] = "y"):
    """Y = X @ W, W stored (k, n) as in the JAX package. ('x', 'y') is a
    paper "normal" layer, ('y', 'x') a "transposed" one (§4.1)."""
    wf = M.all_gather(w, axes, "z", dim=1)                    # AG_z
    y = torch.matmul(x, wf)                                   # local GEMM
    if in_shard is None:
        return y
    return M.psum(y, axes, in_shard)                          # AR (line 6)


def embedding_lookup(tokens, table, axes: M.MeshAxes):
    """tokens (B, S) int; table (V/y, d/(x z)) -> (B, S, d/x)."""
    tf = M.all_gather(table, axes, "z", dim=1)
    v_local = tf.shape[0]
    local = tokens.long() - M.axis_index(axes, "y") * v_local
    ok = (local >= 0) & (local < v_local)
    emb = tf[local.clamp(0, v_local - 1)]
    emb = torch.where(ok[..., None], emb, torch.zeros_like(emb))
    return M.psum(emb, axes, "y")       # assemble across vocab shards


def tied_lm_logits(h, table, axes: M.MeshAxes):
    """h (..., d/x); table (V/y, d/(x z)) -> logits (..., V/y)."""
    tf = M.all_gather(table, axes, "z", dim=1)
    logits = torch.matmul(h, tf.t())
    return M.psum(logits, axes, "x")


def rms_norm(x, gamma, axes: M.MeshAxes, full_dim: int, eps: float = 1e-6,
             *, plain: bool = False):
    """RMSNorm over a feature dim sharded across x (K3: the sum of squares
    of the whole row is the local one at g_x = 1)."""
    return ops.rmsnorm(x, gamma, full_dim=full_dim, eps=eps, plain=plain)


# ---------------------------------------------------------------------- #
# init: the JAX package's distributions, drawn from a torch.Generator
# ---------------------------------------------------------------------- #

def tp_linear_init(gen: torch.Generator, k: int, n: int, axes: M.MeshAxes,
                   *, scale: Optional[float] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """A (k, n) weight drawn from N(0, 1) * scale (default 1/sqrt(k))."""
    s = scale if scale is not None else 1.0 / math.sqrt(k)
    v = torch.randn((k, n), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (v * s).to(dtype)


def embedding_init(gen: torch.Generator, vocab: int, hidden: int,
                   axes: M.MeshAxes, *, dtype=torch.float32) -> torch.Tensor:
    v = torch.randn((vocab, hidden), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (v * 0.02).to(dtype)


def norm_param_init(hidden: int, axes: M.MeshAxes, *, device,
                    dtype=torch.float32, value: float = 1.0) -> torch.Tensor:
    return torch.full((hidden,), value, dtype=dtype, device=device)
