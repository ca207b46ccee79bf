"""Public wrappers of the kernels: the model calls these.

Each wrapper sends a CPU tensor to the kernel's plain version and a CUDA
tensor to the CUDA kernel, which raises on what it cannot take; there is no
fallback from the kernel to the plain version. ``plain=True`` asks for the
plain version on any device: the comparisons of the kernels with their
plain versions on the card use it.

:class:`K1Tape` is remat policy "dots" (``decoder.Decoder.hidden``): while
a rematerialized block's forward runs under ``tape.record()``,
:func:`matmul` keeps each K1 product it makes; its recompute runs under
``tape.replay()`` and gets the same tensors back in the same order,
launching no K1. Outside a tape (serving, the backward) :func:`matmul`
calls the kernel directly.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels.block_matmul import (
    block_matmul_batched_kernel, block_matmul_batched_plain,
    block_matmul_kernel, block_matmul_plain)
from repro_torch.kernels.flash_attention import (
    FlashAttention, attn_core, flash_attention_bwd_kernel,
    flash_attention_kernel, paged_attention_kernel, paged_attention_plain,
    partial_attention_bwd_kernel, partial_attention_bwd_plain,
    partial_attention_kernel, partial_attention_plain)
from repro_torch.kernels.mla_decode import (mla_decode_kernel,
                                            mla_decode_plain)
from repro_torch.kernels.rmsnorm import (
    rmsnorm_apply_kernel, rmsnorm_apply_plain, rmsnorm_kernel, rmsnorm_plain,
    rmsnorm_stats_kernel, rmsnorm_stats_plain)
from repro_torch.kernels.selective_scan import (SelectiveScan,
                                                selective_scan_bwd_kernel,
                                                selective_scan_kernel,
                                                selective_scan_plain)

KERNELS = (rmsnorm_kernel, rmsnorm_stats_kernel, rmsnorm_apply_kernel,
           paged_attention_kernel, block_matmul_kernel,
           block_matmul_batched_kernel,
           flash_attention_kernel, flash_attention_bwd_kernel,
           selective_scan_kernel, selective_scan_bwd_kernel,
           partial_attention_kernel,
           partial_attention_bwd_kernel, mla_decode_kernel)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    """Launch count of each kernel wrapper, by kernel name. K5's and K7's
    wrappers launch two kernels in one call, a split walk and then the
    combine of each row's splits: ``paged_attention_combine`` and
    ``mla_decode_combine`` report the second, which runs exactly once with
    each first."""
    counts = {k.__name__.removesuffix("_kernel"): k.launches
              for k in KERNELS}
    return dict(counts, paged_attention_combine=counts["paged_attention"],
                mla_decode_combine=counts["mla_decode"])


def _plain(x, plain: bool) -> bool:
    return plain or x.device.type == "cpu"


def matmul(a, b, *, out_dtype=None, plain: bool = False):
    """(M, K) @ (K, N) with fp32 accumulation, in ``out_dtype`` (default:
    a's dtype; float32 for bfloat16 operands rounds nothing) (K1). Either
    operand may be a transposed view: the kernel reads both through their
    strides. Under a :class:`K1Tape` the product is recorded or
    replayed."""
    if _TAPE is not None:
        return _TAPE.matmul(a, b, out_dtype, plain)
    fn = block_matmul_plain if _plain(a, plain) else block_matmul_kernel
    return fn(a, b, out_dtype=out_dtype)


def bmm(a, b, *, out_dtype=None, plain: bool = False):
    """(E, M, K) @ (E, K, N) with fp32 accumulation, in ``out_dtype``
    (default: a's dtype), the E products in one launch (K1's batched
    entry). Either operand may be a view transposed or sliced in its last
    two dims. Never taped: remat "dots" saves the products without batch
    dims, as the reference's policy does, so a rematerialized block
    recomputes its expert products."""
    fn = (block_matmul_batched_plain if _plain(a, plain)
          else block_matmul_batched_kernel)
    return fn(a, b, out_dtype=out_dtype)


_TAPE: Optional["K1Tape"] = None


class K1Tape:
    """The K1 products of one rematerialized block's forward, for remat
    policy "dots" (the reference's ``dots_with_no_batch_dims_saveable``:
    every product with no batch dims is saved; attention's batched
    products run in K2, outside the tape). ``record()`` keeps each product
    :func:`matmul` makes, in call order; ``replay()``, the recompute,
    returns them in the same order and launches nothing. K1 is
    deterministic and the recompute makes the same calls on the same
    values, so the bits are those of policy "full". A recorded product
    changed in place since raises. The tape empties after its replay."""

    def __init__(self):
        self.saved = []
        self.replaying = False
        self.pos = 0

    @contextlib.contextmanager
    def _bound(self, replaying: bool):
        global _TAPE
        prev, _TAPE = _TAPE, self
        self.replaying, self.pos = replaying, 0
        try:
            yield
        finally:
            _TAPE = prev
            if replaying:
                self.saved = []

    def record(self):
        return self._bound(False)

    def replay(self):
        return self._bound(True)

    def matmul(self, a, b, out_dtype, plain):
        if not self.replaying:
            fn = block_matmul_plain if _plain(a, plain) else \
                block_matmul_kernel
            out = fn(a, b, out_dtype=out_dtype)
            self.saved.append((out, out._version))
            return out
        out, version = self.saved[self.pos]
        self.pos += 1
        if out._version != version or out.shape != (a.shape[0], b.shape[1]):
            raise RuntimeError("remat 'dots': a saved K1 product was changed "
                               "in place or the recompute differs from the "
                               "forward")
        return out


def rmsnorm(x, gamma, *, full_dim: Optional[int] = None, eps: float = 1e-6,
            plain: bool = False):
    """RMSNorm over the last dim of x (K3); ``full_dim`` is the width the
    mean divides by (the whole feature dim of an x-sharded row)."""
    fn = rmsnorm_plain if _plain(x, plain) else rmsnorm_kernel
    return fn(x, gamma, full_dim=full_dim, eps=eps)


def rmsnorm_stats(x, *, plain: bool = False):
    """Each row's fp32 sum of squares (K3's stats pass): the local half of
    a norm whose row is sharded over x."""
    fn = rmsnorm_stats_plain if _plain(x, plain) else rmsnorm_stats_kernel
    return fn(x)


def rmsnorm_apply(x, gamma, ss, *, full_dim: int, eps: float = 1e-6,
                  plain: bool = False):
    """x * rsqrt(ss / full_dim + eps) * gamma (K3's apply pass), ``ss``
    the rows' fp32 sums of squares over the whole (sharded) row."""
    fn = rmsnorm_apply_plain if _plain(x, plain) else rmsnorm_apply_kernel
    return fn(x, gamma, ss, full_dim=full_dim, eps=eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: int = 0, plain: bool = False):
    """Differentiable attention in the model's layouts (K2 forward and
    backward): q (B, T, nq, hd), k/v (B, S, nkv, hd) -> (B, T, nq, hd).
    Keys at or past ``kv_len`` (> 0) are masked."""
    if _plain(q, plain):
        return attn_core(q, k, v, causal=causal, window=window,
                         kv_len=kv_len)
    return FlashAttention.apply(q, k, v, causal, window, kv_len)


def flash_attention_partial(q, k, v, m, l, acc, *, plain: bool = False,
                            **pos):
    """One KV block of online softmax in the model's layouts (K4): q (B,
    T, nq, hd), k/v (B, S, nkv, hd), the fp32 carry m, l (B, nq, T) and
    acc (B, nq, T, hd) -> the new (m, l, acc), unnormalised. ``pos``:
    q_pos0, q_stride, k_pos0, k_stride (global positions pos0 + i *
    stride), causal, window, q_len, kv_len."""
    fn = (partial_attention_plain if _plain(q, plain)
          else partial_attention_kernel)
    return fn(q, k, v, m, l, acc, **pos)


def flash_attention_partial_bwd(q, k, v, dout, lse, delta, dq, *,
                                close=None, dk=None, dv=None,
                                plain: bool = False, **pos):
    """K4's backward for one KV block of a chain, given the chain's lse and
    delta (B, nq, T) fp32: adds into ``dq`` (B, T, nq, hd) fp32, returns
    the block's (dk, dv) (B, S, nkv, hd) fp32, written into ``dk``/``dv``
    where given. The chain's first call gives ``close`` = (out, m, l), its
    finalised output and final m, l, and writes ``lse`` = m + log l and
    ``delta`` = rowsum(dout * out) first."""
    fn = (partial_attention_bwd_plain if _plain(q, plain)
          else partial_attention_bwd_kernel)
    return fn(q, k, v, dout, lse, delta, dq, close=close, dk=dk, dv=dv,
              **pos)


def flash_attention_paged(q, k_pages, v_pages, table, q_pos, q_len, *,
                          window: int = 0, return_lse: bool = False,
                          plain: bool = False):
    """Paged variable-length attention in the model's layouts (K5): q
    (R, T, nq, hd), pools (P, page, nkv, hd), table (R, n_pages) int32,
    q_pos (R, T) int32, q_len (R,) int32 -> (R, T, nq, hd); with
    ``return_lse`` also each row's fp32 log-sum-exp (R, T, nq), NEG_INF
    where the row sees no key."""
    fn = paged_attention_plain if _plain(q, plain) else paged_attention_kernel
    return fn(q, k_pages, v_pages, table, q_pos, q_len, window=window,
              return_lse=return_lse)


def selective_scan(x, dt, A, B, C, s0=None, *, plain: bool = False):
    """The Mamba selective scan (K6): x, dt (Bt, T, d), A (d, N), B, C
    (Bt, T, N), initial state s0 (Bt, d, N) fp32 or None (zeros) -> (y
    (Bt, T, d) in x's dtype, final state (Bt, d, N) fp32). Where autograd
    records (grad enabled and an input requiring grad) it runs through
    ``SelectiveScan``, whose backward is K6's backward kernel (its plain
    version with ``plain`` or on the CPU); serving's calls launch the
    forward alone."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, s0)):
        return SelectiveScan.apply(x, dt, A, B, C, s0, plain)
    fn = selective_scan_plain if _plain(x, plain) else selective_scan_kernel
    return fn(x, dt, A, B, C, s0)


def mla_decode(q_eff, q_rope, ckv, k_rope, q_pos, *, scale: float,
               plain: bool = False):
    """MLA's absorbed decode attention over the latent cache (K7): q_eff
    (B, H, R) and q_rope (B, H, Dr) float32, the cache ckv (B, S, R) and
    k_rope (B, S, Dr), q_pos (B,) int32 -> the context (B, H, R) float32
    over the keys 0..q_pos."""
    fn = mla_decode_plain if _plain(q_eff, plain) else mla_decode_kernel
    return fn(q_eff, q_rope, ckv, k_rope, q_pos, scale=scale)
