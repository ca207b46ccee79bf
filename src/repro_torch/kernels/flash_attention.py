"""K2, flash attention (forward and backward), and K5, paged attention: the
CUDA kernels ``csrc/flash_attention.cu`` and ``csrc/paged_attention.cu``
and their plain versions.

K2 replaces ``repro/kernels/flash_attention.py:flash_attention`` (Pallas),
the function the JAX training path computes as ``layers.attention.
attn_core``; its backward kernel is new (the JAX package differentiates the
jnp ``attn_core``). Both versions take the model's layouts as they are
stored: q (B, T, nq, hd), k and v (B, S, nkv, hd). The plain version is
:func:`attn_core` and its backward is autograd's.

K5 replaces ``repro/kernels/flash_attention.py:flash_attention_paged``
(Pallas). Both versions take q (R, T, nq, hd) and page pools (P, page, nkv,
hd), with a page table (R, n_pages) int32, global query positions q_pos
(R, T) int32 and valid row counts q_len (R,) int32.

The headers of the CUDA sources say what bounds each kernel on the card and
how its design answers that.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_PAGE = 32


def paged_attn_core(q, k, v, *, q_pos, q_len, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Port of ``repro.layers.attention.paged_attn_core``: attention of
    q (R, T, nq, d) over per-slot keys k/v (R, S, nkv, dv) gathered in
    page-table order (key index j is global position j), in one fp32
    softmax over the fixed length S. Masked scores contribute exactly 0,
    and a row with no valid key gives 0. Reducing over the fixed S makes
    every chunking of a prompt reduce the same score vector per row, so
    chunked prefill equals one-shot prefill bitwise."""
    R, T, nq, d = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(R, T, nkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    iq = q_pos.to(torch.int32)[:, :, None]                       # (R, T, 1)
    jk = torch.arange(S, dtype=torch.int32, device=q.device)[None, None]
    row = torch.arange(T, dtype=torch.int32, device=q.device)[None, :, None]
    mask = (row < q_len.to(torch.int32)[:, None, None]) & (iq >= jk)
    if window > 0:
        mask &= (iq - jk) < window
    mask = mask[:, None, None]                                # (R,1,1,T,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(R, T, nq, v.shape[-1]
                                            ).to(q.dtype)


def paged_attention_plain(q, k_pages, v_pages, table, q_pos, q_len, *,
                          window: int = 0) -> torch.Tensor:
    """The plain version of K5, as the JAX serving path computes it: gather
    each slot's pages in table order, then :func:`paged_attn_core`."""
    R = q.shape[0]
    kc = k_pages[table.long()].reshape(R, -1, *k_pages.shape[2:])
    vc = v_pages[table.long()].reshape(R, -1, *v_pages.shape[2:])
    return paged_attn_core(q, kc, vc, q_pos=q_pos, q_len=q_len,
                           window=window)


def _launcher():
    fn = build.library("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, ll, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_kernel(q, k_pages, v_pages, table, q_pos, q_len, *,
                           window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not
    take. ``paged_attention_kernel.launches`` counts the launches."""
    R, T, nq, hd = q.shape
    P, page, nkv, hd_k = k_pages.shape
    tensors = (q, k_pages, v_pages, table, q_pos, q_len)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("paged_attention_kernel needs all inputs on one "
                         "CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if (q.dtype not in _DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise TypeError(f"paged_attention_kernel takes float32 or bfloat16 "
                        f"q and pools of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (table, q_pos, q_len)):
        raise TypeError("paged_attention_kernel takes int32 table, q_pos "
                        "and q_len")
    if (hd not in HEAD_DIMS or hd_k != hd or page > MAX_PAGE
            or nq % nkv or v_pages.shape != k_pages.shape
            or table.shape[0] != R or q_pos.shape != (R, T)
            or q_len.shape != (R,)):
        raise ValueError(
            f"paged_attention_kernel: unsupported shapes q {tuple(q.shape)}, "
            f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(table.shape)}, q_pos {tuple(q_pos.shape)}, q_len "
            f"{tuple(q_len.shape)} (head_dim in {HEAD_DIMS}, page <= "
            f"{MAX_PAGE}, nq a multiple of nkv)")
    if q.stride(-1) != 1 or not all(
            t.is_contiguous() for t in tensors[1:]):
        raise ValueError("paged_attention_kernel needs unit stride in q's "
                         "head_dim and contiguous pools, table, q_pos, "
                         "q_len")
    out = torch.empty((R, T, nq, hd), dtype=q.dtype, device=q.device)
    sr, st, sh, _ = q.stride()
    err = _launcher()(
        q.data_ptr(), sr, st, sh, k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), q_pos.data_ptr(), q_len.data_ptr(), out.data_ptr(),
        R, T, nq, nkv, hd, table.shape[1], page, P, window,
        1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention_kernel")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


# ---------------------------------------------------------------------- #
# K2: flash attention
# ---------------------------------------------------------------------- #

def softmax_fp32(scores):
    """Softmax accumulated in fp32 whatever the activation dtype
    (``layers.attention._softmax_fp32``)."""
    return torch.softmax(scores.float(), dim=-1)


def attn_core(q, k, v, *, causal: bool = True, window: int = 0,
              kv_len: int = 0):
    """Port of ``repro.layers.attention.attn_core`` (and of its chunked
    twin ``attn_core_chunked``, which computes the same function): q (B, T,
    nq, d), k/v (B, S, nkv, d), GQA by head grouping, in one fp32 softmax.
    Masked scores take NEG_INF. ``kv_len`` > 0 also masks keys at or past
    it, as the Pallas kernel does for padded keys. The plain version of
    K2; its backward is autograd's."""
    B, T, nq, d = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, T, nkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()
                          ) / math.sqrt(d)
    iq = torch.arange(T, device=q.device)[:, None]
    jk = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= iq >= jk
    if window > 0:
        mask &= (iq - jk) < window
    if kv_len > 0:
        mask &= jk < kv_len
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = softmax_fp32(scores)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, T, nq, v.shape[-1]).to(q.dtype)


def _fa_launcher(name: str):
    fn = getattr(build.library("flash_attention"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strided = [p, ll, ll, ll]
        if name == "flash_attention_fwd_launch":
            fn.argtypes = [*strided * 3, p, p, i, i, i, i, i, i, i, i, i,
                           ctypes.c_float, i, p]
        else:
            fn.argtypes = [*strided * 3, p, *strided, p, p, p, p, p,
                           i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(what, q, k, v, extra=()):
    tensors = (q, k, v, *extra)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{what} needs all inputs on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    B, T, nq, hd = q.shape
    if (hd not in HEAD_DIMS or k.shape[::3] != (B, hd) or k.shape != v.shape
            or k.shape[2] == 0 or nq % k.shape[2] or min(T, k.shape[1]) == 0):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (head_dim in "
                         f"{HEAD_DIMS}, nq a multiple of nkv, T, S > 0)")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{what} needs unit stride in head_dim")


def _strided(t):
    return (t.data_ptr(), *t.stride()[:3])


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           kv_len: int = 0):
    """Launch the CUDA forward on CUDA tensors; returns (out (B, T, nq, hd)
    in q's dtype, lse (B, nq, T) fp32). Raises on what it does not take.
    ``flash_attention_kernel.launches`` counts the launches."""
    _check_qkv("flash_attention_kernel", q, k, v)
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    out = torch.empty((B, T, nq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nq, T), dtype=torch.float32, device=q.device)
    err = _fa_launcher("flash_attention_fwd_launch")(
        *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
        lse.data_ptr(), B, T, S, nq, nkv, hd, int(causal), window, kv_len,
        1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_kernel")
    flash_attention_kernel.launches += 1
    return out, lse


flash_attention_kernel.launches = 0


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, *,
                               causal: bool = True, window: int = 0,
                               kv_len: int = 0):
    """Launch the CUDA backward (delta, dK/dV, dQ) on the forward's inputs,
    its output and lse, and the output's gradient ``dout``; returns (dq,
    dk, dv), contiguous, in the inputs' dtype. Raises on what it does not
    take. ``flash_attention_bwd_kernel.launches`` counts the calls."""
    _check_qkv("flash_attention_bwd_kernel", q, k, v, (out, dout))
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    if (dout.shape != q.shape or out.shape != q.shape
            or not out.is_contiguous() or lse.shape != (B, nq, T)
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_kernel needs out and dout "
                         "shaped like q (out contiguous) and the forward's "
                         "contiguous fp32 lse (B, nq, T)")
    delta = torch.empty_like(lse)
    dq = torch.empty((B, T, nq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, nkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = _fa_launcher("flash_attention_bwd_launch")(
        *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
        *_strided(dout), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, nq, nkv, hd, int(causal),
        window, kv_len, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd_kernel")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """K2 with its backward kernel: the forward saves (q, k, v, out, lse)
    and the backward recomputes P from lse (FlashAttention-2)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, kv_len: int):
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          window=window, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, out, lse, dout,
                                                **ctx.mask)
        return dq, dk, dv, None, None, None
