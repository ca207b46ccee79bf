"""K5, paged attention: the CUDA kernel ``csrc/paged_attention.cu`` and its
plain version.

Replaces ``repro/kernels/flash_attention.py:flash_attention_paged``
(Pallas). Both versions take the model's layouts as they are stored:
q (R, T, nq, hd) and page pools (P, page, nkv, hd), with a page table
(R, n_pages) int32, global query positions q_pos (R, T) int32 and valid
row counts q_len (R,) int32. The header of the CUDA source says what
bounds the kernel on the card and how its design answers that.
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
