"""K2, flash attention (forward and backward), K4, partial flash attention
over one KV block (forward and backward), and K5, paged attention: the
CUDA kernels ``csrc/flash_attention.cu``, ``csrc/partial_attention.cu``
and ``csrc/paged_attention.cu`` and their plain versions.

K2 replaces ``repro/kernels/flash_attention.py:flash_attention`` (Pallas),
the function the JAX training path computes as ``layers.attention.
attn_core``; its backward kernel is new (the JAX package differentiates the
jnp ``attn_core``). Both versions take the model's layouts as they are
stored: q (B, T, nq, hd), k and v (B, S, nkv, hd). The plain version is
:func:`attn_core` and its backward is autograd's.

K4 replaces ``repro/kernels/flash_attention.py:flash_attention_partial``
(Pallas), whose jnp oracle is ``layers.attention.attn_core_partial``:
the fp32 carry (m, l, acc) of an online softmax in and out, unnormalised,
over one KV block at affine global positions. Context-parallel training
chains it over the blocks of an all-gathered KV (``layers.attention.
seq_attn``). Its backward kernel is new. The plain versions are
:func:`attn_core_partial` (the port of the oracle) and
:func:`partial_attention_bwd_plain`.

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
# K2's (q/k, v) widths: HEAD_DIMS, and MLA's (192, 128) with nq == nkv
K2_DIMS = ((64, 64), (128, 128), (192, 128))
MAX_PAGE = 32


def paged_attn_core(q, k, v, *, q_pos, q_len, window: int = 0,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Port of ``repro.layers.attention.paged_attn_core``: attention of
    q (R, T, nq, d) over per-slot keys k/v (R, S, nkv, dv) gathered in
    page-table order (key index j is global position j), in one fp32
    softmax over the fixed length S. Masked scores contribute exactly 0,
    and a row with no valid key gives 0. Reducing over the fixed S makes
    every chunking of a prompt reduce the same score vector per row, so
    chunked prefill equals one-shot prefill bitwise. ``return_lse``: also
    each row's fp32 log-sum-exp (R, T, nq), m + log l, NEG_INF for a row
    with no valid key."""
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
    out = o.permute(0, 3, 1, 2, 4).reshape(R, T, nq, v.shape[-1]
                                           ).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, NEG_INF))
    return out, lse.permute(0, 3, 1, 2).reshape(R, T, nq)


def paged_attention_plain(q, k_pages, v_pages, table, q_pos, q_len, *,
                          window: int = 0, return_lse: bool = False):
    """The plain version of K5, as the JAX serving path computes it: gather
    each slot's pages in table order, then :func:`paged_attn_core`."""
    R = q.shape[0]
    kc = k_pages[table.long()].reshape(R, -1, *k_pages.shape[2:])
    vc = v_pages[table.long()].reshape(R, -1, *v_pages.shape[2:])
    return paged_attn_core(q, kc, vc, q_pos=q_pos, q_len=q_len,
                           window=window, return_lse=return_lse)


def _launcher():
    """(paged_attention_launch, paged_attention_workspace) of the built
    library, typed."""
    lib = build.library("paged_attention")
    fn, work = lib.paged_attention_launch, lib.paged_attention_workspace
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, ll, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        work.argtypes = [i] * 7
        work.restype = ll
    return fn, work


def paged_attention_kernel(q, k_pages, v_pages, table, q_pos, q_len, *,
                           window: int = 0, return_lse: bool = False):
    """Launch the CUDA kernels on CUDA tensors: the split page walk, then
    the combine of each row's splits; raises on what they do not take.
    ``paged_attention_kernel.launches`` counts the calls, each one launch
    of both kernels. ``return_lse``: (out, lse), the combine also writing
    each row's fp32 log-sum-exp (R, T, nq); out has the same bits either
    way.

    The split grid and the fp32 workspace grow with the table's width,
    not with the keys the rows reach: pass only the columns that hold
    the rows' pages (the serving engine does). Columns whose keys lie past
    every row's q_pos change no bit of the output."""
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
    if (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("paged_attention_kernel needs 16-byte aligned "
                         "pools")
    launch, workspace = _launcher()
    out = torch.empty((R, T, nq, hd), dtype=q.dtype, device=q.device)
    n_pages = table.shape[1]
    work = torch.empty((workspace(R, T, nq, nkv, hd, n_pages, page),),
                       dtype=torch.float32, device=q.device)
    lse = (torch.empty((R, T, nq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    sr, st, sh, _ = q.stride()
    err = launch(
        q.data_ptr(), sr, st, sh, k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), q_pos.data_ptr(), q_len.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), work.data_ptr(), R, T, nq,
        nkv, hd, n_pages, page, P, window, 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention_kernel")
    paged_attention_kernel.launches += 1
    return (out, lse) if return_lse else out


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
            fn.argtypes = [*strided * 3, p, p, *[i] * 10, ctypes.c_float, i,
                           p]
        elif name == "flash_attention_bwd_launch":
            fn.argtypes = [*strided * 3, p, *strided, p, p, p, p, p,
                           *[i] * 10, ctypes.c_float, i, p]
        else:  # flash_attention_bwd_workspace
            fn.argtypes = [i] * 7
            fn.restype = ll
            return fn
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(what, q, k, v, extra=(), *, mla: bool = False):
    """Refuse what the attention kernels do not take; ``mla``: K2's widths
    (``K2_DIMS``), else one head_dim in HEAD_DIMS for q, k and v."""
    tensors = (q, k, v, *extra)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{what} needs all inputs on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    B, T, nq, hd = q.shape
    dv = v.shape[-1]
    dims = ((hd, dv) in K2_DIMS and (hd == dv or nq == k.shape[2])
            if mla else hd in HEAD_DIMS and dv == hd)
    if (not dims or k.shape[::3] != (B, hd) or k.shape[:3] != v.shape[:3]
            or k.shape[2] == 0 or nq % k.shape[2] or min(T, k.shape[1]) == 0):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} ((q/k, v) "
                         f"widths in {K2_DIMS if mla else HEAD_DIMS}, (192, "
                         f"128) with nq == nkv; nq a multiple of nkv, T, S "
                         f"> 0)")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{what} needs unit stride in head_dim")


def _strided(t):
    return (t.data_ptr(), *t.stride()[:3])


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           kv_len: int = 0):
    """Launch the CUDA forward on CUDA tensors; returns (out (B, T, nq, dv)
    in q's dtype, lse (B, nq, T) fp32), dv v's width (q's, or 128 beside
    MLA's q/k width 192). Raises on what it does not take.
    ``flash_attention_kernel.launches`` counts the launches."""
    _check_qkv("flash_attention_kernel", q, k, v, mla=True)
    B, T, nq, hd = q.shape
    S, nkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, T, nq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nq, T), dtype=torch.float32, device=q.device)
    err = _fa_launcher("flash_attention_fwd_launch")(
        *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
        lse.data_ptr(), B, T, S, nq, nkv, hd, dv, int(causal), window,
        kv_len, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_kernel")
    flash_attention_kernel.launches += 1
    return out, lse


flash_attention_kernel.launches = 0


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, *,
                               causal: bool = True, window: int = 0,
                               kv_len: int = 0):
    """Launch the CUDA backward on the forward's inputs, its output and
    lse, and the output's gradient ``dout``; returns (dq, dk, dv),
    contiguous, in the inputs' dtype. Raises on what it does not take.
    ``flash_attention_bwd_kernel.launches`` counts the calls, each one
    launch of its kernels (delta, dK/dV, the GQA sum where nq > nkv, dQ).

    The kernels share an fp32 workspace allocated here: delta, dS of every
    (64-query, 32-key) tile pair, which the dK/dV pass writes for the dQ
    pass (B * nq * T * S floats, padded to whole tiles: 33.5 MB at B 2,
    T = S = 512, 16 heads), and under GQA each query head's dK and dV."""
    _check_qkv("flash_attention_bwd_kernel", q, k, v, (out, dout),
               mla=True)
    B, T, nq, hd = q.shape
    S, nkv, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    if (dout.shape != (B, T, nq, dv_dim) or out.shape != dout.shape
            or not out.is_contiguous() or lse.shape != (B, nq, T)
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_kernel needs out and dout "
                         "shaped like the forward's output (out "
                         "contiguous) and its contiguous fp32 lse (B, nq, "
                         "T)")
    n_work = _fa_launcher("flash_attention_bwd_workspace")(B, T, S, nq,
                                                           nkv, hd, dv_dim)
    work = torch.empty((n_work,), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, T, nq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, nkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, nkv, dv_dim), dtype=q.dtype, device=q.device)
    err = _fa_launcher("flash_attention_bwd_launch")(
        *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
        *_strided(dout), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, nq, nkv, hd, dv_dim,
        int(causal), window, kv_len, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
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


# ---------------------------------------------------------------------- #
# K4: partial flash attention over one KV block (forward and backward)
# ---------------------------------------------------------------------- #

def attn_partial_init(B, Tq, nq, dv, *, device=None):
    """Fresh fp32 online-softmax carry (m, l, acc): m (B, nq, Tq) at
    NEG_INF, l (B, nq, Tq) and acc (B, nq, Tq, dv) at 0, the 'nothing
    attended yet' state (``repro.layers.attention.attn_partial_init``;
    its (B, nkv, g, ...) layout is this one with nq = nkv * g split)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.full((B, nq, Tq), NEG_INF, **f32),
            torch.zeros((B, nq, Tq), **f32),
            torch.zeros((B, nq, Tq, dv), **f32))


def attn_core_partial(q, k, v, carry, *, q_pos, k_pos, causal: bool = True,
                      window: int = 0, scale: Optional[float] = None,
                      bq: int = 512, bk: int = 1024):
    """Port of ``repro.layers.attention.attn_core_partial``: one partial
    online-softmax pass of q (B, Tq, nq, d) over a single KV block k/v
    (B, Tk, nkv, dv), carrying (m, l, acc) of :func:`attn_partial_init`.
    ``q_pos``/``k_pos`` (Tq,)/(Tk,) are the global positions of each local
    index (the striped layout's may be non-monotone). Chunked over (bq,
    bk) tiles, so no (Tq, Tk) score materialises. A query row whose keys
    are all masked keeps its carry bit for bit: p is zeroed under the
    mask, so a NEG_INF running max leaks no exp(0) mass into l. Written
    without in-place updates, so autograd differentiates it."""
    B, Tq, nq, d = q.shape
    Tk, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    m, l, acc = carry
    qf = q.float().reshape(B, Tq, nkv, g, d)
    kf, vf = k.float(), v.float()
    q_pos, k_pos = q_pos.to(torch.int64), k_pos.to(torch.int64)
    outs = []
    for i0 in range(0, Tq, bq):
        i1 = min(i0 + bq, Tq)
        mc = m[:, :, i0:i1].reshape(B, nkv, g, i1 - i0)
        lc = l[:, :, i0:i1].reshape(B, nkv, g, i1 - i0)
        ac = acc[:, :, i0:i1].reshape(B, nkv, g, i1 - i0, -1)
        for j0 in range(0, Tk, bk):
            j1 = min(j0 + bk, Tk)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, i0:i1],
                             kf[:, j0:j1]) * scale
            iq = q_pos[i0:i1, None]
            jk = k_pos[None, j0:j1]
            mask = (iq >= jk) | (not causal)
            if window > 0:
                mask = mask & ((iq - jk) < window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(mc, torch.amax(s, dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            alpha = torch.exp(mc - m_new)
            lc = alpha * lc + torch.sum(p, dim=-1)
            ac = alpha[..., None] * ac + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, j0:j1])
            mc = m_new
        outs.append((mc, lc, ac))
    m, l, acc = (torch.cat([o[i] for o in outs], dim=3) for i in range(3))
    return (m.reshape(B, nq, Tq), l.reshape(B, nq, Tq),
            acc.reshape(B, nq, Tq, -1))


def attn_partial_finalize(carry, dtype):
    """Normalise a chained (m, l, acc) carry into the (B, Tq, nq, dv)
    attention output."""
    _, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B, nq, T, dv)
    return out.transpose(1, 2).contiguous().to(dtype)


def _positions(n, pos0, stride, device):
    return pos0 + stride * torch.arange(n, dtype=torch.int64, device=device)


def partial_attention_plain(q, k, v, m, l, acc, *, q_pos0: int = 0,
                            q_stride: int = 1, k_pos0: int = 0,
                            k_stride: int = 1, causal: bool = True,
                            window: int = 0, q_len: int = 0,
                            kv_len: int = 0):
    """The plain version of K4: :func:`attn_core_partial` with the affine
    global positions ``pos0 + i * stride``. Keys at or past ``kv_len``
    (> 0) are masked and rows at or past ``q_len`` (> 0) keep their carry,
    as the Pallas kernel masks block padding. Returns (m, l, acc)."""
    T, S = q.shape[1], k.shape[1]
    tq, sk = min(q_len or T, T), min(kv_len or S, S)
    carry = (m[:, :, :tq], l[:, :, :tq], acc[:, :, :tq])
    if sk:
        carry = attn_core_partial(
            q[:, :tq], k[:, :sk], v[:, :sk], carry,
            q_pos=_positions(tq, q_pos0, q_stride, q.device),
            k_pos=_positions(sk, k_pos0, k_stride, q.device),
            causal=causal, window=window)
    if tq == T:
        return carry
    return tuple(torch.cat([c, full[:, :, tq:]], dim=2)
                 for c, full in zip(carry, (m, l, acc)))


def partial_attention_bwd_plain(q, k, v, dout, lse, delta, dq, *,
                                close=None, dk=None, dv=None,
                                q_pos0: int = 0, q_stride: int = 1,
                                k_pos0: int = 0, k_stride: int = 1,
                                causal: bool = True, window: int = 0,
                                q_len: int = 0, kv_len: int = 0):
    """The plain version of K4's backward: one KV block's share of the
    gradient of a chain of partial passes, given the chain's final ``lse``
    (B, nq, T) = m + log l and ``delta`` (B, nq, T) = rowsum(dO * O) in
    fp32 (FlashAttention-2): P = exp(S - lse) under the block's masks,
    dV = P^T dO, dS = P (dO V^T - delta), dQ += dS K scale, dK = dS^T Q
    scale. The chain's first call gives ``close`` = (out, m, l), the
    finalised output (B, T, nq, hd) and the final m, l (B, nq, T), and
    ``lse`` and ``delta`` are written from them first. Adds into ``dq``
    (B, T, nq, hd) fp32 in place; returns (dk, dv) of the block, (B, S,
    nkv, hd) fp32, written into ``dk``/``dv`` where given."""
    B, T, nq, d = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = 1.0 / math.sqrt(d)
    if close is not None:
        out, m, l = close
        lse.copy_(torch.where(l > 0, m + torch.log(l),
                              torch.full_like(m, NEG_INF)))
        delta.copy_((dout.float() * out.float()).sum(-1).transpose(1, 2))
    qf = q.float().reshape(B, T, nkv, g, d)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, T, nkv, g, d)
    iq = _positions(T, q_pos0, q_stride, q.device)[:, None]
    jk = _positions(S, k_pos0, k_stride, q.device)[None, :]
    mask = ((torch.arange(T, device=q.device)[:, None] < (q_len or T))
            & (torch.arange(S, device=q.device)[None, :] < (kv_len or S)))
    if causal:
        mask &= iq >= jk
    if window > 0:
        mask &= (iq - jk) < window
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    lse_g = lse.reshape(B, nkv, g, T)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), torch.zeros_like(s))
    dv_b = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.reshape(B, nkv, g, T)[..., None])
    dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, T, nq,
                                                            d) * scale
    dk_b = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    if dk is not None:
        dk_b = dk.copy_(dk_b)
    if dv is not None:
        dv_b = dv.copy_(dv_b)
    return dk_b, dv_b


def _pa_launcher(name: str):
    fn = getattr(build.library("partial_attention"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strided = [p, ll, ll, ll]
        # batch, n_t, n_s, nq, nkv, head_dim, then the 8 of _pos_args
        tail = [i] * 14 + [ctypes.c_float, i, p]
        if name == "partial_attention_fwd_launch":
            fn.argtypes = [*strided * 3, *[p] * 6, *tail]
        elif name == "partial_attention_bwd_launch":
            fn.argtypes = [*strided * 4, *[p] * 9, ll, *tail]
        else:  # partial_attention_bwd_workspace
            fn.argtypes = [i] * 6
            fn.restype = ll
            return fn
        fn.restype = ctypes.c_int
    return fn


def _check_partial(what, q, k, v, carry, pos, extra=()):
    """Raise on what K4 does not take: the K2 checks on q, k, v (and
    ``extra``); fp32 contiguous (B, nq, T) rows and (B, nq, T, hd) or (B,
    T, nq, hd) blocks in ``carry``; strides of at least 1."""
    _check_qkv(what, q, k, v, extra)
    for name, t, shape in carry:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous fp32 "
                             f"{shape} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if pos["q_stride"] < 1 or pos["k_stride"] < 1:
        raise ValueError(f"{what} takes positions pos0 + i * stride with "
                         f"stride >= 1, got {pos}")


def _pos_args(q_pos0, q_stride, k_pos0, k_stride, q_len, kv_len, causal,
              window):
    return [q_pos0, q_stride, k_pos0, k_stride, q_len, kv_len, int(causal),
            window]


def partial_attention_kernel(q, k, v, m, l, acc, *, q_pos0: int = 0,
                             q_stride: int = 1, k_pos0: int = 0,
                             k_stride: int = 1, causal: bool = True,
                             window: int = 0, q_len: int = 0,
                             kv_len: int = 0):
    """Launch K4's forward on CUDA tensors: q (B, T, nq, hd) and k, v (B,
    S, nkv, hd) in the model's layouts through strides, the carry m, l
    (B, nq, T) and acc (B, nq, T, hd) fp32; returns the new (m, l, acc).
    Raises on what it does not take. ``partial_attention_kernel.launches``
    counts the launches."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    pos = dict(q_pos0=q_pos0, q_stride=q_stride, k_pos0=k_pos0,
               k_stride=k_stride, q_len=q_len, kv_len=kv_len, causal=causal,
               window=window)
    _check_partial("partial_attention_kernel", q, k, v,
                   [("m", m, (B, nq, T)), ("l", l, (B, nq, T)),
                    ("acc", acc, (B, nq, T, hd))], pos)
    if acc.data_ptr() % 16:
        raise ValueError("partial_attention_kernel needs a 16-byte aligned "
                         "acc")
    out = (torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc))
    err = _pa_launcher("partial_attention_fwd_launch")(
        *_strided(q), *_strided(k), *_strided(v), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), *(t.data_ptr() for t in out),
        B, T, S, nq, nkv, hd, *_pos_args(**pos), 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "partial_attention_kernel")
    partial_attention_kernel.launches += 1
    return out


partial_attention_kernel.launches = 0


def partial_attention_bwd_kernel(q, k, v, dout, lse, delta, dq, *,
                                 close=None, dk=None, dv=None,
                                 q_pos0: int = 0, q_stride: int = 1,
                                 k_pos0: int = 0, k_stride: int = 1,
                                 causal: bool = True, window: int = 0,
                                 q_len: int = 0, kv_len: int = 0):
    """Launch K4's backward on CUDA tensors (the arguments of
    :func:`partial_attention_bwd_plain`; ``dout`` through strides, shaped
    like q; in ``close`` the output contiguous in q's dtype and m, l
    contiguous fp32; ``dk``/``dv`` (B, S, nkv, hd) fp32 views with any
    batch stride, contiguous within a batch row, such as one block's slice
    of the gathered keys' gradient): adds the block's share into ``dq``
    (B, T, nq, hd) fp32 and returns its (dk, dv). Raises on what it does
    not take. ``partial_attention_bwd_kernel.launches`` counts the calls,
    each one launch of K2's backward kernels (delta and lse where
    ``close`` is given, dK/dV, the GQA sum where nq > nkv, dQ).

    The kernels share an fp32 workspace allocated here: dS of every
    (64-query, 32-key) tile pair (B * nq * T * S floats, padded to whole
    tiles: 8.4 MB at B 2, T = S = 256, 16 heads) and under GQA each query
    head's dK and dV (8.4 MB more at 16/8 heads, hd 128)."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    pos = dict(q_pos0=q_pos0, q_stride=q_stride, k_pos0=k_pos0,
               k_stride=k_stride, q_len=q_len, kv_len=kv_len, causal=causal,
               window=window)
    rows = [("lse", lse, (B, nq, T)), ("delta", delta, (B, nq, T)),
            ("dq", dq, (B, T, nq, hd))]
    if close is not None:
        rows += [("m", close[1], (B, nq, T)), ("l", close[2], (B, nq, T))]
    _check_partial("partial_attention_bwd_kernel", q, k, v, rows, pos,
                   (dout,) + tuple(close[:1] if close else ()))
    if dout.shape != q.shape or (close and not (
            close[0].shape == q.shape and close[0].is_contiguous())):
        raise ValueError("partial_attention_bwd_kernel: dout and the "
                         "chain's output must be shaped like q "
                         f"{tuple(q.shape)}, the output contiguous")
    if dk is None:
        dk = torch.empty((B, S, nkv, hd), dtype=torch.float32,
                         device=q.device)
    if dv is None:
        dv = torch.empty_like(dk)
    for name, t in (("dk", dk), ("dv", dv)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, S, nkv, hd)
                or t.stride()[1:] != (nkv * hd, hd, 1)
                or t.stride(0) != dk.stride(0)):
            raise ValueError(f"partial_attention_bwd_kernel: {name} must be "
                             f"fp32 ({B}, {S}, {nkv}, {hd}) on {q.device}, "
                             f"contiguous within a batch row, at dk's "
                             f"batch stride")
    if dq.data_ptr() % 16:
        raise ValueError("partial_attention_bwd_kernel needs a 16-byte "
                         "aligned dq")
    n_work = _pa_launcher("partial_attention_bwd_workspace")(B, T, S, nq,
                                                             nkv, hd)
    work = torch.empty((n_work,), dtype=torch.float32, device=q.device)
    chain = [t.data_ptr() for t in close] if close else [None] * 3
    err = _pa_launcher("partial_attention_bwd_launch")(
        *_strided(q), *_strided(k), *_strided(v), *_strided(dout), *chain,
        lse.data_ptr(), delta.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dk.stride(0), B, T, S, nq, nkv, hd,
        *_pos_args(**pos), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "partial_attention_bwd_kernel")
    partial_attention_bwd_kernel.launches += 1
    return dk, dv


partial_attention_bwd_kernel.launches = 0
