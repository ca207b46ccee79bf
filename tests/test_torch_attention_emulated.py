"""K5's, K2's and K4's CUDA sources run on the CPU.

``csrc/paged_attention.cu`` (K5: the split page walk and the combine of
each row's splits), ``csrc/flash_attention.cu`` (K2, forward and backward)
and ``csrc/partial_attention.cu`` (K4, forward and backward) are compiled with
g++ against the CPU stand-ins of ``tests/cuda_emu/`` (one thread per CUDA
thread, blocks in turn) and launched through their C interfaces on CPU
tensors. Each case is held to the plain version with the card's
tolerances (``chip_smoke.py``'s PAGED_TOL and FLASH_TOL, and K4's carry and
gradients to 1e-4 of their largest entry) and must repeat bitwise; K5's
chunked prefill must equal one-shot prefill bitwise. The workspaces K5
and the backwards are given, and every output, start as NaN, so a read of
an entry that no block wrote shows. This checks the kernels' indexing and
arithmetic, not their speed or their behaviour under the real compiler;
the card runs the same sources in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from cuda_emu import compile_source
from repro_torch.kernels.flash_attention import (
    NEG_INF, attn_partial_finalize, attn_partial_init, paged_attention_plain,
    partial_attention_bwd_plain, partial_attention_plain)

F32, BF16 = torch.float32, torch.bfloat16
DTYPE = {F32: 0, BF16: 1}
# chip_smoke.py's tolerances: K5 as torch.allclose(rtol = atol = tol), K2
# as max|kernel - plain| <= tol * max|plain|
PAGED_TOL = {F32: 1e-4, BF16: 2e-2}
FLASH_TOL = {F32: 1e-4, BF16: 2e-2}


# ---------------------------------------------------------------------- #
# K5
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def paged(tmp_path_factory):
    lib = compile_source("paged_attention",
                         tmp_path_factory.mktemp("k5_emulated"))
    fn, work = lib.paged_attention_launch, lib.paged_attention_workspace
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, ll, ll, p, p, p, p, p, p, p, p,
                   i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    work.argtypes = [i] * 7
    work.restype = ll

    def run(q, kp, vp, table, q_pos, q_len, window=0, return_lse=False):
        R, T, nq, hd = q.shape
        P, page, nkv, _ = kp.shape
        n_tab = table.shape[1]
        ws = torch.full((work(R, T, nq, nkv, hd, n_tab, page),), math.nan)
        out = torch.full_like(q, math.nan)
        lse = torch.full((R, T, nq), math.nan) if return_lse else None
        err = fn(q.data_ptr(), *q.stride()[:3], kp.data_ptr(), vp.data_ptr(),
                 table.data_ptr(), q_pos.data_ptr(), q_len.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(),
                 ws.data_ptr(), R, T, nq, nkv, hd, n_tab, page, P, window,
                 1.0 / math.sqrt(hd), DTYPE[q.dtype], None)
        assert err == 0
        return (out, lse) if return_lse else out
    return run


def paged_inputs(seed, *, T, g, hd, dtype, ctx, q_len, page=16, nkv=2,
                 bad_entries=False):
    """Slot r holds ctx[r] keys after this step; its q_len[r] valid rows
    are the last of them (positions past the row count continue, clipped
    to the table's capacity). Pools are random everywhere, so the null
    page 0 and unreferenced pages hold stale data. ``bad_entries`` puts
    page ids past the pool and below 0 into used table entries. q is a
    strided view (rows of a wider buffer)."""
    rng = np.random.RandomState(seed)
    R, nq = len(ctx), g * nkv
    used = [-(-c // page) for c in ctx]
    n_tab, P = max(used) + 1, sum(used) + 3
    kp, vp = (torch.from_numpy(rng.randn(P, page, nkv, hd)).to(dtype)
              for _ in range(2))
    table = np.zeros((R, n_tab), np.int32)
    ids = iter(rng.permutation(np.arange(1, P)))
    for r, n in enumerate(used):
        table[r, :n] = [next(ids) for _ in range(n)]
    if bad_entries:
        table[0, 0], table[-1, used[-1] - 1] = P + 5, -3
    q_pos = np.zeros((R, T), np.int32)
    for r, (c, n) in enumerate(zip(ctx, q_len)):
        if n:
            q_pos[r] = np.minimum(c - n + np.arange(T), n_tab * page - 1)
    wide = torch.from_numpy(rng.randn(R, T, nq, hd + 32)).to(dtype)
    return (wide[..., 16:16 + hd], kp, vp, torch.from_numpy(table),
            torch.from_numpy(q_pos), torch.tensor(q_len, dtype=torch.int32))


# (T, g, hd, dtype, page, window, ctx, q_len, bad table entries). Splits
# hold 64 keys at pages 8, 16 and 32, 48 at page 24. Decode rows end
# exactly on a split's last key (ctx 64: q_pos 63) and first key (ctx 65);
# windows cross split boundaries; a slot has q_len 0.
PAGED_CASES = {
    "decode g2 hd128 f32": (1, 2, 128, F32, 16, 0, [64, 65, 200, 1, 9],
                            [1, 1, 1, 1, 0], False),
    "decode g4 hd64 bf16 window 20": (1, 4, 64, BF16, 16, 20,
                                      [70, 64, 130, 5], [1, 1, 1, 1], False),
    "decode g2 hd128 bf16 page 32": (1, 2, 128, BF16, 32, 0,
                                     [33, 128, 129, 300], [1, 1, 1, 1],
                                     False),
    "chunk T5 g2 hd64 f32 bad entries": (5, 2, 64, F32, 16, 0,
                                         [66, 20, 150], [5, 3, 5], True),
    "chunk T7 g4 hd128 bf16 window 30": (7, 4, 128, BF16, 16, 30,
                                         [70, 129, 0, 40], [7, 7, 0, 2],
                                         False),
    "chunk T20 g2 hd128 f32 page 8": (20, 2, 128, F32, 8, 0,
                                      [80, 135, 20], [20, 20, 11], False),
    "chunk T3 g2 hd64 f32 page 24": (3, 2, 64, F32, 24, 50,
                                     [49, 97, 145], [3, 2, 3], False),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_k5_source_matches_plain_on_the_cpu(paged, case):
    T, g, hd, dtype, page, window, ctx, q_len, bad = PAGED_CASES[case]
    args = paged_inputs(len(case), T=T, g=g, hd=hd, dtype=dtype, ctx=ctx,
                        q_len=q_len, page=page, bad_entries=bad)
    q, kp, vp, table, q_pos, ql = args
    got = paged(*args, window=window)
    clamped = table.clamp(0, kp.shape[0] - 1)     # as a jnp gather clamps
    want = paged_attention_plain(q, kp, vp, clamped, q_pos, ql,
                                 window=window)
    rows = torch.arange(T)[None, :] < ql[:, None]
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               rtol=tol, atol=tol)
    assert not got[~rows].any()                   # 0, not NaN
    assert torch.equal(paged(*args, window=window), got)


@pytest.mark.parametrize("window", [0, 24])
def test_k5_source_chunks_equal_one_shot_bitwise(paged, window):
    """Slot 0's rows sit at positions 60..79: the second chunk starts at
    position 64, a split boundary; the other slots' boundaries fall
    elsewhere."""
    args = paged_inputs(5, T=20, g=2, hd=64, dtype=F32,
                        ctx=[80, 150, 33], q_len=[20, 20, 9])
    q, kp, vp, table, q_pos, q_len = args
    full = paged(*args, window=window)
    for c0, c1 in ((0, 4), (4, 11), (11, 20)):
        ql = torch.clamp(q_len - c0, 0, c1 - c0).to(torch.int32)
        part = paged(q[:, c0:c1], kp, vp, table,
                     q_pos[:, c0:c1].contiguous(), ql, window=window)
        rows = torch.arange(c1 - c0)[None] < ql[:, None]
        assert torch.equal(part[rows], full[:, c0:c1][rows])
    assert int(q_pos[0, 4]) == 64


@pytest.mark.parametrize("T,window", [(1, 0), (7, 30)])
def test_k5_source_ignores_table_columns_past_the_rows(paged, T, window):
    """A table 40 columns wider than the rows' pages, the extra columns
    holding other page ids, gives the same bits as the columns in use
    (what the serving engine sends)."""
    args = paged_inputs(9, T=T, g=2, hd=64, dtype=F32, ctx=[70, 129, 0, 40],
                        q_len=[T, T, 0, min(T, 2)])
    q, kp, vp, table, q_pos, ql = args
    extra = torch.randint(0, kp.shape[0], (table.shape[0], 40),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    wide = torch.cat([table, extra], 1).contiguous()
    assert torch.equal(paged(q, kp, vp, wide, q_pos, ql, window=window),
                       paged(*args, window=window))


# (T, g, hd, dtype, page, window, ctx, q_len, shift): the rows' q_pos
# less ``shift``, as a shard of a sequence-sharded cache sees the query:
# decode and chunked rows, q_len 0, a position below 0 (a shard past the
# query, no key: lse NEG_INF), one past the table (every key), windows
# across split boundaries
LSE_CASES = {
    "decode g2 hd128 f32": (1, 2, 128, F32, 16, 0, [64, 65, 200, 1, 9],
                            [1, 1, 1, 1, 0], [0, 0, 0, 0, 0]),
    "decode g4 hd128 f32 negative and past the table": (
        1, 4, 128, F32, 32, 0, [64, 96, 40, 33], [1, 1, 1, 1],
        [70, 0, -500, 1]),
    "decode g4 hd64 bf16 window 20": (1, 4, 64, BF16, 16, 20,
                                      [70, 64, 130, 5], [1, 1, 1, 1],
                                      [0, -10, 3, 0]),
    "chunk T7 g2 hd128 f32 window 30": (7, 2, 128, F32, 16, 30,
                                        [70, 129, 0, 40], [7, 7, 0, 2],
                                        [0, 0, 0, 0]),
    "chunk T5 g2 hd64 f32 rows below 0": (5, 2, 64, F32, 16, 0,
                                          [66, 20, 150], [5, 3, 5],
                                          [64, 0, -40]),
}


@pytest.mark.parametrize("case", sorted(LSE_CASES))
def test_k5_source_lse_matches_the_plain_log_sum_exp(paged, case):
    """The combine's lse against the plain version's m + log l (NEG_INF
    where a row sees no key), and the output bitwise the call without the
    lse pointer."""
    T, g, hd, dtype, page, window, ctx, q_len, shift = LSE_CASES[case]
    q, kp, vp, table, q_pos, ql = paged_inputs(
        len(case), T=T, g=g, hd=hd, dtype=dtype, ctx=ctx, q_len=q_len,
        page=page)
    q_pos = (q_pos - torch.tensor(shift, dtype=torch.int32)[:, None]
             ).contiguous()
    args = (q, kp, vp, table, q_pos, ql)
    out, lse = paged(*args, window=window, return_lse=True)
    assert torch.equal(out, paged(*args, window=window))
    want, want_lse = paged_attention_plain(*args, window=window,
                                           return_lse=True)
    rows = torch.arange(T)[None, :] < ql[:, None]
    tol = PAGED_TOL[dtype]
    torch.testing.assert_close(out[rows].float(), want[rows].float(),
                               rtol=tol, atol=tol)
    empty = want_lse == NEG_INF
    assert torch.equal(lse == NEG_INF, empty)
    assert empty[~rows].all() and not out[~rows].any()
    torch.testing.assert_close(lse[~empty], want_lse[~empty], rtol=1e-5,
                               atol=1e-5)
    # a row below every key of the table sees none; past it, all of them
    below = (q_pos < 0) & rows
    assert empty[below].all() and not out[below].any()
    past = (q_pos >= table.shape[1] * page) & rows
    if window == 0 and past.any():
        full = paged_attention_plain(q, kp, vp, table, torch.full_like(
            q_pos, table.shape[1] * page - 1), ql, return_lse=True)[1]
        torch.testing.assert_close(lse[past], full[past], rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(paged(*args, window=window, return_lse=True)[1], lse)


# ---------------------------------------------------------------------- #
# K2
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def flash(tmp_path_factory):
    lib = compile_source("flash_attention",
                         tmp_path_factory.mktemp("k2_emulated"))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strided = [p, ll, ll, ll]
    fwd, bwd = lib.flash_attention_fwd_launch, lib.flash_attention_bwd_launch
    fwd.argtypes = [*strided * 3, p, p, *[i] * 9, ctypes.c_float, i, p]
    bwd.argtypes = [*strided * 3, p, *strided, p, p, p, p, p, *[i] * 9,
                    ctypes.c_float, i, p]
    fwd.restype = bwd.restype = ctypes.c_int
    work = lib.flash_attention_bwd_workspace
    work.argtypes = [i] * 6
    work.restype = ll

    def tail(q, k, causal, window, kv_len):
        B, T, nq, hd = q.shape
        return [B, T, k.shape[1], nq, k.shape[2], hd, int(causal), window,
                kv_len, 1.0 / math.sqrt(hd), DTYPE[q.dtype], None]

    def strided_args(t):
        return [t.data_ptr(), *t.stride()[:3]]

    def forward(q, k, v, causal, window, kv_len):
        B, T, nq, hd = q.shape
        out = torch.full((B, T, nq, hd), math.nan).to(q.dtype)
        lse = torch.full((B, nq, T), math.nan)
        assert fwd(*strided_args(q), *strided_args(k), *strided_args(v),
                   out.data_ptr(), lse.data_ptr(),
                   *tail(q, k, causal, window, kv_len)) == 0
        return out, lse

    def backward(q, k, v, out, lse, dout, causal, window, kv_len):
        B, T, nq, hd = q.shape
        ws = torch.full((work(B, T, k.shape[1], nq, k.shape[2], hd),),
                        math.nan)
        dq = torch.full_like(out, math.nan)
        dk, dv = (torch.full(k.shape, math.nan).to(k.dtype)
                  for _ in range(2))
        assert bwd(*strided_args(q), *strided_args(k), *strided_args(v),
                   out.data_ptr(), *strided_args(dout), lse.data_ptr(),
                   ws.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), *tail(q, k, causal, window, kv_len)) == 0
        return dq, dk, dv
    return forward, backward


def flash_inputs(seed, B, T, S, nq, nkv, hd, dtype, shift):
    """q, k, v in the model's (B, T, H, hd) layouts as views of wider rows
    (head stride hd + 8); ``shift`` 1 moves every row off 16 bytes, which
    sends the kernel to its element-wise loads."""
    rng = np.random.RandomState(seed)

    def rand(n, h):
        wide = torch.from_numpy(rng.randn(B, n, h, hd + 8)).to(dtype)
        return wide[..., shift:shift + hd]
    return rand(T, nq), rand(S, nkv), rand(S, nkv)


def plain_lse(q, k, causal, window, kv_len):
    """Each row's log-sum-exp of its visible scaled scores (fp32), NEG_INF
    for a row with none, as the kernel writes it for the backward."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, T, nkv, nq // nkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    i, j = torch.arange(T)[:, None], torch.arange(S)[None, :]
    vis = (j < (kv_len or S)).expand(T, S).clone()
    if causal:
        vis &= i >= j
    if window:
        vis &= (i - j) < window
    lse = torch.logsumexp(s.masked_fill(~vis, -math.inf), dim=-1)
    return torch.where(vis.any(-1), lse, torch.full_like(lse, -1e30)
                       ).reshape(B, nq, T)


# (B, T, S, nq, nkv, hd, causal, window, kv_len, dtype, shift): T not a
# multiple of the 64-row tile, T = 1, g 1, 2 and 4, kv_len < S, windows,
# and 16-byte aligned as well as unaligned rows
FLASH_CASES = {
    "causal g2 hd128 f32 T 130": (1, 130, 130, 4, 2, 128, True, 0, 0, F32,
                                  0),
    "causal g4 hd64 bf16 window 40": (2, 100, 100, 4, 1, 64, True, 40, 0,
                                      BF16, 0),
    "kv_len 61 of 90 g2 hd128 f32 T 70": (1, 70, 90, 4, 2, 128, False, 0,
                                          61, F32, 0),
    "T 1 g2 hd64 f32": (2, 1, 77, 4, 2, 64, False, 0, 0, F32, 0),
    "causal g2 hd128 bf16 T 64": (1, 64, 64, 4, 2, 128, True, 0, 0, BF16,
                                  0),
    "unaligned causal g1 hd128 f32": (1, 80, 80, 2, 2, 128, True, 0, 0, F32,
                                      1),
    "unaligned kv_len 50 of 70 g2 hd64 bf16": (1, 65, 70, 4, 2, 64, False,
                                               0, 50, BF16, 1),
}


def _rel_close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_k2_forward_source_matches_plain_on_the_cpu(flash, case):
    from repro_torch.kernels.flash_attention import attn_core
    B, T, S, nq, nkv, hd, causal, window, kv_len, dtype, shift = \
        FLASH_CASES[case]
    q, k, v = flash_inputs(len(case), B, T, S, nq, nkv, hd, dtype, shift)
    forward, _ = flash
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    out, lse = forward(q, k, v, causal, window, kv_len)
    _rel_close(out, attn_core(q, k, v, **kw), FLASH_TOL[dtype])
    want = plain_lse(q, k, causal, window, kv_len)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)
    again, lse2 = forward(q, k, v, causal, window, kv_len)
    assert torch.equal(out, again) and torch.equal(lse, lse2)


# the backward's own cases beside FLASH_CASES: a window without the causal
# mask, S > T under it, and the first port's one case (B, T, S, nq, nkv,
# hd, causal, window, kv_len, dtype, shift)
BWD_CASES = dict(FLASH_CASES, **{
    "non-causal window 20 g4 hd128 f32": (1, 70, 70, 4, 1, 128, False, 20,
                                          0, F32, 0),
    "causal S 100 > T 40 g2 hd64 bf16": (2, 40, 100, 4, 2, 64, True, 0, 0,
                                         BF16, 0),
    "causal g2 hd64 f32 T 70": (1, 70, 70, 4, 2, 64, True, 0, 0, F32, 0),
})


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_k2_backward_source_matches_autograd_on_the_cpu(flash, case):
    """dq, dk and dv against autograd of the plain attn_core: windows,
    kv_len < S, T not a multiple of the 64-row tile, non-causal, GQA g 1,
    2 and 4, head_dim 64 and 128, float32 and bfloat16, rows on and off 16
    bytes. The workspace and the outputs start as NaN, so a read of an
    entry no block wrote shows; a second call gives the same bits."""
    from repro_torch.kernels.flash_attention import attn_core
    B, T, S, nq, nkv, hd, causal, window, kv_len, dtype, shift = \
        BWD_CASES[case]
    forward, backward = flash
    q, k, v = flash_inputs(len(case) + 7, B, T, S, nq, nkv, hd, dtype, shift)
    dout = torch.from_numpy(np.random.RandomState(len(case)).randn(
        B, T, nq, hd + 8)).to(dtype)[..., shift:shift + hd]
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    out, lse = forward(q, k, v, causal, window, kv_len)
    grads = backward(q, k, v, out, lse, dout, causal, window, kv_len)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attn_core(*leaves, **kw), leaves, dout)
    for g, w in zip(grads, want):
        assert g.dtype == dtype and not g.float().isnan().any()
        _rel_close(g, w, FLASH_TOL[dtype])
    again = backward(q, k, v, out, lse, dout, causal, window, kv_len)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


# ---------------------------------------------------------------------- #
# K4
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def k4_lib(tmp_path_factory):
    return compile_source("partial_attention",
                          tmp_path_factory.mktemp("k4_emulated"))


@pytest.fixture(scope="module")
def partial(k4_lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = k4_lib.partial_attention_fwd_launch
    fwd.argtypes = [*[p, ll, ll, ll] * 3, *[p] * 6, *[i] * 14,
                    ctypes.c_float, i, p]
    fwd.restype = ctypes.c_int

    def run(q, k, v, m, l, acc, *, q_pos0=0, q_stride=1, k_pos0=0,
            k_stride=1, causal=True, window=0, q_len=0, kv_len=0):
        B, T, nq, hd = q.shape
        out = [torch.full_like(t, math.nan) for t in (m, l, acc)]
        assert fwd(q.data_ptr(), *q.stride()[:3], k.data_ptr(),
                   *k.stride()[:3], v.data_ptr(), *v.stride()[:3],
                   m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                   *(t.data_ptr() for t in out), B, T, k.shape[1], nq,
                   k.shape[2], hd, q_pos0, q_stride, k_pos0, k_stride, q_len,
                   kv_len, int(causal), window, 1.0 / math.sqrt(hd),
                   DTYPE[q.dtype], None) == 0
        return out
    return run


def partial_inputs(seed, B, T, S, nq, nkv, hd, dtype, shift):
    """q (B, T, nq, hd), two KV blocks k0/v0 and k/v (B, S, nkv, hd) as
    views of wider rows (``shift`` 1: off 16 bytes), and the carry of the
    plain pass over the first block (keys at 2 j, queries at 2 i + 1):
    rows that saw no key of it keep m = NEG_INF."""
    q, k0, v0 = flash_inputs(seed, B, T, S, nq, nkv, hd, dtype, shift)
    _, k, v = flash_inputs(seed + 1, B, T, S, nq, nkv, hd, dtype, shift)
    carry = partial_attention_plain(q, k0, v0,
                                    *attn_partial_init(B, T, nq, hd),
                                    q_pos0=1, q_stride=2, k_stride=2,
                                    window=9)
    return q, k, v, [c.contiguous() for c in carry]


# (B, T, S, nq, nkv, hd, dtype, shift, positions and masks): the seq path's
# striped blocks (queries at 2 i + r, keys at 2 j + rho) with r and rho 0
# and 1, causal or not, windows, q_len and kv_len cutting tiles, g 1 and 2,
# head_dim 64 and 128, bf16, rows off 16 bytes
PARTIAL_CASES = {
    "stride 2 r 1 rho 0 g2 hd128 f32": (
        1, 70, 90, 4, 2, 128, F32, 0,
        dict(q_pos0=1, q_stride=2, k_pos0=0, k_stride=2)),
    "stride 2 r 0 rho 1 g2 hd64 bf16": (
        2, 64, 64, 4, 2, 64, BF16, 0,
        dict(q_pos0=0, q_stride=2, k_pos0=1, k_stride=2)),
    "stride 2 window 40 q_len 50 kv_len 70 g1 hd128 f32": (
        1, 66, 80, 2, 2, 128, F32, 0,
        dict(q_pos0=1, q_stride=2, k_pos0=1, k_stride=2, window=40,
             q_len=50, kv_len=70)),
    "later block, keys 128 on, window 100 g2 hd64 f32": (
        1, 40, 70, 4, 2, 64, F32, 0,
        dict(q_pos0=128, k_pos0=64, window=100)),
    "non-causal unaligned kv_len 33 g2 hd128 bf16": (
        1, 35, 65, 4, 2, 128, BF16, 1,
        dict(q_pos0=3, q_stride=2, k_pos0=0, k_stride=2, causal=False,
             kv_len=33)),
}


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
def test_k4_forward_source_matches_plain_on_the_cpu(partial, case):
    B, T, S, nq, nkv, hd, dtype, shift, pos = PARTIAL_CASES[case]
    q, k, v, carry = partial_inputs(len(case), B, T, S, nq, nkv, hd, dtype,
                                    shift)
    got = partial(q, k, v, *carry, **pos)
    want = partial_attention_plain(q, k, v, *carry, **pos)
    for g, w in zip(got, want):
        _rel_close(g, w, 1e-4)
    rows = T if not pos.get("q_len") else pos["q_len"]
    for g, c in zip(got, carry):           # rows past q_len: carried as is
        assert torch.equal(g[:, :, rows:], c[:, :, rows:])
    again = partial(q, k, v, *carry, **pos)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_k4_forward_source_keeps_a_masked_rows_carry(partial):
    """Queries at 0, 2, 4, ... against keys at 1, 3, 5, ...: query 0 sees
    no key of the block and keeps its carry bit for bit, the rows past
    q_len too, and the others move."""
    q, k, v, carry = partial_inputs(11, 2, 70, 70, 4, 2, 128, F32, 0)
    got = partial(q, k, v, *carry, q_stride=2, k_pos0=1, k_stride=2,
                  q_len=60)
    for g, c in zip(got, carry):
        assert torch.equal(g[:, :, 0], c[:, :, 0])
        assert torch.equal(g[:, :, 60:], c[:, :, 60:])
        assert not torch.equal(g[:, :, 1:60], c[:, :, 1:60])


@pytest.fixture(scope="module")
def partial_bwd(k4_lib):
    """K4's backward through its C interface: the workspace (from
    partial_attention_bwd_workspace) and delta start as NaN, dk and dv are
    the second half of NaN buffers twice as long (a batch stride of 2 S
    rows), whose first half must stay NaN."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn, work = (k4_lib.partial_attention_bwd_launch,
                k4_lib.partial_attention_bwd_workspace)
    fn.argtypes = [*[p, ll, ll, ll] * 4, *[p] * 9, ll, *[i] * 14,
                   ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    work.argtypes = [i] * 6
    work.restype = ll

    def run(q, k, v, dout, lse, delta, dq, *, close=None, q_pos0=0,
            q_stride=1, k_pos0=0, k_stride=1, causal=True, window=0,
            q_len=0, kv_len=0):
        B, T, nq, hd = q.shape
        S, nkv = k.shape[1], k.shape[2]
        ws = torch.full((work(B, T, S, nq, nkv, hd),), math.nan)
        dk, dv = (torch.full((B, 2 * S, nkv, hd), math.nan)
                  for _ in range(2))
        assert fn(*(x for t in (q, k, v, dout)
                    for x in (t.data_ptr(), *t.stride()[:3])),
                  *([t.data_ptr() for t in close] if close else [None] * 3),
                  lse.data_ptr(), delta.data_ptr(), ws.data_ptr(),
                  dq.data_ptr(),
                  dk[:, S:].data_ptr(), dv[:, S:].data_ptr(), dk.stride(0),
                  B, T, S, nq, nkv, hd, q_pos0, q_stride, k_pos0, k_stride,
                  q_len, kv_len, int(causal), window, 1.0 / math.sqrt(hd),
                  DTYPE[q.dtype], None) == 0
        assert dk[:, :S].isnan().all() and dv[:, :S].isnan().all()
        return dk[:, S:], dv[:, S:]
    return run


def chain_state(q, k, v, carry, pos):
    """The chain closed after this block: its final m and l, and the
    finalised output in q's dtype."""
    m, l, acc = partial_attention_plain(q, k, v, *carry, **pos)
    return (m.contiguous(), l.contiguous(),
            attn_partial_finalize((m, l, acc), q.dtype))


# (B, T, S, nq, nkv, hd, dtype, shift, positions and masks): ranks r 0 and 1
# x blocks rho 0 and 1 at stride 2, a window of 128, q_len and kv_len
# cutting tiles, T and S not multiples of 32, g 1 and 2, head_dim 64 and
# 128, float32 and bfloat16, rows off 16 bytes
PARTIAL_BWD_CASES = {
    "r 0 rho 0 g2 hd128 f32": (
        1, 70, 70, 4, 2, 128, F32, 0,
        dict(q_pos0=0, q_stride=2, k_pos0=0, k_stride=2)),
    "r 0 rho 1 g2 hd64 bf16": (
        2, 64, 64, 4, 2, 64, BF16, 0,
        dict(q_pos0=0, q_stride=2, k_pos0=1, k_stride=2)),
    "r 1 rho 0 g1 hd128 bf16 window 128": (
        1, 100, 90, 2, 2, 128, BF16, 0,
        dict(q_pos0=1, q_stride=2, k_pos0=0, k_stride=2, window=128)),
    "r 1 rho 1 g2 hd64 f32 q_len 50 kv_len 61": (
        1, 66, 80, 4, 2, 64, F32, 0,
        dict(q_pos0=1, q_stride=2, k_pos0=1, k_stride=2, q_len=50,
             kv_len=61)),
    "non-causal unaligned g2 hd128 f32 T 33 S 45": (
        2, 33, 45, 4, 2, 128, F32, 1,
        dict(q_pos0=3, q_stride=2, k_stride=2, causal=False)),
    "later block window 100 g1 hd64 bf16": (
        1, 40, 70, 2, 2, 64, BF16, 0, dict(q_pos0=128, k_pos0=64,
                                            window=100)),
}


@pytest.mark.parametrize("case", sorted(PARTIAL_BWD_CASES))
def test_k4_backward_source_matches_plain_on_the_cpu(partial_bwd, case):
    """dq, dk, dv, lse and delta against partial_attention_bwd_plain, the
    call given the chain's output, m and l, so that it writes lse and delta
    first, and a dq that comes in non-zero: the call adds its share, rows
    past q_len keep theirs bit for bit. A second call gives the same
    bits."""
    B, T, S, nq, nkv, hd, dtype, shift, pos = PARTIAL_BWD_CASES[case]
    q, k, v, carry = partial_inputs(len(case), B, T, S, nq, nkv, hd, dtype,
                                    shift)
    m, l, out = chain_state(q, k, v, carry, pos)
    rng = np.random.RandomState(len(case) + 3)
    dout = torch.from_numpy(rng.randn(B, T, nq, hd + 8)).to(dtype)[
        ..., shift:shift + hd]
    dq0 = torch.from_numpy(0.5 * rng.randn(B, T, nq, hd)).float()
    lse, delta = torch.full((2, B, nq, T), math.nan)
    dq = dq0.clone()
    dk, dv = partial_bwd(q, k, v, dout, lse, delta, dq, close=(out, m, l),
                         **pos)
    w_lse, w_delta = torch.empty((2, B, nq, T))
    w_dq = dq0.clone()
    w_dk, w_dv = partial_attention_bwd_plain(q, k, v, dout, w_lse, w_delta,
                                             w_dq, close=(out, m, l), **pos)
    torch.testing.assert_close(lse, w_lse, rtol=1e-6, atol=1e-5)
    _rel_close(delta, w_delta, 1e-5)
    _rel_close(dq - dq0, w_dq - dq0, 1e-4)
    for g, w in ((dk, w_dk), (dv, w_dv)):
        assert g.dtype == torch.float32 and not g.isnan().any()
        _rel_close(g, w, 1e-4)
    rows = pos.get("q_len") or T
    assert torch.equal(dq[:, rows:], dq0[:, rows:])
    if pos.get("kv_len"):
        assert not dk[:, pos["kv_len"]:].any()
        assert not dv[:, pos["kv_len"]:].any()
    dq2 = dq0.clone()
    again = partial_bwd(q, k, v, dout, lse.clone(), delta.clone(), dq2,
                        close=(out, m, l), **pos)
    assert torch.equal(dq2, dq)
    assert all(torch.equal(a, b) for a, b in zip(again, (dk, dv)))


def test_k4_backward_source_gives_rows_with_no_key_zero(partial_bwd):
    """Queries at 0, 2, 4, ... against keys at 1, 3, 5, ...: query 0 sees
    no key of the block, and none in the whole chain (l = 0): its lse is
    NEG_INF, it adds exactly nothing to dq, and nothing is NaN. A second
    block's call, without the chain's output, reads lse and delta as they
    are and leaves them so."""
    q, k, v, carry = partial_inputs(13, 2, 70, 70, 4, 2, 128, F32, 0)
    pos = dict(q_stride=2, k_pos0=1, k_stride=2)
    m, l, out = chain_state(q, k, v, carry, pos)
    m[:, :, 0], l[:, :, 0] = NEG_INF, 0.0
    rng = np.random.RandomState(4)
    dout = torch.from_numpy(rng.randn(2, 70, 4, 128)).float()
    dq0 = torch.from_numpy(rng.randn(2, 70, 4, 128)).float()
    lse, delta = torch.full((2, 2, 4, 70), math.nan)
    dq = dq0.clone()
    dk, dv = partial_bwd(q, k, v, dout, lse, delta, dq, close=(out, m, l),
                         **pos)
    assert (lse[:, :, 0] == NEG_INF).all()
    assert torch.equal(dq[:, 0], dq0[:, 0])
    assert not (dq.isnan().any() or dk.isnan().any() or dv.isnan().any())
    w_lse, w_delta = lse.clone(), delta.clone()
    dq = dq0.clone()
    dk, dv = partial_bwd(q, k, v, dout, lse, delta, dq, **pos)
    assert torch.equal(lse, w_lse) and torch.equal(delta, w_delta)
    assert torch.equal(dq[:, 0], dq0[:, 0])
    w_dq = dq0.clone()
    w_dk, w_dv = partial_attention_bwd_plain(q, k, v, dout, w_lse, w_delta,
                                             w_dq, **pos)
    _rel_close(dq - dq0, w_dq - dq0, 1e-4)
    _rel_close(dk, w_dk, 1e-4)
    _rel_close(dv, w_dv, 1e-4)
