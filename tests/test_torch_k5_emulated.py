"""K5's CUDA source (``csrc/paged_attention.cu``: the split page walk and
the combine of each row's splits) run on the CPU.

The source is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through its C interface on CPU tensors. Each case is held to the
plain version with the card's tolerance (``chip_smoke.py``'s PAGED_TOL)
and must repeat bitwise; chunked prefill must equal one-shot prefill
bitwise. The workspace and every output start as NaN, so a read of an
entry that no block wrote shows. This checks the kernel's indexing and
arithmetic, not its speed or its behaviour under the real compiler; the
card runs the same source in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from cuda_emu import compile_source
from cuda_emu.attention import BF16, DTYPE, F32, PAGED_TOL
from repro_torch.kernels.flash_attention import NEG_INF, paged_attention_plain


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
    # StableLM's MHA (g 1: a 16-row decode tile holds one row) and
    # Nemotron's 48/8 heads (g 6)
    "decode g1 hd64 f32": (1, 1, 64, F32, 16, 0, [64, 65, 200, 1, 9],
                           [1, 1, 1, 1, 0], False),
    "decode g6 hd128 f32": (1, 6, 128, F32, 16, 0, [70, 64, 130, 5],
                            [1, 1, 1, 1], False),
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
