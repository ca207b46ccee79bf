"""K4's CUDA source (``csrc/partial_attention.cu``, forward and backward)
run on the CPU.

The source is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through its C interfaces on CPU tensors. Each case is held to the
plain version (the carry and the gradients to 1e-4 of their largest entry)
and must repeat bitwise. The backward's workspace and every output start
as NaN, so a read of an entry that no block wrote shows. This checks the
kernels' indexing and arithmetic, not their speed or their behaviour
under the real compiler; the card runs the same source in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from cuda_emu import compile_source
from cuda_emu.attention import BF16, DTYPE, F32, flash_inputs, rel_close
from repro_torch.kernels.flash_attention import (
    NEG_INF, attn_partial_finalize, attn_partial_init,
    partial_attention_bwd_plain, partial_attention_plain)


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
        rel_close(g, w, 1e-4)
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
    rel_close(delta, w_delta, 1e-5)
    rel_close(dq - dq0, w_dq - dq0, 1e-4)
    for g, w in ((dk, w_dk), (dv, w_dv)):
        assert g.dtype == torch.float32 and not g.isnan().any()
        rel_close(g, w, 1e-4)
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
    rel_close(dq - dq0, w_dq - dq0, 1e-4)
    rel_close(dk, w_dk, 1e-4)
    rel_close(dv, w_dv, 1e-4)
