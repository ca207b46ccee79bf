"""What the emulated attention kernels' tests share: the card's
tolerances (``chip_smoke.py``'s PAGED_TOL and FLASH_TOL: K5 as
``torch.allclose(rtol = atol = tol)``, K2 as max|kernel - plain| <= tol *
max|plain|), the dtype codes of the kernels' C interfaces, and K2's
library (``csrc/flash_attention.cu``) through its C interface with its
inputs and plain log-sum-exp, which the forward's and the backward's
tests both use. The ``flash`` fixture compiles the source once for the
test module that imports it."""
import ctypes
import math

import numpy as np
import pytest
import torch

from . import compile_source

F32, BF16 = torch.float32, torch.bfloat16
DTYPE = {F32: 0, BF16: 1}
PAGED_TOL = {F32: 1e-4, BF16: 2e-2}
FLASH_TOL = {F32: 1e-4, BF16: 2e-2}


@pytest.fixture(scope="module")
def flash(tmp_path_factory):
    lib = compile_source("flash_attention",
                         tmp_path_factory.mktemp("k2_emulated"))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strided = [p, ll, ll, ll]
    fwd, bwd = lib.flash_attention_fwd_launch, lib.flash_attention_bwd_launch
    fwd.argtypes = [*strided * 3, p, p, *[i] * 10, ctypes.c_float, i, p]
    bwd.argtypes = [*strided * 3, p, *strided, p, p, p, p, p, *[i] * 10,
                    ctypes.c_float, i, p]
    fwd.restype = bwd.restype = ctypes.c_int
    work = lib.flash_attention_bwd_workspace
    work.argtypes = [i] * 7
    work.restype = ll

    def tail(q, k, v, causal, window, kv_len):
        B, T, nq, hd = q.shape
        return [B, T, k.shape[1], nq, k.shape[2], hd, v.shape[-1],
                int(causal), window, kv_len, 1.0 / math.sqrt(hd),
                DTYPE[q.dtype], None]

    def strided_args(t):
        return [t.data_ptr(), *t.stride()[:3]]

    def forward(q, k, v, causal, window, kv_len):
        B, T, nq, hd = q.shape
        out = torch.full((B, T, nq, v.shape[-1]), math.nan).to(q.dtype)
        lse = torch.full((B, nq, T), math.nan)
        assert fwd(*strided_args(q), *strided_args(k), *strided_args(v),
                   out.data_ptr(), lse.data_ptr(),
                   *tail(q, k, v, causal, window, kv_len)) == 0
        return out, lse

    def backward(q, k, v, out, lse, dout, causal, window, kv_len):
        B, T, nq, hd = q.shape
        ws = torch.full((work(B, T, k.shape[1], nq, k.shape[2], hd,
                              v.shape[-1]),), math.nan)
        dq = torch.full(q.shape, math.nan).to(q.dtype)
        dk = torch.full(k.shape, math.nan).to(k.dtype)
        dv = torch.full(v.shape, math.nan).to(v.dtype)
        assert bwd(*strided_args(q), *strided_args(k), *strided_args(v),
                   out.data_ptr(), *strided_args(dout), lse.data_ptr(),
                   ws.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), *tail(q, k, v, causal, window,
                                        kv_len)) == 0
        return dq, dk, dv
    return forward, backward


def flash_inputs(seed, B, T, S, nq, nkv, hd, dtype, shift, dv=None):
    """q, k, v in the model's (B, T, H, hd) layouts as views of wider rows
    (head stride hd + 8); ``shift`` 1 moves every row off 16 bytes, which
    sends the kernel to its element-wise loads. ``dv``: v's width where it
    is not hd (MLA's 128 beside q/k 192)."""
    rng = np.random.RandomState(seed)

    def rand(n, h, width=hd):
        wide = torch.from_numpy(rng.randn(B, n, h, width + 8)).to(dtype)
        return wide[..., shift:shift + width]
    return rand(T, nq), rand(S, nkv), rand(S, nkv, dv or hd)


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


def rel_close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err
