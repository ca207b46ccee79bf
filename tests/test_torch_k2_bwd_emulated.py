"""K2's backward (``csrc/flash_attention.cu``) run on the CPU.

The source is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through its C interface on CPU tensors (``cuda_emu.attention``'s
``flash`` fixture). Each case is held to autograd of the plain
``attn_core`` with the card's tolerance (``chip_smoke.py``'s FLASH_TOL)
and must repeat bitwise. The workspace and every output start as NaN, so
a read of an entry that no block wrote shows. The card runs the same
source in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from cuda_emu.attention import (  # noqa: F401 (flash: the fixture)
    BF16, F32, FLASH_CASES, FLASH_TOL, flash, flash_inputs, rel_close)


# the backward's own cases beside FLASH_CASES: a window without the causal
# mask, S > T under it, and the first port's one case (B, T, S, nq, nkv,
# hd, causal, window, kv_len, dtype, shift)
BWD_CASES = dict(FLASH_CASES, **{
    "non-causal window 20 g4 hd128 f32": (1, 70, 70, 4, 1, 128, False, 20,
                                          0, F32, 0),
    "causal S 100 > T 40 g2 hd64 bf16": (2, 40, 100, 4, 2, 64, True, 0, 0,
                                         BF16, 0),
    "causal g2 hd64 f32 T 70": (1, 70, 70, 4, 2, 64, True, 0, 0, F32, 0),
    # a GQA group of 6 (Nemotron's 48/8 heads)
    "causal g6 hd128 bf16 T 70": (1, 70, 70, 6, 1, 128, True, 0, 0, BF16,
                                  0),
})


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_k2_backward_source_matches_autograd_on_the_cpu(flash, case):
    """dq, dk and dv against autograd of the plain attn_core: windows,
    kv_len < S, T not a multiple of the 64-row tile, non-causal, GQA g 1,
    2, 4 and 6, head_dim 64 and 128, float32 and bfloat16, rows on and off 16
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
        rel_close(g, w, FLASH_TOL[dtype])
    again = backward(q, k, v, out, lse, dout, causal, window, kv_len)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


# MLA's widths: q/k 192, v 128, nq == nkv (B, T, nq, dtype, shift), T not a
# multiple of the 64-row tile
MLA_CASES = {"causal 192/128 f32 T 70": (1, 70, 2, F32, 0),
             "causal 192/128 bf16 T 100": (1, 100, 1, BF16, 0),
             "unaligned causal 192/128 f32 T 65": (1, 65, 1, F32, 1)}


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_k2_backward_source_at_mla_widths(flash, case):
    """dq, dk (192 wide) and dv (128 wide) against autograd of the plain
    attn_core; every output and the workspace start as NaN; a second call
    gives the same bits."""
    from repro_torch.kernels.flash_attention import attn_core
    B, T, nq, dtype, shift = MLA_CASES[case]
    forward, backward = flash
    q, k, v = flash_inputs(len(case) + 7, B, T, T, nq, nq, 192, dtype,
                           shift, dv=128)
    dout = torch.from_numpy(np.random.RandomState(len(case)).randn(
        B, T, nq, 136)).to(dtype)[..., shift:shift + 128]
    out, lse = forward(q, k, v, True, 0, 0)
    grads = backward(q, k, v, out, lse, dout, True, 0, 0)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attn_core(*leaves, causal=True), leaves,
                               dout)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert not g.float().isnan().any()
        rel_close(g, w, FLASH_TOL[dtype])
    again = backward(q, k, v, out, lse, dout, True, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))
