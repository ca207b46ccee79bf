"""K2's forward (``csrc/flash_attention.cu``) run on the CPU.

The source is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through its C interface on CPU tensors (``cuda_emu.attention``'s
``flash`` fixture). Each case (``FLASH_CASES`` and a GQA group of 6) is
held to the plain
``attn_core`` with the card's tolerance (``chip_smoke.py``'s FLASH_TOL),
its lse to the plain log-sum-exp, and must repeat bitwise. Every output
starts as NaN, so a read of an entry that no block wrote shows. The card
runs the same source in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import pytest
import torch

from cuda_emu.attention import (  # noqa: F401 (flash: the fixture)
    BF16, F32, FLASH_CASES, FLASH_TOL, flash, flash_inputs, plain_lse,
    rel_close)

# the forward's own case beside FLASH_CASES: Nemotron's prefill groups 6
# query heads on a KV head (B, T, S, nq, nkv, hd, causal, window, kv_len,
# dtype, shift)
FWD_CASES = dict(FLASH_CASES, **{
    "causal g6 hd128 f32 T 70": (1, 70, 70, 6, 1, 128, True, 0, 0, F32, 0),
})


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_k2_forward_source_matches_plain_on_the_cpu(flash, case):
    from repro_torch.kernels.flash_attention import attn_core
    B, T, S, nq, nkv, hd, causal, window, kv_len, dtype, shift = \
        FWD_CASES[case]
    q, k, v = flash_inputs(len(case), B, T, S, nq, nkv, hd, dtype, shift)
    forward, _ = flash
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    out, lse = forward(q, k, v, causal, window, kv_len)
    rel_close(out, attn_core(q, k, v, **kw), FLASH_TOL[dtype])
    want = plain_lse(q, k, causal, window, kv_len)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)
    again, lse2 = forward(q, k, v, causal, window, kv_len)
    assert torch.equal(out, again) and torch.equal(lse, lse2)


# MLA's widths: q/k 192, v 128, nq == nkv (B, T, nq, dtype, shift), T not a
# multiple of the 64-row tile
MLA_CASES = {"causal 192/128 f32 T 70": (1, 70, 2, F32, 0),
             "causal 192/128 bf16 T 100": (2, 100, 1, BF16, 0),
             "unaligned causal 192/128 f32 T 65": (1, 65, 2, F32, 1)}


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_k2_forward_source_at_mla_widths(flash, case):
    """K2 at MLA's (192, 128) against the plain attn_core (its scale
    1/sqrt(192)), its lse to the plain log-sum-exp, bitwise on a repeat."""
    from repro_torch.kernels.flash_attention import attn_core
    B, T, nq, dtype, shift = MLA_CASES[case]
    q, k, v = flash_inputs(len(case), B, T, T, nq, nq, 192, dtype, shift,
                           dv=128)
    forward, _ = flash
    out, lse = forward(q, k, v, True, 0, 0)
    assert out.shape == (B, T, nq, 128)
    rel_close(out, attn_core(q, k, v, causal=True), FLASH_TOL[dtype])
    torch.testing.assert_close(lse, plain_lse(q, k, True, 0, 0), rtol=1e-5,
                               atol=1e-4)
    again, lse2 = forward(q, k, v, True, 0, 0)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
