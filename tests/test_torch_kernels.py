"""Plain versions of the ported kernels (K3 RMSNorm, K5 paged attention)
held against the JAX package's Pallas kernels, run in interpret mode as
tests/test_kernels.py runs them, and against its jnp references.

Inputs are made with numpy from a seed and cross between the frameworks
as numpy arrays. The CUDA kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers.attention import paged_attn_core as jax_paged_attn_core
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (paged_attention_kernel,
                                                 paged_attn_core)
from repro_torch.kernels.rmsnorm import rmsnorm_kernel

F32_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels.py, float32
PAGED_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_serving.py


@pytest.mark.parametrize("m,d", [(256, 128), (100, 96), (17, 512),
                                 (8, 2048)])
def test_rmsnorm_plain_matches_pallas_and_ref(m, d):
    rng = np.random.RandomState(m + d)
    x = rng.randn(m, d).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    want_k = np.asarray(jops.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    want_r = np.asarray(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got, want_k, **F32_TOL)
    np.testing.assert_allclose(got, want_r, **F32_TOL)
    assert np.array_equal(ref.rmsnorm_ref(torch.from_numpy(x),
                                          torch.from_numpy(g)).numpy(), got)


def test_rmsnorm_full_dim_divides_the_mean():
    """``full_dim`` is the width of the whole (x-sharded) row; at the
    row's own width it is the plain RMSNorm."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(5, 64).astype(np.float32))
    g = torch.ones(64)
    same = ops.rmsnorm(x, g, full_dim=64)
    assert torch.equal(same, ops.rmsnorm(x, g))
    half = ops.rmsnorm(x, g, full_dim=128)
    ms = (x * x).sum(-1, keepdim=True) / 128
    torch.testing.assert_close(half, x * torch.rsqrt(ms + 1e-6))


def _paged_inputs(seed, R, T, Hq, Hkv, D, page, n_tab, P, q_len):
    """The inputs of tests/test_serving.py::test_paged_kernel_matches_core
    (seed 0 and its shapes give exactly those)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(R, T, Hq, D).astype(np.float32)
    kp = rng.randn(P, page, Hkv, D).astype(np.float32)
    vp = rng.randn(P, page, Hkv, D).astype(np.float32)
    table = rng.randint(1, P, (R, n_tab)).astype(np.int32)
    q_pos = rng.randint(0, page * n_tab, (R, T)).astype(np.int32)
    return q, kp, vp, table, q_pos, np.asarray(q_len, np.int32)


PAGED_CASES = {
    # the inputs of test_serving.py:36-45 (GQA g = 2)
    "serving": dict(seed=0, R=3, T=4, Hq=4, Hkv=2, D=8, page=4, n_tab=3,
                    P=16, q_len=[4, 2, 0], window=0),
    # g = 4 query heads per KV head, more pages, a sliding window
    "gqa4": dict(seed=1, R=4, T=6, Hq=8, Hkv=2, D=16, page=8, n_tab=5,
                 P=24, q_len=[6, 1, 0, 3], window=0),
    "gqa4_window": dict(seed=2, R=2, T=5, Hq=8, Hkv=2, D=16, page=4,
                        n_tab=6, P=20, q_len=[5, 4], window=7),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_attention_plain_matches_pallas_and_core(case):
    c = dict(PAGED_CASES[case])
    window = c.pop("window")
    q, kp, vp, table, q_pos, q_len = _paged_inputs(**c)
    got = ops.flash_attention_paged(
        *map(torch.from_numpy, (q, kp, vp, table, q_pos, q_len)),
        window=window).numpy()
    jq, jk, jv, jt, jp, jl = map(jnp.asarray,
                                 (q, kp, vp, table, q_pos, q_len))
    want_k = np.asarray(jops.flash_attention_paged(jq, jk, jv, jt, jp, jl,
                                                   window=window))
    R, Hkv, D = q.shape[0], kp.shape[2], q.shape[3]
    want_c = np.asarray(jax_paged_attn_core(
        jq, jk[jt].reshape(R, -1, Hkv, D), jv[jt].reshape(R, -1, Hkv, D),
        q_pos=jp, q_len=jl, window=window))
    rows = np.arange(q.shape[1])[None, :] < q_len[:, None]
    np.testing.assert_allclose(got[rows], want_k[rows], **PAGED_TOL)
    np.testing.assert_allclose(got[rows], want_c[rows], **PAGED_TOL)
    # rows past q_len (and idle slots) give exact zeros, as the kernels do
    assert not got[~rows].any()


def test_paged_core_chunk_invariance_is_bitwise():
    """Every chunking of the query rows reduces the same fixed-length score
    vector per row, so the plain path's chunks equal one shot bitwise."""
    rng = np.random.RandomState(1)
    R, T, Hq, Hkv, D, S = 2, 8, 4, 2, 8, 16
    q = torch.from_numpy(rng.randn(R, T, Hq, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(R, S, Hkv, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(R, S, Hkv, D).astype(np.float32))
    pos = torch.arange(T, dtype=torch.int32).expand(R, T)
    full = paged_attn_core(q, k, v, q_pos=pos,
                           q_len=torch.full((R,), T, dtype=torch.int32))
    for c0, c1 in ((0, 3), (3, T)):
        part = paged_attn_core(
            q[:, c0:c1], k, v, q_pos=pos[:, c0:c1],
            q_len=torch.full((R,), c1 - c0, dtype=torch.int32))
        assert torch.equal(part, full[:, c0:c1])


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel launch: the counters stay put."""
    ops.reset_launches()
    q, kp, vp, table, q_pos, q_len = map(torch.from_numpy, _paged_inputs(
        0, 3, 4, 4, 2, 8, 4, 3, 16, [4, 2, 0]))
    ops.flash_attention_paged(q, kp, vp, table, q_pos, q_len)
    ops.rmsnorm(q, torch.ones(8))
    assert rmsnorm_kernel.launches == 0
    assert paged_attention_kernel.launches == 0


@pytest.mark.parametrize("call", ["rmsnorm", "paged"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The kernel wrappers take CUDA tensors only; they raise on anything
    else before building or launching anything."""
    x = torch.zeros(2, 1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "rmsnorm":
            rmsnorm_kernel(x, torch.ones(64))
        else:
            pools = torch.zeros(3, 16, 2, 64)
            paged_attention_kernel(
                x, pools, pools, torch.zeros(2, 2, dtype=torch.int32),
                torch.zeros(2, 1, dtype=torch.int32),
                torch.ones(2, dtype=torch.int32))
