"""Plain versions of the ported kernels (K1 block matmul, K2 flash
attention forward and backward, K3 RMSNorm, K5 paged attention) held
against the JAX package's Pallas kernels, run in interpret mode as
tests/test_kernels.py runs them, and against its jnp references.

Inputs are made with numpy from a seed and cross between the frameworks
as numpy arrays. The CUDA kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import attention as jattn
from repro.layers.attention import paged_attn_core as jax_paged_attn_core
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_matmul import (block_matmul_kernel,
                                              k_granule, plan, vector_ok)
from repro_torch.kernels.flash_attention import (attn_core,
                                                 flash_attention_bwd_kernel,
                                                 flash_attention_kernel,
                                                 paged_attention_kernel,
                                                 paged_attn_core)
from repro_torch.kernels.rmsnorm import rmsnorm_kernel

F32_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels.py, float32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)    # tests/test_kernels.py, bfloat16
# float32, sums in another order than the JAX side's; the backward's
# cotangents sum over T (dk, dv) or S (dq) products
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
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
    ops.matmul(q.reshape(-1, 8), torch.ones(8, 3))
    qa = q.detach().clone().requires_grad_()
    ops.flash_attention(qa, qa[:, :, :2], qa[:, :, 2:]).sum().backward()
    assert set(ops.launches().values()) == {0}


@pytest.mark.parametrize("call", ["rmsnorm", "paged", "matmul", "flash",
                                  "flash_bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The kernel wrappers take CUDA tensors only; they raise on anything
    else before building or launching anything."""
    x = torch.zeros(2, 1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "rmsnorm":
            rmsnorm_kernel(x, torch.ones(64))
        elif call == "paged":
            pools = torch.zeros(3, 16, 2, 64)
            paged_attention_kernel(
                x, pools, pools, torch.zeros(2, 2, dtype=torch.int32),
                torch.zeros(2, 1, dtype=torch.int32),
                torch.ones(2, dtype=torch.int32))
        elif call == "matmul":
            block_matmul_kernel(x[0, 0], x[0, 0].t())
        elif call == "flash":
            flash_attention_kernel(x, x, x)
        else:
            flash_attention_bwd_kernel(x, x, x, x, torch.zeros(2, 4, 1), x)


# ---------------------------------------------------------------------- #
# K1: block matmul
# ---------------------------------------------------------------------- #

def _operands(layout, M, K, N, dtype, seed=0):
    """(a, b) for a @ b in both frameworks; NT reads b and TN reads a
    through a transposed view, as the backward does."""
    rng = np.random.RandomState(seed)
    a = rng.randn(*((K, M) if layout == "TN" else (M, K))).astype(np.float32)
    b = rng.randn(*((N, K) if layout == "NT" else (K, N))).astype(np.float32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    ja = jnp.asarray(a, getattr(jnp, dtype))
    jb = jnp.asarray(b, getattr(jnp, dtype))
    if layout == "TN":
        ta, ja = ta.t(), ja.T
    if layout == "NT":
        tb, jb = tb.t(), jb.T
    return ta, tb, ja, jb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NN", "NT", "TN"])
@pytest.mark.parametrize("M,K,N", [(37, 300, 77), (130, 64, 129),
                                   (8, 1024, 96)])
def test_block_matmul_plain_matches_pallas_and_ref(M, K, N, layout, dtype):
    ta, tb, ja, jb = _operands(layout, M, K, N, dtype)
    got = ops.matmul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (M, N)
    got = got.float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want_k = np.asarray(jops.matmul(ja, jb, bm=64, bn=64, bk=128),
                        np.float32)
    want_r = np.asarray(jref.block_matmul_ref(ja, jb), np.float32)
    np.testing.assert_allclose(got, want_k, **tol)
    np.testing.assert_allclose(got, want_r, **tol)
    assert np.array_equal(ref.block_matmul_ref(ta, tb).float().numpy(), got)


@pytest.mark.parametrize("M,N,K,b_k1,path,splits", [
    (1024, 6144, 2048, False, "large", 2),    # fwd: 384 tiles, 1.45 waves
    (1024, 2048, 6144, True, "large", 2),     # dX: 128 tiles, K split
    (2048, 6144, 1024, False, "large", 1),    # dW: 768 tiles, 2.9 waves
    (1024, 152064, 2048, True, "large", 1),   # tied head: 36 full waves
    (2048, 288, 8192, False, "large", 11),    # Mamba w_x: 48 tiles
    (65, 96, 64, False, "large", 1),          # just above the middle band
    (64, 6144, 2048, False, "mid", 11),       # the middle band's top
    (17, 77, 300, False, "mid", 4),           # its bottom, ragged
    (16, 6144, 2048, False, "decode_n", 11),  # decode, b n-contiguous
    (8, 152064, 2048, True, "decode_k", 1),   # decode tied head
    (4, 288, 8192, False, "decode_n", 128),   # decode Mamba w_x
    (1, 8192, 256, False, "decode_n", 4),     # decode Mamba w_dt, M 1
    (8, 2048, 64, False, "decode_n", 1)])     # too shallow to split
def test_block_matmul_plan(M, N, K, b_k1, path, splits):
    """The wrapper's choice of path and K split on a 132-SM card: the
    tiles above 16 rows (64-row tiles up to 64), the decode paths at or
    below, by which index of b is contiguous; every split a whole number
    of the path's k granule, covering K exactly once."""
    p = plan(M, N, K, 132, b_k1=b_k1)
    assert (p.path, p.splits) == (path, splits)
    assert p.k_split % k_granule(p.path, 4) == 0
    assert (splits - 1) * p.k_split < K <= splits * p.k_split


@pytest.mark.parametrize("elt,granule", [(4, 256), (2, 512)])
def test_block_matmul_plan_decode_k_granule_follows_the_dtype(elt, granule):
    """A DECODE_K lane reads 16 bytes along k, 4 float32 or 8 bf16, and a
    split is two steps of 32 lanes: its granule doubles in bf16."""
    p = plan(8, 2048, 8192, 132, elt=elt, b_k1=True)
    assert p.path == "decode_k" and k_granule(p.path, elt) == granule
    assert p.k_split % granule == 0 and p.splits > 1


@pytest.mark.parametrize("dtype,shape,view,ok", [
    (torch.float32, (8, 512), lambda t: t, True),
    (torch.float32, (8, 513), lambda t: t[:, 1:], False),    # base + 4 B
    (torch.float32, (8, 300), lambda t: t, True),            # 1200 B rows
    (torch.bfloat16, (8, 300), lambda t: t, False),          # 600 B rows
    (torch.bfloat16, (8, 304), lambda t: t, True),           # 608 B rows
    (torch.bfloat16, (8, 320), lambda t: t[:, 8:], True),    # base + 16 B
    (torch.bfloat16, (8, 320), lambda t: t[:, 4:], False),   # base + 8 B
    (torch.float32, (96, 64), lambda t: t.t(), True),        # k-contiguous
    (torch.float32, (8, 512), lambda t: t[:, ::2], False)])  # no stride 1
def test_block_matmul_vector_loads_need_16_byte_alignment(dtype, shape,
                                                          view, ok):
    """An operand is read 16 bytes at a time only if its contiguous index
    has stride 1 and its base and other stride are multiples of 16 bytes,
    which is 4 float32 but 8 bf16 elements."""
    assert vector_ok(view(torch.zeros(shape, dtype=dtype))) is ok


# ---------------------------------------------------------------------- #
# K2: flash attention
# ---------------------------------------------------------------------- #

ATTN_CASES = {
    # (B, T, S, nq, nkv, d, causal, window)
    "causal_gqa2": (2, 40, 40, 4, 2, 16, True, 0),
    "noncausal_ragged": (1, 23, 37, 4, 4, 16, False, 0),
    "window_gqa2": (2, 45, 45, 4, 2, 8, True, 7),
    "causal_ragged": (1, 130, 130, 2, 1, 16, True, 0),
}


def _attn_inputs(B, T, S, nq, nkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, nq, d).astype(np.float32),
            rng.randn(B, S, nkv, d).astype(np.float32),
            rng.randn(B, S, nkv, d).astype(np.float32),
            rng.randn(B, T, nq, d).astype(np.float32))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_plain_matches_pallas(case):
    """K2's plain version in the model's (B, T, H, D) layout against the
    Pallas kernel, which takes (B, H, T, D) and pads T and S to its
    blocks (padded keys masked through kv_len)."""
    B, T, S, nq, nkv, d, causal, window = ATTN_CASES[case]
    q, k, v, _ = _attn_inputs(B, T, S, nq, nkv, d)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window).numpy()
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal=causal, window=window, bq=32, bk=32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want, **ATTN_TOL)


def test_flash_attention_kv_len_masks_trailing_keys():
    """kv_len masks the keys at and past it, as the Pallas kernel masks
    its padding: the result equals attention over the first kv_len keys."""
    q, k, v, _ = _attn_inputs(1, 20, 30, 4, 2, 8, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False, kv_len=17)
    want = attn_core(tq, tk[:, :17], tv[:, :17], causal=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_plain_backward_matches_jax_vjp(case):
    """dq, dk, dv of the plain version (autograd's) against jax.vjp of the
    JAX package's attn_core on the same cotangent; the forward also
    matches attn_core and attn_core_chunked (the same function in
    online-softmax form)."""
    B, T, S, nq, nkv, d, causal, window = ATTN_CASES[case]
    q, k, v, ct = _attn_inputs(B, T, S, nq, nkv, d, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(ct))
    jout, pull = jax.vjp(lambda a, b, c: jattn.attn_core(
        a, b, c, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **ATTN_TOL)
    chunked = jattn.attn_core_chunked(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, window=window, bq=16,
                                      bk=16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(chunked),
                               **ATTN_TOL)
    for t, g in zip((tq, tk, tv), pull(jnp.asarray(ct))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   **ATTN_GRAD_TOL)
