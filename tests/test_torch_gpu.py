"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips. The file imports torch and the port only, so it also runs where JAX
is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.block_matmul import (block_matmul_kernel,
                                              block_matmul_plain)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import (attn_core,
                                                 flash_attention_kernel,
                                                 paged_attention_kernel,
                                                 paged_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain
from repro_torch.kernels.selective_scan import (selective_scan_kernel,
                                                selective_scan_plain)
from repro_torch.launch import steps as ST
from repro_torch.layers.attention import partial_chain, partial_chain_bwd

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 2048), (17, 128), (1, 96)])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = torch.randn(shape[-1:], generator=gen, device=cuda).to(dtype)
    n = rmsnorm_kernel.launches
    got = ops.rmsnorm(x, g)
    assert rmsnorm_kernel.launches == n + 1
    torch.testing.assert_close(got, rmsnorm_plain(x, g), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(
        rmsnorm_kernel(x, g, full_dim=2 * shape[-1]),
        rmsnorm_plain(x, g, full_dim=2 * shape[-1]),
        rtol=TOL[dtype], atol=TOL[dtype])


def _paged(cuda, dtype, T, hd, seed=0):
    rng = np.random.RandomState(seed)
    R, nq, nkv, page, P, n_tab = 4, 8, 2, 16, 24, 6
    q = torch.from_numpy(rng.randn(R, T, nq, hd)).to(cuda, dtype)
    kp = torch.from_numpy(rng.randn(P, page, nkv, hd)).to(cuda, dtype)
    vp = torch.from_numpy(rng.randn(P, page, nkv, hd)).to(cuda, dtype)
    table = np.zeros((R, n_tab), np.int32)
    table[:, :4] = rng.permutation(np.arange(1, P))[:16].reshape(R, 4)
    q_len = np.array([T, max(T // 2, 1), 0, 1], np.int32)
    start = np.array([40, 3, 0, 63])
    q_pos = np.minimum(start[:, None] + np.arange(T), 63).astype(np.int32)
    return (q, kp, vp) + tuple(torch.from_numpy(a).to(cuda)
                               for a in (table, q_pos, q_len))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,hd", [(1, 128), (9, 128), (20, 64)])
def test_paged_attention_kernel_matches_plain(cuda, T, hd, dtype):
    args = _paged(cuda, dtype, T, hd)
    got = ops.flash_attention_paged(*args)
    want = paged_attention_plain(*args)
    rows = (torch.arange(T, device=cuda)[None] < args[5][:, None])
    torch.testing.assert_close(got[rows], want[rows], rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert not got[~rows].any()


def test_paged_attention_kernel_chunks_are_bitwise(cuda):
    q, kp, vp, table, q_pos, q_len = _paged(cuda, torch.float32, 20, 128)
    full = paged_attention_kernel(q, kp, vp, table, q_pos, q_len)
    for c0, c1 in ((0, 7), (7, 20)):
        ql = torch.clamp(q_len - c0, 0, c1 - c0).to(torch.int32)
        part = paged_attention_kernel(q[:, c0:c1], kp, vp, table,
                                      q_pos[:, c0:c1].contiguous(), ql)
        rows = torch.arange(c1 - c0, device=cuda)[None] < ql[:, None]
        assert torch.equal(part[rows], full[:, c0:c1][rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_over_the_dense_cache(cuda, dtype):
    """K5 as fixed-batch decode runs it: a dense cache seen as pages of
    DENSE_PAGE rows, one query row per sequence at its own position."""
    from repro_torch.layers.attention import DENSE_PAGE, dense_page_view
    rng = np.random.RandomState(2)
    B, nq, nkv, hd, S = 3, 8, 2, 128, 3 * DENSE_PAGE
    q, kc, vc = (torch.from_numpy(rng.randn(*shape)).to(cuda, dtype)
                 for shape in ((B, 1, nq, hd), (B, S, nkv, hd),
                               (B, S, nkv, hd)))
    (kp, table), (vp, _) = dense_page_view(kc), dense_page_view(vc)
    q_pos = torch.tensor([[0], [DENSE_PAGE], [S - 1]], dtype=torch.int32,
                         device=cuda)
    q_len = torch.ones((B,), dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        paged_attention_kernel(q, kp, vp, table, q_pos, q_len),
        paged_attention_plain(q, kp, vp, table, q_pos, q_len),
        rtol=TOL[dtype], atol=TOL[dtype])


def _paged_long(cuda, dtype, *, T, g, hd, page, ctx, q_len, seed=0):
    """Slots of up to 300 keys (five 64-key splits at page 16); slot r's
    q_len[r] rows end at ctx[r]; slot 0's first table entry is past the
    pool and slot 1's second below 0 (the kernel clamps them)."""
    rng = np.random.RandomState(seed)
    R, nkv = len(ctx), 2
    used = [-(-c // page) for c in ctx]
    n_tab, P = max(used) + 1, sum(used) + 3
    kp, vp = (torch.from_numpy(rng.randn(P, page, nkv, hd)).to(cuda, dtype)
              for _ in range(2))
    table = np.zeros((R, n_tab), np.int32)
    ids = iter(rng.permutation(np.arange(1, P)))
    for r, n in enumerate(used):
        table[r, :n] = [next(ids) for _ in range(n)]
    table[0, 0], table[1, 1] = P + 7, -2
    q_pos = np.zeros((R, T), np.int32)
    for r, (c, n) in enumerate(zip(ctx, q_len)):
        if n:
            q_pos[r] = np.minimum(c - n + np.arange(T), n_tab * page - 1)
    q = torch.from_numpy(rng.randn(R, T, g * nkv, hd)).to(cuda, dtype)
    return (q, kp, vp) + tuple(torch.from_numpy(a).to(cuda)
                               for a in (table, q_pos, q_len))


# (T, g, hd, page, window, ctx, q_len): rows ending on a split's last key
# (ctx 64) and first key (ctx 65), windows across split boundaries, a slot
# with q_len 0, contexts of four and five splits
PAGED_LONG = {
    "decode g2 hd128": (1, 2, 128, 16, 0, [64, 65, 300, 257, 9],
                        [1, 1, 1, 1, 0]),
    "decode g4 hd64 window 40": (1, 4, 64, 16, 40, [70, 200, 300, 65],
                                 [1, 1, 1, 1]),
    "decode g4 hd128 page 32": (1, 4, 128, 32, 0, [300, 33, 256, 129],
                                [1, 1, 1, 1]),
    "chunk T16 g2 hd128 window 100": (16, 2, 128, 16, 100,
                                      [80, 300, 0, 270], [16, 16, 0, 9]),
    "chunk T32 g4 hd64": (32, 4, 64, 16, 0, [96, 290, 40], [32, 32, 17]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_LONG))
def test_paged_attention_kernel_splits_match_plain(cuda, case, dtype):
    """The split page walk over contexts of four and five splits, against
    the plain version on the clamped table; two calls give the same bits,
    and each call launches the split kernel and the combine once."""
    T, g, hd, page, window, ctx, q_len = PAGED_LONG[case]
    q, kp, vp, table, q_pos, ql = _paged_long(
        cuda, dtype, T=T, g=g, hd=hd, page=page, ctx=ctx,
        q_len=np.array(q_len, np.int32))
    before = ops.launches()
    got = ops.flash_attention_paged(q, kp, vp, table, q_pos, ql,
                                    window=window)
    after = ops.launches()
    assert after["paged_attention"] == before["paged_attention"] + 1
    assert (after["paged_attention_combine"]
            == before["paged_attention_combine"] + 1)
    want = paged_attention_plain(q, kp, vp, table.clamp(0, kp.shape[0] - 1),
                                 q_pos, ql, window=window)
    rows = torch.arange(T, device=cuda)[None] < ql[:, None]
    torch.testing.assert_close(got[rows], want[rows], rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert not got[~rows].any()
    assert torch.equal(got, paged_attention_kernel(q, kp, vp, table, q_pos,
                                                   ql, window=window))


def test_paged_attention_kernel_chunks_on_a_split_boundary_are_bitwise(
        cuda):
    """Slot 0's rows sit at positions 60..91: the second chunk starts at
    position 64, where a split begins."""
    q, kp, vp, table, q_pos, q_len = _paged_long(
        cuda, torch.float32, T=32, g=2, hd=128, page=16, ctx=[92, 300, 150],
        q_len=np.array([32, 32, 20], np.int32))
    assert int(q_pos[0, 4]) == 64
    for window in (0, 50):
        full = paged_attention_kernel(q, kp, vp, table, q_pos, q_len,
                                      window=window)
        for c0, c1 in ((0, 4), (4, 20), (20, 32)):
            ql = torch.clamp(q_len - c0, 0, c1 - c0).to(torch.int32)
            part = paged_attention_kernel(q[:, c0:c1], kp, vp, table,
                                          q_pos[:, c0:c1].contiguous(), ql,
                                          window=window)
            rows = torch.arange(c1 - c0, device=cuda)[None] < ql[:, None]
            assert torch.equal(part[rows], full[:, c0:c1][rows])


@pytest.mark.parametrize("case", ["decode g2 hd128",
                                  "chunk T16 g2 hd128 window 100"])
def test_paged_attention_kernel_table_width_changes_no_bit(cuda, case):
    """A table 200 columns wider than the rows' pages (other page ids in
    the extra columns) gives the same bits as the columns in use, which
    is what the serving engine sends."""
    T, g, hd, page, window, ctx, q_len = PAGED_LONG[case]
    q, kp, vp, table, q_pos, ql = _paged_long(
        cuda, torch.float32, T=T, g=g, hd=hd, page=page, ctx=ctx,
        q_len=np.array(q_len, np.int32))
    extra = torch.randint(0, kp.shape[0], (table.shape[0], 200),
                          dtype=torch.int32, device=cuda)
    wide = torch.cat([table, extra], 1).contiguous()
    assert torch.equal(
        paged_attention_kernel(q, kp, vp, wide, q_pos, ql, window=window),
        paged_attention_kernel(q, kp, vp, table, q_pos, ql, window=window))


def test_paged_attention_kernel_refuses_unsupported_shapes(cuda):
    q, kp, vp, table, q_pos, q_len = _paged(cuda, torch.float32, 2, 128)
    big = torch.zeros((4, 64, 2, 128), device=cuda)      # page 64 > 32
    with pytest.raises(ValueError, match="page <= 32"):
        paged_attention_kernel(q, big, big, table, q_pos, q_len)
    with pytest.raises(TypeError, match="int32"):
        paged_attention_kernel(q, kp, vp, table.long(), q_pos, q_len)


def test_paged_step_kernels_match_plain(cuda):
    cfg = get_config("qwen3-1.7b").reduced()
    model = ST.init_model(cfg, seed=0, device=cuda)
    build = ST.make_paged_step(cfg, model.axes)
    step, ct = build(9, 4)
    R, T = 2, 8
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (R, T), generator=gen,
                           dtype=torch.int32).to(cuda)
    positions = torch.arange(T, dtype=torch.int32).expand(R, T
                                                          ).contiguous()
    args = (positions.to(cuda), torch.tensor([8, 5], dtype=torch.int32,
                                             device=cuda),
            torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32,
                         device=cuda))
    out = {}
    for plain in (False, True):
        out[plain], _ = step(model, tokens, ST.zeros_caches(ct, cuda),
                             *args, plain=plain)
    torch.testing.assert_close(out[False], out[True], rtol=1e-4, atol=1e-4)


def test_train_step_kernels_match_plain(cuda):
    """lm_loss and every gradient through the kernels against the plain
    versions, on the reduced config; then one train step through the
    kernels."""
    from repro_torch.models.decoder import lm_loss
    from repro_torch.optim.adamw import AdamWConfig, init_state
    cfg = get_config("qwen3-1.7b").reduced()
    model = ST.init_model(cfg, seed=0, device=cuda)
    gen = torch.Generator().manual_seed(0)
    toks, labels = (torch.randint(0, cfg.vocab_size, (4, 64), generator=gen
                                  ).to(cuda) for _ in range(2))
    out = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = lm_loss(model, toks, labels, plain=plain)
        loss.backward()
        out[plain] = [loss.detach()] + [p.grad for p in model.parameters()]
    for a, b in zip(out[False], out[True]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    step = ST.make_train_step(cfg, model.axes, AdamWConfig(),
                              ST.TrainOptions(dtype=torch.float32))
    m = step(model, init_state(dict(model.named_parameters())),
             {"tokens": toks, "labels": labels})
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


# ---------------------------------------------------------------------- #
# K1 block matmul, K2 flash attention forward and backward
# ---------------------------------------------------------------------- #

def _operands(cuda, layout, M, K, N, dtype, seed=0, shift=0):
    """a (M, K) and b (K, N) in ``layout``: NT reads b and TN reads a
    through a transposed view, SN reads a as a column slice (row stride K
    + 32). ``shift`` > 0 starts both that many elements into their
    storage, so that neither base is 16-byte aligned."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        x = torch.randn((shape[0], shape[1] + shift), generator=gen,
                        device=cuda).to(dtype)
        return x[:, shift:]
    a = (rand(K, M).t() if layout == "TN" else
         rand(M, K + 32)[:, :K] if layout == "SN" else rand(M, K))
    b = rand(N, K).t() if layout == "NT" else rand(K, N)
    return a, b


MATMUL_M = [1, 4, 8, 16, 17, 64, 65, 1024]      # decode, middle, tiles
# (K, N, shift): aligned; not 16-byte aligned; ragged K and N
MATMUL_KN = [(512, 384, 0), (512, 384, 1), (300, 77, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NN", "NT", "TN", "SN"])
@pytest.mark.parametrize("K,N,shift", MATMUL_KN)
@pytest.mark.parametrize("M", MATMUL_M)
def test_block_matmul_kernel_matches_plain(cuda, M, K, N, shift, layout,
                                           dtype):
    """Every path of K1 (decode M <= 16, the 64-row tile, the 128-row
    tile), held to max|d| <= tol * max|plain|: the kernel sums K in
    another order than cuBLAS; bf16 outputs round once more. A second
    call gives the same bits."""
    a, b = _operands(cuda, layout, M, K, N, dtype, shift=shift)
    n = block_matmul_kernel.launches
    got = ops.matmul(a, b)
    assert block_matmul_kernel.launches == n + 1
    want = block_matmul_plain(a, b)
    assert got.dtype == dtype and got.shape == (M, N)
    err = float((got.float() - want.float()).abs().max())
    assert err <= {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype] * float(
        want.float().abs().max())
    assert torch.equal(block_matmul_kernel(a, b), got)


@pytest.mark.parametrize("M,layout", [(8, "NN"), (8, "NT"), (1024, "NN")])
def test_block_matmul_kernel_is_deterministic(cuda, M, layout):
    """The K split sums in a fixed order: two calls give the same bits, at
    shapes whose plan splits K (decode) or not."""
    a, b = _operands(cuda, layout, M, 4096, 1024, torch.float32)
    assert torch.equal(block_matmul_kernel(a, b), block_matmul_kernel(a, b))


def test_embedding_backward_repeats_bitwise(cuda):
    """The embedding gradient sums each row's tokens in token order, with
    no atomics: 4096 tokens over 7 ids give the same bits on every call
    (``index_add_`` would add them in an order that changes)."""
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.core.parallel import embedding_lookup
    gen = torch.Generator(device=cuda).manual_seed(3)
    toks = torch.randint(0, 7, (4, 1024), generator=gen, device=cuda)
    ct = torch.randn((4, 1024, 2048), generator=gen, device=cuda)
    grads = []
    for _ in range(3):
        table = torch.zeros((64, 2048), device=cuda, requires_grad=True)
        embedding_lookup(toks, table, MeshAxes()).backward(ct)
        grads.append(table.grad)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0],
                                                           grads[2])
    want = torch.zeros((64, 2048), dtype=torch.float64, device=cuda)
    want.index_add_(0, toks.reshape(-1), ct.reshape(-1, 2048).double())
    torch.testing.assert_close(grads[0].double(), want, rtol=1e-5,
                               atol=1e-4)


ATTN = {  # (B, T, S, nq, nkv, hd, causal, window, kv_len)
    "causal_gqa": (2, 200, 200, 8, 4, 128, True, 0, 0),
    "window": (1, 150, 150, 4, 2, 64, True, 33, 0),
    "ragged_kv_len": (2, 70, 90, 4, 4, 128, False, 0, 61),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ATTN))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    """Forward and backward (dq, dk, dv) against the plain version and its
    autograd; the forward run twice gives the same bits."""
    B, T, S, nq, nkv, hd, causal, window, kv_len = ATTN[case]
    gen = torch.Generator(device=cuda).manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            dtype).requires_grad_()
    q, k, v = rand(B, T, nq, hd), rand(B, S, nkv, hd), rand(B, S, nkv, hd)
    dout = torch.randn((B, T, nq, hd), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    before = ops.launches()
    got = ops.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(got, (q, k, v), dout)
    after = ops.launches()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    want = attn_core(q, k, v, **kw)
    wgrads = torch.autograd.grad(want, (q, k, v), dout)
    tol = TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    for g, w in zip(grads, wgrads):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    again, _ = flash_attention_kernel(q.detach(), k.detach(), v.detach(),
                                      **kw)
    assert torch.equal(again, got.detach())


def _lse_plain(q, k, causal, window, kv_len):
    """Each row's log-sum-exp of its visible scaled scores, fp32, NEG_INF
    where a row sees no key (B, nq, T)."""
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, T, nkv, nq // nkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / hd ** 0.5
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    vis = (j < (kv_len or S)).expand(T, S).clone()
    if causal:
        vis &= i >= j
    if window:
        vis &= (i - j) < window
    lse = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    return torch.where(vis.any(-1), lse, torch.full_like(lse, -1e30)
                       ).reshape(B, nq, T)


FWD_EDGES = {  # (B, T, S, nq, nkv, hd, causal, window, kv_len, shift)
    "T 130 causal kv_len 100, g4": (2, 130, 130, 8, 2, 128, True, 0, 100, 0),
    "T 97 of S 150, kv_len 120, hd 64": (1, 97, 150, 4, 2, 64, False, 0,
                                         120, 0),
    "unaligned rows, T 70 causal window 30": (1, 70, 70, 4, 2, 128, True,
                                              30, 0, 1),
    "T 1 over 77 keys": (3, 1, 77, 4, 2, 128, False, 0, 0, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FWD_EDGES))
def test_flash_attention_forward_edges_match_plain(cuda, case, dtype):
    """K2's forward on T not a multiple of the 64-row tile, kv_len < S,
    rows read through strides (16-byte aligned, or not) and bf16: out
    against the plain version, lse against the plain log-sum-exp, and two
    calls give the same bits."""
    B, T, S, nq, nkv, hd, causal, window, kv_len, shift = FWD_EDGES[case]
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rand(n, h):
        wide = torch.randn((B, n, h, hd + 8), generator=gen, device=cuda)
        return wide.to(dtype)[..., shift:shift + hd]
    q, k, v = rand(T, nq), rand(S, nkv), rand(S, nkv)
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    out, lse = flash_attention_kernel(q, k, v, **kw)
    want = attn_core(q, k, v, **kw)
    err = float((out.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * float(want.float().abs().max())
    torch.testing.assert_close(lse, _lse_plain(q, k, **kw), rtol=1e-5,
                               atol=1e-4)
    again, lse2 = flash_attention_kernel(q, k, v, **kw)
    assert torch.equal(out, again) and torch.equal(lse, lse2)


# chip_smoke.py's ATTN_CASES: the training shape, a window, a ragged
# non-causal kv_len and Jamba's prefill (B, T, S, nq, nkv, hd, causal,
# window, kv_len), and its FLASH_TOL, as max|kernel - plain| <= tol *
# max|plain|
ATTN_SMOKE = {
    "train": (2, 512, 512, 16, 8, 128, True, 0, 0),
    "window_128": (2, 512, 512, 16, 8, 128, True, 128, 0),
    "ragged_kv_len_non_causal": (2, 200, 320, 16, 8, 128, False, 0, 300),
    "jamba_prefill": (4, 512, 512, 32, 8, 128, True, 0, 0),
}
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ATTN_SMOKE))
def test_flash_attention_backward_at_the_path_shapes(cuda, case, dtype):
    """K2's backward (dq, dk, dv) at the training and prefill shapes
    against autograd of the plain forward, and two calls on the same
    inputs give the same bits."""
    B, T, S, nq, nkv, hd, causal, window, kv_len = ATTN_SMOKE[case]
    gen = torch.Generator(device=cuda).manual_seed(4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    q, k, v, dout = (rand(B, T, nq, hd), rand(B, S, nkv, hd),
                     rand(B, S, nkv, hd), rand(B, T, nq, hd))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    out, lse = flash_attention_kernel(q, k, v, **kw)
    grads = FA.flash_attention_bwd_kernel(q, k, v, out, lse, dout, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attn_core(*leaves, **kw), leaves, dout)
    for g, w in zip(grads, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= FLASH_TOL[dtype] * float(w.float().abs().max()), err
    again = FA.flash_attention_bwd_kernel(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


# ---------------------------------------------------------------------- #
# K4 partial flash attention, forward and backward
# ---------------------------------------------------------------------- #

PARTIAL = {  # (B, C, nq, nkv, hd, p, r, window): rank r's chain of p blocks
    "seq_path": (2, 256, 16, 8, 128, 2, 1, 0),
    "window_hd64": (1, 150, 4, 2, 64, 2, 0, 70),
    "p3_ragged": (2, 70, 8, 4, 128, 3, 2, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PARTIAL))
def test_partial_attention_kernel_matches_plain(cuda, case, dtype):
    """K4's chain over striped blocks: the carry and the finalised output
    against the plain chain; the backward against the plain chain's
    autograd; forward and backward each run twice give the same bits."""
    B, C, nq, nkv, hd, p, r, window = PARTIAL[case]
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    q, kg, vg = rand(B, C, nq, hd), rand(B, p * C, nkv, hd), \
        rand(B, p * C, nkv, hd)
    dout = rand(B, C, nq, hd)
    before = ops.launches()
    carry = partial_chain(q, kg, vg, r, p, window=window)
    out = FA.attn_partial_finalize(carry, dtype)
    grads = partial_chain_bwd(q, kg, vg, dout, out, carry, r, p,
                              window=window)
    after = ops.launches()
    assert after["partial_attention"] == before["partial_attention"] + p
    assert (after["partial_attention_bwd"]
            == before["partial_attention_bwd"] + p)
    # the plain chain on fp32 copies of the same inputs: the kernel
    # computes in fp32 too, and bf16 rounds only its output (and delta)
    leaves = [t.float().requires_grad_() for t in (q, kg, vg)]
    wcarry = partial_chain(*leaves, r, p, window=window, plain=True)
    want = FA.attn_partial_finalize(wcarry, torch.float32)
    wgrads = torch.autograd.grad(want, leaves, dout.float())
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.detach(), rtol=tol,
                               atol=tol)
    for g, w in zip(carry, wcarry):
        torch.testing.assert_close(g, w.detach(), rtol=2e-4, atol=2e-4)
    for g, w in zip(grads, wgrads):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    again = partial_chain(q, kg, vg, r, p, window=window)
    assert all(torch.equal(a, b) for a, b in zip(again, carry))
    assert all(torch.equal(a, b) for a, b in zip(
        partial_chain_bwd(q, kg, vg, dout, out, carry, r, p, window=window),
        grads))


def test_partial_attention_kernel_keeps_a_masked_rows_carry(cuda):
    """Queries at 0, 2, 4, ... against keys at 1, 3, 5, ...: row 0 sees no
    key of the block and keeps its carry bit for bit; rows past q_len
    too."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, C, nq, nkv, hd = 2, 96, 4, 2, 128
    q = torch.randn((B, C, nq, hd), generator=gen, device=cuda)
    k0, v0, k, v = (torch.randn((B, C, nkv, hd), generator=gen, device=cuda)
                    for _ in range(4))
    start = FA.partial_attention_kernel(
        q, k0, v0, *FA.attn_partial_init(B, C, nq, hd, device=cuda),
        q_stride=2, k_stride=2)
    got = FA.partial_attention_kernel(q, k, v, *start, q_stride=2, k_pos0=1,
                                      k_stride=2, q_len=80)
    for g, s in zip(got, start):
        assert torch.equal(g[:, :, 0], s[:, :, 0])
        assert torch.equal(g[:, :, 80:], s[:, :, 80:])
    want = FA.partial_attention_plain(q, k, v, *start, q_stride=2, k_pos0=1,
                                      k_stride=2, q_len=80)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [0, 300])
def test_partial_attention_kernel_over_more_than_one_wave(cuda, window):
    """K4's forward with more query tiles than the card holds at once (B
    2, 2048 queries at 2 i + 1, 16 heads: 2048 blocks of 32 rows for 264
    two-block slots), keys at 2 j over two blocks: the carry against the
    plain version, and two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, C, nq, nkv, hd = 2, 2048, 16, 8, 128
    q = torch.randn((B, C, nq, hd), generator=gen, device=cuda)
    k0, v0, k, v = (torch.randn((B, C, nkv, hd), generator=gen, device=cuda)
                    for _ in range(4))
    pos = dict(q_pos0=1, q_stride=2, k_stride=2, window=window)
    start = FA.partial_attention_kernel(
        q, k0, v0, *FA.attn_partial_init(B, C, nq, hd, device=cuda),
        **dict(pos, k_pos0=0))
    got = FA.partial_attention_kernel(q, k, v, *start, **dict(pos, k_pos0=1))
    want = FA.partial_attention_plain(q, k, v, *start,
                                      **dict(pos, k_pos0=1))
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err
    again = FA.partial_attention_kernel(q, k, v, *start,
                                        **dict(pos, k_pos0=1))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_partial_attention_kernel_refuses_unsupported_inputs(cuda):
    q = torch.zeros((1, 8, 4, 128), device=cuda)
    kv = torch.zeros((1, 8, 2, 128), device=cuda)
    carry = FA.attn_partial_init(1, 8, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="stride >= 1"):
        FA.partial_attention_kernel(q, kv, kv, *carry, k_stride=0)
    with pytest.raises(ValueError, match="contiguous fp32"):
        FA.partial_attention_kernel(q, kv, kv, carry[0].double(),
                                    *carry[1:])
    with pytest.raises(ValueError, match="head_dim"):
        FA.partial_attention_kernel(q[..., :96], kv[..., :96], kv[..., :96],
                                    *FA.attn_partial_init(1, 8, 4, 96,
                                                          device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        FA.partial_attention_kernel(q.cpu(), kv, kv, *carry)


# ---------------------------------------------------------------------- #
# K6 selective scan, and fixed-batch serving of the hybrid decoder
# ---------------------------------------------------------------------- #

def _scan(cuda, Bt, T, d, N, dtype, seed=0, with_s0=True):
    """K6 inputs as the Mamba layer makes them: B and C column views of
    one (Bt, T, 5 + 2N) projection output, dt fp32."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    x = rand(Bt, T, d).to(dtype)
    dt = torch.nn.functional.softplus(rand(Bt, T, d)) * 0.1
    A = -torch.exp(0.5 * rand(d, N))
    xdbc = rand(Bt, T, 5 + 2 * N).to(dtype)
    s0 = 0.5 * rand(Bt, d, N) if with_s0 else None
    return x, dt, A, xdbc[..., 5:5 + N], xdbc[..., 5 + N:], s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,T,d,N,with_s0", [
    (2, 128, 256, 16, False), (1, 77, 100, 16, True), (4, 1, 384, 16, True),
    (3, 40, 130, 16, True)])
def test_selective_scan_kernel_matches_plain(cuda, Bt, T, d, N, with_s0,
                                             dtype):
    """y and the final state against the sequential plain version; the
    kernel run twice gives the same bits."""
    args = _scan(cuda, Bt, T, d, N, dtype, with_s0=with_s0)
    n = selective_scan_kernel.launches
    y, s = ops.selective_scan(*args[:5], args[5])
    assert selective_scan_kernel.launches == n + 1
    wy, ws = selective_scan_plain(*args[:5], args[5])
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y, wy, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(s, ws, rtol=2e-4, atol=2e-4)
    y2, s2 = selective_scan_kernel(*args[:5], args[5])
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_selective_scan_kernel_refuses_unsupported_inputs(cuda):
    x, dt, A, B, C, s0 = _scan(cuda, 1, 4, 64, 16, torch.float32)
    with pytest.raises(TypeError, match="float32 dt"):
        selective_scan_kernel(x, dt.to(torch.bfloat16), A, B, C, s0)
    with pytest.raises(ValueError, match="d_state in"):
        selective_scan_kernel(x, dt, A[:, :4], B[..., :4], C[..., :4])


def test_fixed_serving_kernels_match_plain(cuda):
    """Jamba (dense FFN, reduced): prefill and 3 decode steps through the
    kernels (K1, K2, K3, K5, K6) against the plain versions."""
    cfg = get_config("jamba-v0.1-52b-dense-ffn").reduced()
    model = ST.init_model(cfg, seed=0, device=cuda)
    B, T, GEN = 2, 40, 4
    pre, ct = ST.make_prefill_step(cfg, model.axes)(B, T, T + GEN)
    dec, _ = ST.make_decode_step(cfg, model.axes)(B, T + GEN)
    tokens = torch.randint(0, cfg.vocab_size, (B, T),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32).to(cuda)
    caches = {p: ST.zeros_caches(ct, cuda) for p in (False, True)}
    before = ops.launches()
    out = {p: pre(model, caches[p], tokens, plain=p)[0] for p in caches}
    for i in range(GEN - 1):
        torch.testing.assert_close(out[False], out[True], rtol=1e-4,
                                   atol=1e-4)
        tok = out[True][:, -1].argmax(-1)[:, None].to(torch.int32)
        out = {p: dec(model, caches[p], tok, T + i, plain=p)[0]
               for p in caches}
    torch.testing.assert_close(out[False], out[True], rtol=1e-4, atol=1e-4)
    after = ops.launches()
    assert after["selective_scan"] - before["selective_scan"] == 7 * GEN
    assert after["flash_attention"] - before["flash_attention"] == 1
    assert after["paged_attention"] - before["paged_attention"] == GEN - 1
