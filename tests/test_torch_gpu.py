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
from repro_torch.kernels.mla_decode import (mla_decode_kernel,
                                            mla_decode_plain)
from repro_torch.kernels.flash_attention import (attn_core,
                                                 flash_attention_kernel,
                                                 paged_attention_kernel,
                                                 paged_attention_plain)
from repro_torch.kernels.rmsnorm import (
    rmsnorm_apply_kernel, rmsnorm_apply_plain, rmsnorm_kernel, rmsnorm_plain,
    rmsnorm_stats_kernel, rmsnorm_stats_plain)
from repro_torch.kernels.selective_scan import (
    CHUNK, selective_scan_bwd_kernel, selective_scan_bwd_plain,
    selective_scan_kernel, selective_scan_plain)
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
@pytest.mark.parametrize("shape", [(3, 5, 2048), (17, 128), (1, 96),
                                   (2048, 4096)])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    """Each layout of K3 (a block per row, a warp per row, the strided
    loop) against the plain version; a row normed alone gives the bits it
    gets among the others."""
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
    rows, flat = x.reshape(-1, shape[-1]), got.reshape(-1, shape[-1])
    for i in {0, rows.shape[0] // 2, rows.shape[0] - 1}:
        assert torch.equal(rmsnorm_kernel(rows[i:i + 1], g)[0], flat[i])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((8, 1024), 0), ((256, 1024), 0),
                                          ((19, 128), 0), ((10, 120), 0),
                                          ((3, 1024), 1), ((9, 128), 3)])
def test_rmsnorm_stats_and_apply_match_plain(cuda, shape, offset, dtype):
    """K3's stats and apply passes (an x-sharded row's two halves around
    the psum) against their plain versions at the mesh path's local widths
    and on rows off 16 bytes; stats then apply on a whole row equals the
    single pass within K3's tolerance (and in its bits)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    rows, d = shape
    buf = torch.randn((rows * d + offset,), generator=gen, device=cuda)
    x = buf[offset:].view(rows, d).to(dtype)
    if offset:
        x = torch.empty((rows * d + offset,), dtype=dtype,
                        device=cuda)[offset:].view(rows, d).copy_(x)
    g = (1 + 0.1 * torch.randn((d,), generator=gen, device=cuda)).to(dtype)
    n = (rmsnorm_stats_kernel.launches, rmsnorm_apply_kernel.launches)
    ss = ops.rmsnorm_stats(x)
    torch.testing.assert_close(ss, rmsnorm_stats_plain(x), rtol=1e-5,
                               atol=1e-5)
    total = ss + torch.rand((rows,), generator=gen, device=cuda) * d
    got = ops.rmsnorm_apply(x, g, total, full_dim=2 * d)
    assert (rmsnorm_stats_kernel.launches,
            rmsnorm_apply_kernel.launches) == (n[0] + 1, n[1] + 1)
    torch.testing.assert_close(
        got, rmsnorm_apply_plain(x, g, total, full_dim=2 * d),
        rtol=TOL[dtype], atol=TOL[dtype])
    split = rmsnorm_apply_kernel(x, g, ss, full_dim=d)
    torch.testing.assert_close(split, rmsnorm_kernel(x, g), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.equal(split, rmsnorm_kernel(x, g))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_LONG))
@pytest.mark.parametrize("shift", [0, 100, -400])
def test_paged_attention_kernel_lse_matches_plain(cuda, case, dtype, shift):
    """K5's log-sum-exp (the seq-sharded decode's merge reads it): the
    rows' q_pos less ``shift``, as a shard of a sequence-sharded cache
    sees the query (below 0: no key, lse NEG_INF and out 0; past the
    table: every key), against the plain version's m + log l; out
    bitwise the call without the lse."""
    T, g, hd, page, window, ctx, q_len = PAGED_LONG[case]
    q, kp, vp, table, q_pos, ql = _paged_long(
        cuda, dtype, T=T, g=g, hd=hd, page=page, ctx=ctx,
        q_len=np.array(q_len, np.int32))
    table = table.clamp(0, kp.shape[0] - 1).contiguous()
    q_pos = (q_pos - shift).contiguous()
    args = (q, kp, vp, table, q_pos, ql)
    out, lse = ops.flash_attention_paged(*args, window=window,
                                         return_lse=True)
    assert torch.equal(out, paged_attention_kernel(*args, window=window))
    want, want_lse = paged_attention_plain(*args, window=window,
                                           return_lse=True)
    rows = torch.arange(T, device=cuda)[None] < ql[:, None]
    torch.testing.assert_close(out[rows], want[rows], rtol=TOL[dtype],
                               atol=TOL[dtype])
    empty = want_lse == FA.NEG_INF
    assert torch.equal(lse == FA.NEG_INF, empty)
    assert not out[(q_pos < 0) & rows].any()
    torch.testing.assert_close(lse[~empty], want_lse[~empty], rtol=1e-5,
                               atol=1e-5)


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
    + 32); ST reads a as the second half of rows of 2 K and b transposed,
    TS a transposed and b as the second half of rows of 2 N (a ring hop's
    slices). ``shift`` > 0 starts both that many elements into their
    storage, so that neither base is 16-byte aligned."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        x = torch.randn((shape[0], shape[1] + shift), generator=gen,
                        device=cuda).to(dtype)
        return x[:, shift:]
    a = (rand(K, M).t() if layout in ("TN", "TS") else
         rand(M, K + 32)[:, :K] if layout == "SN" else
         rand(M, 2 * K)[:, K:] if layout == "ST" else rand(M, K))
    b = (rand(N, K).t() if layout in ("NT", "ST") else
         rand(K, 2 * N)[:, N:] if layout == "TS" else rand(K, N))
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


@pytest.mark.parametrize("layout", ["NN", "NT", "TN", "SN"])
@pytest.mark.parametrize("M", MATMUL_M)
def test_block_matmul_kernel_writes_float32_for_bf16_operands(cuda, M,
                                                              layout):
    """bf16 operands with a float32 output (a weight gradient before its z
    reduce-scatter), on every path: held to the plain version at the
    float32 tolerance; rounded to bf16 it is the bf16 output's bits."""
    a, b = _operands(cuda, layout, M, 512, 384, torch.bfloat16)
    got = ops.matmul(a, b, out_dtype=torch.float32)
    want = block_matmul_plain(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (M, 384)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert torch.equal(got.to(torch.bfloat16), block_matmul_kernel(a, b))


@pytest.mark.parametrize("M,layout", [(8, "NN"), (8, "NT"), (1024, "NN")])
def test_block_matmul_kernel_is_deterministic(cuda, M, layout):
    """The K split sums in a fixed order: two calls give the same bits, at
    shapes whose plan splits K (decode) or not."""
    a, b = _operands(cuda, layout, M, 4096, 1024, torch.float32)
    assert torch.equal(block_matmul_kernel(a, b), block_matmul_kernel(a, b))


# chip_smoke.py's RING_MATMUL_SHAPES: K1 on one ring hop of the overlapped
# schedule on (1,2,2,2) at full width (M, K, N, layout, fp32 output)
RING_HOPS = [(512, 1024, 1536, "NN", False), (512, 1536, 1024, "ST", False),
             (1024, 512, 1536, "TS", True), (512, 512, 76032, "ST", True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,layout,f32_out", RING_HOPS)
def test_block_matmul_kernel_at_the_ring_hop_shapes(cuda, M, K, N, layout,
                                                    f32_out, dtype):
    """The overlapped schedule's per-hop GEMMs: the forward on a z block,
    dX on a column slice of dY against the block transposed, dW against a
    column slice of dY (fp32 out), the tied head's hop on a column slice
    of h (fp32 out); held to the plain version, two calls bitwise."""
    a, b = _operands(cuda, layout, M, K, N, dtype)
    out = torch.float32 if f32_out else None
    got = ops.matmul(a, b, out_dtype=out)
    want = block_matmul_plain(a, b, out_dtype=out)
    tol = 1e-5 if f32_out or dtype == torch.float32 else 1e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * float(
        want.float().abs().max())
    assert torch.equal(block_matmul_kernel(a, b, out_dtype=out), got)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [512, 130])
def test_flash_attention_at_mla_widths(cuda, T, dtype):
    """K2 at MLA's q/k 192 and v 128 (DeepSeek-V2-Lite's 16/16 heads),
    forward and backward against the plain attn_core and its autograd, and
    bitwise on a repeat."""
    gen = torch.Generator(device=cuda).manual_seed(6)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    q, k, v, dout = (rand(2, T, 16, 192), rand(2, T, 16, 192),
                     rand(2, T, 16, 128), rand(2, T, 16, 128))
    out, lse = flash_attention_kernel(q, k, v, causal=True)
    want = attn_core(q, k, v, causal=True)
    assert out.shape == want.shape == (2, T, 16, 128)
    err = float((out.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max()), err
    grads = FA.flash_attention_bwd_kernel(q, k, v, out, lse, dout,
                                          causal=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    wants = torch.autograd.grad(attn_core(*leaves, causal=True), leaves,
                                dout)
    for g, w in zip(grads, wants):
        err = float((g.float() - w.float()).abs().max())
        assert err <= FLASH_TOL[dtype] * float(w.float().abs().max()), err
    again = FA.flash_attention_bwd_kernel(q, k, v, out, lse, dout,
                                          causal=True)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


# K1's batched entry at the expert shapes (E, C, K, N, layout): DeepSeek's
# up and down projections forward, dX and dW; Jamba's prefill and decode
BMM_SHAPES = [(64, 120, 2048, 2816, "NN"), (64, 120, 1408, 2048, "NN"),
              (64, 120, 2816, 2048, "NT"), (64, 120, 2048, 2816, "TN"),
              (16, 320, 4096, 1024, "NN"), (16, 4, 4096, 2048, "NN"),
              (3, 17, 100, 72, "NT")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,K,N,layout", BMM_SHAPES)
def test_block_matmul_batched_kernel_matches_plain(cuda, E, C, K, N, layout,
                                                   dtype):
    """One launch for the E products, against the plain version (fp32
    upcast) at the 2-D entry's tolerance; bitwise on a repeat; for bf16
    the float32 output rounds to the bf16 one."""
    from repro_torch.kernels.block_matmul import (
        block_matmul_batched_kernel, block_matmul_batched_plain)
    gen = torch.Generator(device=cuda).manual_seed(E + C + K + N)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    a = rand(E, K, C).transpose(1, 2) if layout == "TN" else rand(E, C, K)
    b = rand(E, N, K).transpose(1, 2) if layout == "NT" else rand(E, K, N)
    n = block_matmul_batched_kernel.launches
    got = ops.bmm(a, b)
    assert block_matmul_batched_kernel.launches == n + 1
    want = block_matmul_batched_plain(a, b)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * float(want.float().abs().max()), err
    assert torch.equal(ops.bmm(a, b), got)
    if dtype == torch.bfloat16:
        wide = ops.bmm(a, b, out_dtype=torch.float32)
        assert torch.equal(wide.to(dtype), got)


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
    with pytest.raises(ValueError, match="widths in"):
        FA.partial_attention_kernel(q[..., :96], kv[..., :96], kv[..., :96],
                                    *FA.attn_partial_init(1, 8, 4, 96,
                                                          device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        FA.partial_attention_kernel(q.cpu(), kv, kv, *carry)


# ---------------------------------------------------------------------- #
# K6 selective scan, and fixed-batch serving of the hybrid decoder
# ---------------------------------------------------------------------- #

def _scan(cuda, Bt, T, d, N, dtype, seed=0, with_s0=True, lead=5):
    """K6 inputs as the Mamba layer makes them: B and C column views of
    one (Bt, T, lead + 2N) projection output, dt fp32. ``lead`` 5 puts B
    and C off 16 bytes (the kernel's scalar path); the Mamba layer's
    dt_rank of 256 keeps every row 16-byte aligned (its 16-byte path)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    x = rand(Bt, T, d).to(dtype)
    dt = torch.nn.functional.softplus(rand(Bt, T, d)) * 0.1
    A = -torch.exp(0.5 * rand(d, N))
    xdbc = rand(Bt, T, lead + 2 * N).to(dtype)
    s0 = 0.5 * rand(Bt, d, N) if with_s0 else None
    return x, dt, A, xdbc[..., lead:lead + N], xdbc[..., lead + N:], s0


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,T,d,with_s0", [
    (2, 1100, 200, False), (1, 1100, 200, True), (3, 1, 320, True),
    (4, 512, 8192, False)])
def test_selective_scan_kernel_load_paths_and_chunks(cuda, Bt, T, d,
                                                     with_s0, dtype):
    """B and C at the Mamba layer's aligned column offsets (the 16-byte
    path) and off 16 bytes (the scalar path), over many double-buffered
    32-step chunks with a ragged last one (T 1100), d not a multiple of
    the block's 64 channels (200), decode and the prefill shape: each
    within its tolerance of the plain version, both paths the same bits,
    each run twice the same bits."""
    args = _scan(cuda, Bt, T, d, 16, dtype, seed=T + d, with_s0=with_s0,
                 lead=256)
    x, dt, A, B, C, s0 = args
    y, s = selective_scan_kernel(*args)
    wy, ws = selective_scan_plain(*args)
    torch.testing.assert_close(y, wy, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(s, ws, rtol=2e-4, atol=2e-4)
    xdbc = torch.zeros((Bt, T, 5 + 32), dtype=dtype, device=cuda)
    xdbc[..., 5:21], xdbc[..., 21:] = B, C
    y1, s1 = selective_scan_kernel(x, dt, A, xdbc[..., 5:21],
                                   xdbc[..., 21:], s0)
    assert torch.equal(y, y1) and torch.equal(s, s1)
    y2, s2 = selective_scan_kernel(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_selective_scan_kernel_refuses_unsupported_inputs(cuda):
    x, dt, A, B, C, s0 = _scan(cuda, 1, 4, 64, 16, torch.float32)
    with pytest.raises(TypeError, match="float32 dt"):
        selective_scan_kernel(x, dt.to(torch.bfloat16), A, B, C, s0)
    with pytest.raises(ValueError, match="d_state in"):
        selective_scan_kernel(x, dt, A[:, :4], B[..., :4], C[..., :4])


def _close_scaled(got, want, tol, what):
    """Within ``tol``, atol scaled by the gradient's largest entry (a sum
    of T terms of both signs)."""
    torch.testing.assert_close(
        got.float(), want.float(), rtol=tol,
        atol=tol * max(1.0, float(want.float().abs().max())), msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,T,d,with_s0,lead", [
    (2, 128, 256, False, 256), (1, 77, 100, True, 5), (2, 300, 4096, False,
                                                       256),
    (3, 1, 130, True, 5), (1, 45, 192, True, 256)])
def test_selective_scan_bwd_kernel_matches_plain(cuda, Bt, T, d, with_s0,
                                                 lead, dtype):
    """K6's backward from the forward's chunk states against
    ``selective_scan_bwd_plain`` (a cotangent for y and for the final
    state), on the 16-byte path (lead 256) and the scalar one (lead 5),
    T over many 32-step chunks with a ragged last one and T 1; the chunk
    states the plain scan's; y and the final state the bits of the forward
    without them; two calls the same bits."""
    x, dt, A, B, C, s0 = _scan(cuda, Bt, T, d, 16, dtype, seed=T + d,
                               with_s0=with_s0, lead=lead)
    gen = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn((Bt, T, d), generator=gen, device=cuda).to(dtype)
    gT = torch.randn((Bt, d, 16), generator=gen, device=cuda)
    y, s, chunks = selective_scan_kernel(x, dt, A, B, C, s0,
                                         chunk_states=True)
    y0, s_0 = selective_scan_kernel(x, dt, A, B, C, s0)
    assert torch.equal(y, y0) and torch.equal(s, s_0)
    assert chunks.shape == (Bt, -(-T // CHUNK), d, 16)
    k = chunks.shape[1] - 1
    _, want = selective_scan_plain(x[:, :k * CHUNK], dt[:, :k * CHUNK], A,
                                   B[:, :k * CHUNK], C[:, :k * CHUNK], s0)
    torch.testing.assert_close(chunks[:, k], want, rtol=2e-4, atol=2e-4)
    n = selective_scan_bwd_kernel.launches
    got = selective_scan_bwd_kernel(x, dt, A, B, C, chunks, dy, s0=s0,
                                    ds_fin=gT)
    assert selective_scan_bwd_kernel.launches == n + 1
    want = selective_scan_bwd_plain(x, dt, A, B, C, dy, s0, gT)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "ds0"), got,
                          want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _close_scaled(g, w, TOL[dtype], name)
    again = selective_scan_bwd_kernel(x, dt, A, B, C, chunks, dy, s0=s0,
                                      ds_fin=gT)
    assert all(g is None or torch.equal(g, h) for g, h in zip(got, again))


def test_selective_scan_function_runs_the_kernels(cuda):
    """``ops.selective_scan`` under autograd: the forward kernel once with
    its chunk states, the backward kernel once, and the gradients of x,
    dt, A, B and C those of the plain Function's."""
    x, dt, A, B, C, _ = _scan(cuda, 2, 70, 128, 16, torch.float32,
                              lead=256)
    grads = {}
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A)]
        xdbc = torch.cat([B, C], -1).clone().requires_grad_()
        before = ops.launches()
        y, _ = ops.selective_scan(*leaves, xdbc[..., :16], xdbc[..., 16:],
                                  plain=plain)
        y.square().sum().backward()
        after = ops.launches()
        runs = (after["selective_scan"] - before["selective_scan"],
                after["selective_scan_bwd"] - before["selective_scan_bwd"])
        assert runs == ((0, 0) if plain else (1, 1))
        grads[plain] = [t.grad for t in leaves] + [xdbc.grad]
    for g, w in zip(grads[False], grads[True]):
        _close_scaled(g, w, TOL[torch.float32], "grad")


def test_jamba_train_step_kernels_match_plain(cuda):
    """Reduced Jamba (dense FFN, 8 layers) on the card: ``lm_loss`` and
    every gradient through the kernels (K1, K2, K3, K6 and K6's
    backward) against the plain versions; per microbatch K6 2 x 7 (the
    forward and remat's recompute) and its backward 7."""
    from repro_torch.models.decoder import lm_loss
    cfg = get_config("jamba-v0.1-52b-dense-ffn").reduced()
    gen = torch.Generator().manual_seed(2)
    tokens, labels = (torch.randint(0, cfg.vocab_size, (2, 64),
                                    generator=gen).cuda() for _ in range(2))
    runs = {}
    for plain in (False, True):
        model = ST.init_model(cfg, seed=0, device=cuda)
        ops.reset_launches()
        loss, _ = lm_loss(model, tokens, labels, remat=True, plain=plain)
        loss.backward()
        runs[plain] = (loss.detach(), {n: p.grad for n, p in
                                       model.named_parameters()},
                       ops.launches())
    (loss, grads, launched), (ploss, pgrads, _) = runs[False], runs[True]
    assert launched["selective_scan"] == 14
    assert launched["selective_scan_bwd"] == 7
    torch.testing.assert_close(loss, ploss, rtol=1e-4, atol=1e-4)
    for n, g in grads.items():
        _close_scaled(g, pgrads[n], 1e-3, n)


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


def test_remat_dots_is_full_bitwise_with_fewer_k1_launches(cuda):
    """Remat policy "dots" on the card at the reduced size: the loss and
    every gradient bitwise "full"'s, and per microbatch 21 K1 products a
    layer where "full" launches 28 (the recompute launches none)."""
    from repro_torch.models.decoder import lm_loss
    cfg = get_config("qwen3-1.7b").reduced()
    gen = torch.Generator().manual_seed(1)
    tokens, labels = (torch.randint(0, cfg.vocab_size, (2, 64),
                                    generator=gen).cuda() for _ in range(2))
    runs = {}
    for policy in ("full", "dots"):
        model = ST.init_model(cfg, seed=0, device="cuda")
        n = block_matmul_kernel.launches
        loss, _ = lm_loss(model, tokens, labels, remat=True,
                          remat_policy=policy)
        loss.backward()
        runs[policy] = (float(loss.detach()), block_matmul_kernel.launches - n,
                        [p.grad for p in model.parameters()])
    (lf, kf, gf), (ld, kd, gd) = runs["full"], runs["dots"]
    assert lf == ld and all(torch.equal(a, b) for a, b in zip(gf, gd))
    L = cfg.n_layers
    assert (kf, kd) == (28 * L + 3, 21 * L + 3)


# K7 at the decode shapes: (B, local heads, cache rows, positions): V2-Lite
# on one card, V3's 128 heads, g_y = 2's 8; positions at 0, the edges of a
# split (16 keys up to 16 heads, 128 above) and of a 16-key tile, and the
# last row
MLA_DECODE = {"dsv2 16 heads": (4, 16, 520, [0, 15, 16, 519]),
              "dsv3 128 heads": (4, 128, 520, [300, 127, 128, 519]),
              "dsv3 128 heads, tile edges": (4, 128, 200, [15, 16, 47, 48]),
              "g_y 2, 8 heads": (4, 8, 100, [99, 31, 32, 5])}


def _mla_decode_inputs(cuda, B, H, S, pos, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q_eff = torch.randn((H, B, 512), generator=gen,
                        device=cuda).transpose(0, 1)
    q_rope = torch.randn((B, H, 64), generator=gen, device=cuda)
    ckv = torch.randn((B, S, 512), generator=gen, device=cuda).to(dtype)
    k_rope = torch.randn((B, S, 64), generator=gen, device=cuda).to(dtype)
    return q_eff, q_rope, ckv, k_rope, torch.tensor(pos, dtype=torch.int32,
                                                    device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MLA_DECODE))
def test_mla_decode_kernel_matches_plain(cuda, case, dtype):
    """K7 against its plain version (the reference's einsums) over a cache
    in either dtype; two calls give the same bits; one launch a call."""
    args = _mla_decode_inputs(cuda, *MLA_DECODE[case], dtype)
    n = mla_decode_kernel.launches
    got = ops.mla_decode(*args, scale=192 ** -0.5)
    assert mla_decode_kernel.launches == n + 1
    torch.testing.assert_close(got, mla_decode_plain(*args,
                                                     scale=192 ** -0.5),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(mla_decode_kernel(*args, scale=192 ** -0.5), got)


def test_mla_decode_kernel_refuses_unsupported_inputs(cuda):
    """Widths other than 512 and 64, a float32 cache beside a bf16 one,
    CPU tensors: each raises, naming what K7 takes."""
    q_eff, q_rope, ckv, k_rope, pos = _mla_decode_inputs(
        cuda, 2, 16, 40, [3, 39], torch.float32)
    with pytest.raises(ValueError, match="latent of 512"):
        mla_decode_kernel(q_eff[..., :64], q_rope, ckv[..., :64], k_rope,
                          pos, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mla_decode_kernel(q_eff, q_rope, ckv, k_rope.bfloat16(), pos,
                          scale=1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        mla_decode_kernel(q_eff.cpu(), q_rope, ckv, k_rope, pos, scale=1.0)


def test_mla_fixed_serving_kernels_match_plain(cuda):
    """Reduced DeepSeek-V3 at MLA's full widths (latent 512, q/k 128 + 64,
    v 128): prefill and 3 decode steps through the kernels (K1 and its
    batched entry, K2 at (192, 128), K3, K7) against the plain versions;
    K7 and its combine once a layer and decode step."""
    import dataclasses

    from repro_torch.models.base import MLACfg
    cfg = get_config("deepseek-v3-671b").reduced()
    cfg = dataclasses.replace(cfg, mla=MLACfg(
        kv_lora_rank=512, q_lora_rank=64, qk_nope_dim=128, qk_rope_dim=64,
        v_dim=128))
    model = ST.init_model(cfg, seed=0, device=cuda)
    B, T, GEN = 2, 70, 4
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
    for k, n in (("mla_decode", cfg.n_layers * (GEN - 1)),
                 ("mla_decode_combine", cfg.n_layers * (GEN - 1)),
                 ("flash_attention", cfg.n_layers)):
        assert after[k] - before[k] == n, k
