"""4D tensor-parallel primitives (port of ``repro.core.parallel``).

Every function on the differentiated path is a ``torch.autograd.Function``
whose backward runs exactly the collectives of the JAX package's
``custom_vjp`` (DESIGN.md §Collective schedule): the z all-gather of a
weight before its local GEMM, the all-reduce over the contraction axis
after it (Algorithm 1 line 6), the all-reduce over the output axis of the
input gradient (line 13) and the z reduce-scatter of the weight gradient.
On the one-device mesh every collective is the identity (``core.mesh``);
the calls stay where the JAX package makes them.

Every local product, forward and backward, goes through ``ops.matmul``
(kernel K1), with transposed operands read as views, and an expert
bank's through ``ops.bmm`` (K1's batched entry, ``tp_batched_matmul``);
``rms_norm`` runs
kernel K3 forward (its single pass over a whole row, or on a row sharded
over x its stats and apply passes around the psum of the sum of squares)
and its backward in PyTorch ops, as the JAX backward is jnp outside any
kernel; ``layer_norm`` is PyTorch ops forward and backward (the JAX
package's is jnp too). ``plain=True`` runs the kernels' plain versions on
any device.

The overlapped schedule rides on ``axes.overlap`` (``core/overlap.py``),
as in the JAX package: ``matmul`` and ``tied_logits`` run the z
collectives of ``tp_matmul`` and the tied head as rings whose hops feed
per-block K1 GEMMs (``core/collective_matmul.py``), ``all_reduce`` runs
their x/y activation all-reduces as reduce-scatter and all-gather rings,
``embed_gather`` gathers the embedding table over z by a ring, and
``cache_weight_gather`` keeps the forward's gathered weight for the
backward. ``OverlapConfig()`` is the blocking schedule, bit for bit. The
norms' and the softmax's scalar psums stay blocking.

The inits draw each global tensor from the generator in the one-card
order and keep this rank's block by the parameter's PartitionSpec
(``partition.LEAF_SPECS``), so a rank's parameters are slices of the
one-card model drawn from the same seed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import collective_matmul as CMM
from repro_torch.core import mesh as M
from repro_torch.core import partition as PT
from repro_torch.core import trace
from repro_torch.kernels import ops

NEG_INF = -1e30


def _mm(a, b, *, plain: bool = False):
    """(..., k) @ (k, n) with fp32 accumulation, in a's dtype (K1)."""
    out = ops.matmul(a.reshape(-1, a.shape[-1]), b, plain=plain)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _mm_tn(a, b, *, plain: bool = False):
    """a^T @ b over all leading dims: (..., k) and (..., n) -> (k, n) in
    float32 (K1 reading a through a transposed view). A weight gradient
    stays fp32 through its z reduce-scatter and is cast once after it, as
    in the reference, so bf16 partials are never summed."""
    return ops.matmul(a.reshape(-1, a.shape[-1]).t(),
                      b.reshape(-1, b.shape[-1]), out_dtype=torch.float32,
                      plain=plain)


# ---------------------------------------------------------------------- #
# replicated-cotangent all-reduce (Megatron's "g" operator)
# ---------------------------------------------------------------------- #

class _ArBwdIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, axes, axis):
        return M.psum(v, axes, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


def ar_bwd_identity(v, axes: M.MeshAxes, axis):
    """Forward all-reduce over ``axis`` (a name or a tuple of names, e.g.
    the token axes data, z and seq); backward identity. Correct when the
    consumer treats the output as replicated over ``axis``."""
    return _ArBwdIdentity.apply(v, axes, axis)


class _BwdPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, axes, axis):
        ctx.cfg = (axes, axis)
        return v.view_as(v)

    @staticmethod
    def backward(ctx, dy):
        axes, axis = ctx.cfg
        return M.psum(dy, axes, axis), None, None


def bwd_psum(v, axes: M.MeshAxes, axis):
    """Forward identity, backward all-reduce over ``axis`` (Megatron's "f"
    operator): ``v`` is replicated over ``axis`` and each rank's consumer
    back-propagates only its own share (its y block of experts or heads),
    so the gradient is the sum of the ranks' shares. The port's own: the
    reference leaves these gradients partial where G_y > 1 (ROADMAP.md
    §3)."""
    return _BwdPsum.apply(v, axes, axis)


# ---------------------------------------------------------------------- #
# the 4D tensor-parallel matmul (paper Algorithm 1 + z axis)
# ---------------------------------------------------------------------- #

def _zring(axes: M.MeshAxes, enabled: bool):
    """The z axis for a ring, or None for the blocking schedule (switched
    off, or z of one rank)."""
    return "z" if enabled and axes.gz > 1 else None


def _arring(axes: M.MeshAxes, ax):
    """``ax`` for an activation all-reduce ring under
    ``overlap.all_reduce``, or None for the blocking psum (switched off,
    no axis, or an axis of one rank)."""
    if not axes.overlap.all_reduce or ax is None or axes.size(ax) <= 1:
        return None
    return ax


def _ar(v, axes: M.MeshAxes, ax):
    """All-reduce ``v`` over ``ax``: a ring over the last dim under
    ``overlap.all_reduce`` (with ``ring_all_reduce``'s fallbacks), else
    the blocking psum."""
    if _arring(axes, ax) is not None:
        return M.ring_all_reduce(v, axes, ax, dim=-1)
    return M.psum(v, axes, ax)


class _TpMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axes, in_shard, out_shard, plain):
        ov = axes.overlap
        ring, ar = _zring(axes, ov.matmul), _arring(axes, in_shard)
        if ring is None or ov.cache_weight_gather:
            gather = M.ring_all_gather if ring else M.all_gather
            wf = gather(w, axes, "z", dim=1)                  # AG_z
            y = (CMM.ar_matmul(x, wf, axes, ar, chunks=ov.ar_chunks,
                               plain=plain) if ar             # line 6
                 else M.psum(_mm(x, wf, plain=plain), axes, in_shard))
        else:
            y = _ar(CMM.ag_matmul(x, w, axes, ring, chunks=ov.z_chunks,
                                  plain=plain), axes, in_shard)
        # the gathered weight is kept for the backward only when asked
        # (one AG_z less a layer, the full block held across the residual)
        ctx.save_for_backward(x, w, wf if ov.cache_weight_gather else None)
        ctx.cfg = (axes, out_shard, plain)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, wf = ctx.saved_tensors
        axes, out_shard, plain = ctx.cfg
        ov = axes.overlap
        ring, ar = _zring(axes, ov.matmul), _arring(axes, out_shard)
        if wf is None and ring is not None:
            # the z re-gather fuses into the GEMM as a ring over the
            # contraction segments
            dx = CMM.accum_matmul_dx(dy, w, axes, ring, chunks=ov.z_chunks,
                                     plain=plain).to(x.dtype)
            dx = _ar(dx, axes, out_shard)
        else:
            if wf is None:
                wf = M.all_gather(w, axes, "z", dim=1)        # re-gather
            if ar is not None:
                dx = CMM.ar_matmul_t(dy, wf, axes, ar, chunks=ov.ar_chunks,
                                     plain=plain)
            else:
                dx = _mm(dy, wf.t(), plain=plain).to(x.dtype)  # dY W^T
                dx = M.psum(dx, axes, out_shard)              # AR (line 13)
        if ring is not None:
            dw = CMM.rs_matmul_dw(x.reshape(-1, x.shape[-1]),
                                  dy.reshape(-1, dy.shape[-1]), axes, ring,
                                  block_w=w.shape[1], chunks=ov.z_chunks,
                                  plain=plain)
        else:
            dw = _mm_tn(x, dy, plain=plain)                   # X^T dY
            dw = M.psum_scatter(dw, axes, "z", dim=1)         # RS_z
        return dx, dw.to(w.dtype), None, None, None, None


def tp_matmul(x, w, axes: M.MeshAxes, in_shard: Optional[str] = "x",
              out_shard: Optional[str] = "y", *, plain: bool = False):
    """Y = X @ W with the paper's 4D collective schedule, W stored (k, n)
    as in the JAX package. ('x', 'y') is a paper "normal" layer, ('y',
    'x') a "transposed" one (§4.1). ``axes.overlap`` picks the rings of
    the overlapped schedule (``matmul``: the z collectives;
    ``all_reduce``: the x/y activation all-reduces)."""
    return _TpMatmul.apply(x, w, axes, in_shard, out_shard, plain)


def tp_matmul_t(x, w, axes: M.MeshAxes, *, plain: bool = False):
    """Paper 'transposed' layer: contract over y, output over x."""
    return tp_matmul(x, w, axes, "y", "x", plain=plain)


# ---------------------------------------------------------------------- #
# batched (per-expert) tp matmul: x (E, C, k) @ w (E, k, n/z)
# ---------------------------------------------------------------------- #

def _bmm(a, b, *, out_dtype=None, plain: bool = False):
    """(E, m, k) @ (E, k, n) with fp32 accumulation (K1's batched entry,
    one launch), in a's dtype or ``out_dtype``."""
    return ops.bmm(a, b, out_dtype=out_dtype, plain=plain)


class _TpBatchedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axes, in_shard, out_shard, plain):
        ov = axes.overlap
        ring, ar = _zring(axes, ov.batched_matmul), _arring(axes, in_shard)
        ctx.save_for_backward(x, w)
        ctx.cfg = (axes, out_shard, plain)
        if ring is None:
            wf = M.all_gather(w, axes, "z", dim=2)
            if ar is not None:
                return CMM.ar_matmul_batched(x, wf, axes, ar,
                                             chunks=ov.ar_chunks, plain=plain)
            y = _bmm(x, wf, plain=plain)
        else:
            y = CMM.ag_matmul_batched(x, w, axes, ring, chunks=ov.z_chunks,
                                      plain=plain)
        return _ar(y, axes, in_shard)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        axes, out_shard, plain = ctx.cfg
        ov = axes.overlap
        ring, ar = _zring(axes, ov.batched_matmul), _arring(axes, out_shard)
        if ring is None:
            wf = M.all_gather(w, axes, "z", dim=2)
            if ar is not None:
                dx = CMM.ar_matmul_batched_t(dy, wf, axes, ar,
                                             chunks=ov.ar_chunks, plain=plain)
            else:
                dx = _bmm(dy, wf.transpose(1, 2), plain=plain).to(x.dtype)
                dx = M.psum(dx, axes, out_shard)
            dw = _bmm(x.transpose(1, 2), dy, out_dtype=torch.float32,
                      plain=plain)
            dw = M.psum_scatter(dw, axes, "z", dim=2)
        else:
            dx = CMM.accum_matmul_dx_batched(dy, w, axes, ring,
                                             chunks=ov.z_chunks, plain=plain)
            dx = _ar(dx.to(x.dtype), axes, out_shard)
            dw = CMM.rs_matmul_dw_batched(x, dy, axes, ring,
                                          block_w=w.shape[2],
                                          chunks=ov.z_chunks, plain=plain)
        return dx, dw.to(w.dtype), None, None, None, None


def tp_batched_matmul(x, w, axes: M.MeshAxes, in_shard: Optional[str],
                      out_shard: Optional[str], *, plain: bool = False):
    """Per-expert matmul with ``tp_matmul``'s 4D collective schedule: x
    (E_local, C, k_local), w (E_local, k_local, n_local/z); the expert dim
    is sharded over (y, expert) by the caller (MoE), so ``in_shard`` and
    ``out_shard`` are 'x' or None. Each product runs on K1's batched
    entry, all E_local experts in one launch. ``axes.overlap``:
    ``batched_matmul`` rings the z collectives as ``tp_matmul``'s
    ``matmul`` does; ``all_reduce`` rings the activation all-reduces.
    The weight gradient is an fp32 sum through its z reduce-scatter, cast
    once after it."""
    return _TpBatchedMatmul.apply(x, w, axes, in_shard, out_shard, plain)


def tp_expert_init(gen: torch.Generator, n_experts: int, k: int, n: int,
                   axes: M.MeshAxes, *, in_shard: Optional[str] = "x",
                   out_shard: Optional[str] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """The expert bank (E, k, n) drawn from N(0, 1) / sqrt(k) (the
    reference's ``tp_expert_init``); this rank keeps its block: E over (y,
    expert), y-major (so the layout is the y-only one at g_expert = 1), k
    over ``in_shard``, n over (``out_shard``, z). Its gradient is
    z-reduced by ``tp_batched_matmul``'s backward (``z_reduced``)."""
    v = torch.randn((n_experts, k, n), generator=gen, device=gen.device,
                    dtype=torch.float32)
    out = ((out_shard,) if out_shard else ()) + ("z",)
    spec = (("y", "expert"), in_shard, PT._dim(out))
    return PT.keep_shard(v.div_(math.sqrt(k)).to(dtype), axes, spec)


# ---------------------------------------------------------------------- #
# vocab-parallel embedding (rows over y, cols over (x, z))
# ---------------------------------------------------------------------- #

def _local_ids(tokens, axes, v_local):
    local = tokens.long() - M.axis_index(axes, "y") * v_local
    return local, (local >= 0) & (local < v_local)


def segment_sum(idx, rows, n_rows: int):
    """(n_rows, h) whose row i is the sum of the ``rows[t]`` with
    ``idx[t] == i``, added in t order from zero, the same bits on every
    run. Tokens are ranked by their occurrence of their id (a stable
    sort); pass k adds every id's k-th row, and within a pass no id
    repeats, so no two adds meet. One pass per occurrence of the most
    frequent id; ``index_add_`` instead sums repeated ids with atomics on
    CUDA, in an order that changes from run to run."""
    n = idx.numel()
    out = torch.zeros((n_rows, rows.shape[-1]), dtype=rows.dtype,
                      device=rows.device)
    if n == 0:
        return out
    order = torch.sort(idx, stable=True).indices       # by id, then t
    sidx = idx[order]
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    occ = pos - start                                  # k of each token
    by_k = torch.sort(occ, stable=True).indices
    tok, ids = order[by_k], sidx[by_k]
    off = 0
    for c in torch.bincount(occ).tolist():
        i, t = ids[off:off + c], tok[off:off + c]
        out.index_put_((i,), out[i] + rows[t])
        off += c
    return out


class _EmbeddingLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, table, axes):
        # a ring puts the same blocks in the same places (bitwise)
        gather = (M.ring_all_gather if axes.overlap.embed_gather
                  else M.all_gather)
        with trace.scope("embed_gather", "z"):
            tf = gather(table, axes, "z", dim=1)
        local, ok = _local_ids(tokens, axes, tf.shape[0])
        emb = tf[local.clamp(0, tf.shape[0] - 1)]
        emb = torch.where(ok[..., None], emb, torch.zeros_like(emb))
        ctx.save_for_backward(tokens)
        ctx.cfg = (axes, table.shape[0], table.dtype)
        # assemble across vocab shards (backward: identity)
        return M.psum(emb, axes, "y")

    @staticmethod
    def backward(ctx, demb):
        (tokens,) = ctx.saved_tensors
        axes, v_local, dtype = ctx.cfg
        local, ok = _local_ids(tokens, axes, v_local)
        idx = torch.where(ok, local, torch.full_like(local, v_local))
        h = demb.shape[-1]
        # out-of-range rows land on the extra row v_local and are dropped
        dtab = segment_sum(idx.reshape(-1), demb.reshape(-1, h).float(),
                           v_local + 1)
        dtab = M.psum_scatter(dtab[:-1], axes, "z", dim=1)
        return None, dtab.to(dtype), None


def embedding_lookup(tokens, table, axes: M.MeshAxes):
    """tokens (B, S) int; table (V/y, d/(x z)) -> (B, S, d/x), features
    sharded over x, replicated over y; the table gathered over z by a
    ring under ``overlap.embed_gather``. The table's gradient is an fp32
    sum in token order (:func:`segment_sum`), reduce-scattered over z by
    the blocking collective, as in the reference's ``_emb_bwd``. With
    tracing on, the gather runs under the reference's scope
    ``embed_gather[z]``; the backward's reduce-scatter, like the
    reference's, under none."""
    return _EmbeddingLookup.apply(tokens, table, axes)


# ---------------------------------------------------------------------- #
# tied-embedding LM head: logits = h @ table^T with the paper schedule
# ---------------------------------------------------------------------- #

class _TiedLmLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, table, axes, plain):
        ov = axes.overlap
        ring, ar = _zring(axes, ov.tied_logits), _arring(axes, "x")
        ctx.save_for_backward(h, table)
        ctx.cfg = (axes, plain)
        if ring is None:
            tf = M.all_gather(table, axes, "z", dim=1)        # (V/y, d/x)
            if ar is not None:
                # the reduced (V) dim indexes the table's rows
                return CMM.ar_matmul_t(h, tf, axes, ar, chunks=ov.ar_chunks,
                                       plain=plain)
            logits = _mm(h, tf.t(), plain=plain)
        else:
            # the gathered (d) dim is the contraction: accumulate over the
            # z segments of h against the table's blocks
            logits = CMM.accum_matmul_tied(h, table, axes, ring,
                                           chunks=ov.z_chunks,
                                           plain=plain).to(h.dtype)
        return _ar(logits, axes, "x")

    @staticmethod
    def backward(ctx, dlogits):
        h, table = ctx.saved_tensors
        axes, plain = ctx.cfg
        ov = axes.overlap
        ring, ar = _zring(axes, ov.tied_logits), _arring(axes, "y")
        if ring is None:
            tf = M.all_gather(table, axes, "z", dim=1)
            if ar is not None:
                dh = CMM.ar_matmul(dlogits, tf, axes, ar,
                                   chunks=ov.ar_chunks, plain=plain)
            else:
                dh = M.psum(_mm(dlogits, tf, plain=plain).to(h.dtype), axes,
                            "y")
            dt = M.psum_scatter(_mm_tn(dlogits, h, plain=plain), axes, "z",
                                dim=1)
        else:
            dh = CMM.ag_matmul_tied_dh(dlogits, table, axes, ring,
                                       chunks=ov.z_chunks, plain=plain)
            dh = _ar(dh.to(h.dtype), axes, "y")
            dt = CMM.rs_matmul_tied_dt(
                dlogits.reshape(-1, dlogits.shape[-1]),
                h.reshape(-1, h.shape[-1]), axes, ring,
                block_w=table.shape[1], chunks=ov.z_chunks, plain=plain)
        return dh, dt.to(table.dtype), None, None


def tied_lm_logits(h, table, axes: M.MeshAxes, *, plain: bool = False):
    """h (..., d/x); table (V/y, d/(x z)) -> logits (..., V/y),
    replicated over x."""
    return _TiedLmLogits.apply(h, table, axes, plain)


# ---------------------------------------------------------------------- #
# vocab-parallel softmax cross-entropy (fused, hand-written backward)
# ---------------------------------------------------------------------- #

def _masked_fp32(logits, axes, valid_vocab):
    """logits as fp32, padded vocab columns (>= valid_vocab) at NEG_INF,
    and the first global column of this y shard."""
    lg = logits.float()
    v_local = lg.shape[-1]
    start = M.axis_index(axes, "y") * v_local
    if valid_vocab:
        cols = start + torch.arange(v_local, device=lg.device)
        lg = torch.where(cols < valid_vocab, lg,
                         torch.full_like(lg, NEG_INF))
    return lg, start


class _VocabParallelXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, axes, valid_vocab):
        lg, start = _masked_fp32(logits, axes, valid_vocab)
        v_local = lg.shape[-1]
        m = M.pmax(torch.amax(lg, dim=-1), axes, "y")
        se = M.psum(torch.sum(torch.exp(lg - m[..., None]), dim=-1), axes,
                    "y")
        lse = torch.log(se) + m
        local = labels.long() - start
        ok = (local >= 0) & (local < v_local)
        tgt = torch.gather(lg, -1, local.clamp(0, v_local - 1)[..., None]
                           )[..., 0]
        tgt = M.psum(torch.where(ok, tgt, torch.zeros_like(tgt)), axes, "y")
        ctx.save_for_backward(logits, labels, lse)
        ctx.cfg = (axes, valid_vocab)
        return lse - tgt

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        axes, valid_vocab = ctx.cfg
        lg, start = _masked_fp32(logits, axes, valid_vocab)
        v_local = lg.shape[-1]
        probs = torch.exp(lg - lse[..., None])
        local = labels.long() - start
        ok = (local >= 0) & (local < v_local)
        # probs - onehot(label) (no one-hot row for labels off this shard)
        probs.scatter_add_(-1, local.clamp(0, v_local - 1)[..., None],
                           -ok.float()[..., None])
        dlogits = probs.mul_(dloss.float()[..., None])
        return dlogits.to(logits.dtype), None, None, None


def vocab_parallel_xent(logits, labels, axes: M.MeshAxes,
                        valid_vocab: int = 0):
    """logits (..., V/y) sharded over y (replicated over x); labels (...)
    global ids; ``valid_vocab``: the true vocab size (padded columns past
    it are masked). Returns the per-token loss (...) in fp32."""
    return _VocabParallelXent.apply(logits, labels, axes, valid_vocab)


# ---------------------------------------------------------------------- #
# feature-sharded RMSNorm / LayerNorm (stats psum'd over x)
# ---------------------------------------------------------------------- #

class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, axes, axis, full_dim, eps, plain):
        ctx.save_for_backward(x, gamma)
        ctx.cfg = (axes, axis, full_dim, eps)
        if axes.size(axis) == 1:
            return ops.rmsnorm(x, gamma, full_dim=full_dim, eps=eps,
                               plain=plain)
        # the row is sharded over ``axis``: its sum of squares is the psum
        # of the local ones, as in the JAX forward
        ss = M.psum(ops.rmsnorm_stats(x, plain=plain), axes, axis)
        return ops.rmsnorm_apply(x, gamma, ss, full_dim=full_dim, eps=eps,
                                 plain=plain)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        axes, axis, full_dim, eps = ctx.cfg
        xf = x.float()
        # r is recomputed here rather than saved by the kernel
        ms = M.psum(torch.sum(xf * xf, dim=-1), axes, axis) / full_dim
        r = torch.rsqrt(ms + eps)[..., None]
        dyf = dy.float() * gamma.float()
        xhat = xf * r
        # mean over the FULL feature dim -> psum over the sharded axis
        dot = M.psum(torch.sum(dyf * xhat, dim=-1), axes, axis) / full_dim
        dx = (r * (dyf - xhat * dot[..., None])).to(x.dtype)
        dg = torch.sum((dy.float() * xhat).reshape(-1, x.shape[-1]), dim=0)
        return dx, dg.to(gamma.dtype), None, None, None, None, None


def rms_norm(x, gamma, axes: M.MeshAxes, full_dim: int, eps: float = 1e-6,
             *, axis: Optional[str] = "x", plain: bool = False):
    """RMSNorm over a feature dim sharded across ``axis`` (K3 forward: its
    single pass where ``axis`` has one rank, else the stats pass, a psum of
    the sums of squares over ``axis`` and the apply pass). ``axis=None``
    is a row that is never sharded (qk-norm)."""
    return _RmsNorm.apply(x, gamma, axes, axis, full_dim, eps, plain)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, axes, axis, full_dim, eps):
        xf = x.float()
        mu = M.psum(torch.sum(xf, dim=-1), axes, axis) / full_dim
        xc = xf - mu[..., None]
        # the centred variance, a second pass over the row (not E[x^2] -
        # mu^2)
        var = M.psum(torch.sum(xc * xc, dim=-1), axes, axis) / full_dim
        r = torch.rsqrt(var + eps)
        xhat = xc * r[..., None]
        ctx.save_for_backward(xhat, gamma, r)
        ctx.cfg = (axes, axis, full_dim)
        return (xhat * gamma.float() + beta.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, gamma, r = ctx.saved_tensors
        axes, axis, full_dim = ctx.cfg
        dyf = dy.float() * gamma.float()
        # means over the FULL feature dim -> psums over the sharded axis
        mean_dy = M.psum(torch.sum(dyf, dim=-1), axes, axis) / full_dim
        mean_dyx = M.psum(torch.sum(dyf * xhat, dim=-1), axes,
                          axis) / full_dim
        dx = (r[..., None] * (dyf - mean_dy[..., None]
                              - xhat * mean_dyx[..., None])).to(dy.dtype)
        d = dy.shape[-1]
        dg = torch.sum((dy.float() * xhat).reshape(-1, d), dim=0)
        db = torch.sum(dy.float().reshape(-1, d), dim=0)
        return (dx, dg.to(gamma.dtype), db.to(gamma.dtype), None, None, None,
                None)


def layer_norm(x, gamma, beta, axes: M.MeshAxes, full_dim: int,
               eps: float = 1e-5, *, axis: Optional[str] = "x"):
    """LayerNorm over a feature dim sharded across ``axis``, in PyTorch
    ops in the reference's order (no kernel: the JAX package computes it
    in jnp): the mean and the centred variance each a psum of the local
    row sums, computed in fp32, the output in x's dtype. The backward
    psums the means of dy * gamma and of dy * gamma * x-hat and returns dx
    in dy's dtype; the gain's and bias's gradients are this rank's fp32
    sums cast to their dtype (the step's gradient sync reduces them, as it
    does the RMSNorm gain's)."""
    return _LayerNorm.apply(x, gamma, beta, axes, axis, full_dim, eps)


# ---------------------------------------------------------------------- #
# init: the JAX package's distributions, drawn from a torch.Generator
# ---------------------------------------------------------------------- #

def tp_linear_init(gen: torch.Generator, k: int, n: int, axes: M.MeshAxes,
                   in_shard: Optional[str] = "x",
                   out_shard: Optional[str] = "y", *,
                   scale: Optional[float] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """A (k, n) weight drawn from N(0, 1) * scale (default 1/sqrt(k));
    this rank keeps its block by ``partition.wspec(in_shard,
    out_shard)``: k over the contraction shard, n over (output shard, z).
    A width that does not shard is refused in the reference's words."""
    denom = axes.size(out_shard) * axes.gz
    if n % denom:
        raise ValueError(f"weight n={n} not divisible by out*z={denom}")
    if k % axes.size(in_shard):
        raise ValueError(f"weight k={k} not divisible by in={in_shard}")
    s = scale if scale is not None else 1.0 / math.sqrt(k)
    v = torch.randn((k, n), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return PT.keep_shard(v.mul_(s).to(dtype), axes,
                         PT.wspec(in_shard, out_shard))


def embedding_init(gen: torch.Generator, vocab: int, hidden: int,
                   axes: M.MeshAxes, *, dtype=torch.float32) -> torch.Tensor:
    """The (vocab, hidden) table from N(0, 0.02^2); this rank keeps rows
    over y and columns over (x, z)."""
    v = torch.randn((vocab, hidden), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return PT.keep_shard(v.mul_(0.02).to(dtype), axes,
                         PT.LEAF_SPECS["embed"].spec)


def norm_param_init(hidden: int, axes: M.MeshAxes, *, device,
                    dtype=torch.float32, value: float = 1.0) -> torch.Tensor:
    """A per-feature gain (``value`` 1) or bias (0), this rank's slice
    over x (the residual layout)."""
    return torch.full((hidden // axes.gx,), value, dtype=dtype,
                      device=device)
