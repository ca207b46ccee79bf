"""GQA attention (port of the ``"train"`` and ``"paged"`` branches of
``repro.layers.attention``).

Heads shard over y (a paper "normal" layer for q/k/v) and the output
projection is a "transposed" layer (§4.1). Where G_y exceeds the KV heads
(G_y a multiple of n_kv_heads), the KV heads are duplicated across y
ranks, as in the JAX package: one (d, 2 nkv hd) projection ``wkv_dup``,
sharded over x and replicated over y, from which each y rank keeps the one
head its query heads read; its caches hold one KV head. Five modes are
ported:

  * ``"train"``: causal (optionally sliding-window) attention over each
    whole sequence, kernel K2 forward and backward; on a seq axis above 1,
    :func:`seq_attn` over the rank's stripe, kernel K4 forward and
    backward;
  * ``"paged"``: continuous-batching serving; rows are per-slot prefill
    chunks or single decode tokens at per-slot global positions, against a
    physical KV page pool (P, page, nkv, hd) per layer that each slot
    reaches through its page table, kernel K5;
  * ``"prefill"`` and ``"decode"``: fixed-batch serving over a dense cache
    (B, S, nkv, hd). Prefill is K2's forward over the prompt and writes its
    K/V at rows 0..T-1; decode writes row ``pos`` and attends to keys
    0..pos through K5, the contiguous cache seen as pages of
    ``DENSE_PAGE`` rows (S is rounded up to a multiple of it; rows past
    ``pos`` are masked, so the extra rows change nothing);
  * ``"decode_seqshard"``: long-context decode of one sequence whose
    cache's *sequence* dim is sharded over data (the ``long_500k`` shape):
    the shard that owns ``pos`` writes the token's K/V, each shard runs K5
    over its keys with the row's log-sum-exp, and
    :func:`decode_core_seqsharded` merges the shards over data.

qk-norm is kernel K3 with the backward of ``parallel.rms_norm``. The JAX
``attn_core`` (and ``attn_core_chunked``, the same function, with its
``_softmax_fp32``) is K2's plain version, ``attn_core_partial`` K4's and
``paged_attn_core`` K5's; they live beside their kernels, in
``kernels/flash_attention.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core import trace
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.layers.rotary import apply_rope

# rows of the dense decode cache per K5 page: one lane per key
DENSE_PAGE = 32


def _plain_rms(x, gamma, axes: M.MeshAxes, eps: float = 1e-6, *,
               plain: bool = False):
    """Per-head RMSNorm of qk-norm (head_dim is never sharded): K3 over
    rows of width head_dim, with the backward of ``parallel.rms_norm``."""
    return PP.rms_norm(x, gamma, axes, x.shape[-1], eps, axis=None,
                       plain=plain)


def kv_layout(cfg, axes: M.MeshAxes):
    """(nq_local, nkv_local, duplicated?). When G_y > n_kv_heads, KV heads
    are duplicated across y ranks (Megatron's GQA-under-wide-TP layout):
    each y rank holds one."""
    nq_l = cfg.n_heads // axes.gy
    if cfg.n_kv_heads % axes.gy == 0:
        return nq_l, cfg.n_kv_heads // axes.gy, False
    if axes.gy % cfg.n_kv_heads or cfg.n_heads % axes.gy:
        raise ValueError(f"{cfg.name}: cannot lay out {cfg.n_kv_heads} kv "
                         f"heads on G_y={axes.gy}")
    return nq_l, 1, True


class Attention(nn.Module):
    """``attn_init``'s self-attention: separate q/k/v projections, or in
    the duplicated-KV layout q and one kv projection, with optional
    qk-norm. The draws follow the JAX init's order of leaves."""

    def __init__(self, cfg, axes: M.MeshAxes, *, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.axes = cfg, axes
        hd = cfg.head_dim_
        self.nq_l, self.nkv_l, self.dup = kv_layout(cfg, axes)
        nq, nkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model

        def lin(k, n, in_shard="x", out_shard="y"):
            return nn.Parameter(PP.tp_linear_init(
                gen, k, n, axes, in_shard, out_shard, dtype=dtype))
        self.wq = lin(d, nq * hd)
        if self.dup:
            self.wkv_dup = lin(d, 2 * nkv * hd, "x", None)
        else:
            self.wk, self.wv = lin(d, nkv * hd), lin(d, nkv * hd)
        self.wo = lin(nq * hd, d, "y", "x")
        if cfg.qk_norm:
            def ones():
                return nn.Parameter(torch.ones(hd, dtype=dtype,
                                               device=gen.device))
            self.q_norm, self.k_norm = ones(), ones()

    def forward(self, h, *, positions, mode: str = "paged", cache=None,
                paged=None, plain: bool = False):
        """h (R, T, d/x) at global ``positions`` (R, T) -> the attention
        block's output (R, T, d/x).

        ``mode="train"``: causal attention over the T rows of each
        sequence (K2). ``mode="paged"``: ``cache`` holds this layer's pools
        {"k", "v"} (P, page, nkv, hd) and ``paged`` holds {"table": (R,
        n_pages) int32, "q_len": (R,) int32}; the rows' K/V are written
        into the pools in place (the JAX step returns new pools; updating
        in place saves a copy of every pool per step). ``mode="prefill"``
        and ``"decode"``: ``cache`` holds this layer's dense {"k", "v"}
        (B, S, nkv, hd), written in place; decode takes one row per
        sequence, all at the same position."""
        cfg, axes = self.cfg, self.axes
        hd = cfg.head_dim_
        R, T = h.shape[:2]
        q = PP.tp_matmul(h, self.wq, axes, "x", "y", plain=plain).reshape(
            R, T, self.nq_l, hd)
        if self.dup:
            # the output is replicated over y, but each y rank reads its
            # own head of it: the input gradient sums over y, as a
            # y-sharded output's does (the reference passes no output axis
            # here and leaves each y rank's dX partial)
            kv = PP.tp_matmul(h, self.wkv_dup, axes, "x", "y",
                              plain=plain).reshape(R, T, 2, cfg.n_kv_heads,
                                                   hd)
            # this rank's duplicated head: kv head j serves q heads [j g, ..)
            j = (M.axis_index(axes, "y") * cfg.n_kv_heads) // axes.gy
            k = kv[:, :, 0, j:j + 1].contiguous()
            v = kv[:, :, 1, j:j + 1].contiguous()
        else:
            k = PP.tp_matmul(h, self.wk, axes, "x", "y", plain=plain
                             ).reshape(R, T, self.nkv_l, hd)
            v = PP.tp_matmul(h, self.wv, axes, "x", "y", plain=plain
                             ).reshape(R, T, self.nkv_l, hd)
        if cfg.qk_norm:                      # before RoPE, as in JAX
            q = _plain_rms(q, self.q_norm, axes, plain=plain)
            k = _plain_rms(k, self.k_norm, axes, plain=plain)
        if cfg.rotary_pct > 0:
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)

        if mode == "train" and axes.gseq > 1:
            # context parallelism: positions already carry the stripe
            out = seq_attn(q, k, v, axes, window=cfg.sliding_window,
                           plain=plain)
        elif mode == "train":
            out = ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window, plain=plain)
        elif mode == "paged":
            out = self._paged(q, k, v, positions, cache, paged, plain)
        elif mode == "prefill":
            out = ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window, plain=plain)
            cache["k"][:, :T] = k.to(cache["k"].dtype)
            cache["v"][:, :T] = v.to(cache["v"].dtype)
        elif mode == "decode":
            out = self._decode(q, k, v, positions, cache, plain)
        elif mode == "decode_seqshard":
            out = self._decode_seqshard(q, k, v, positions, cache, plain)
        else:
            raise ValueError(f"attention mode {mode!r}")
        return PP.tp_matmul(out.reshape(R, T, self.nq_l * hd), self.wo,
                            axes, "y", "x", plain=plain)

    def _paged(self, q, k, v, positions, cache, paged, plain):
        T = q.shape[1]
        kp, vp = cache["k"], cache["v"]
        page = kp.shape[1]
        table, q_len = paged["table"], paged["q_len"]
        pos = positions.long()
        valid = (torch.arange(T, device=q.device)[None, :]
                 < q_len.long()[:, None])
        slot_pages = torch.clamp(pos // page, 0, table.shape[1] - 1)
        pid = torch.gather(table.long(), 1, slot_pages)
        # invalid rows (chunk padding, idle slots) all land on the reserved
        # null page 0 at offset 0: which of them wins does not matter, as
        # page 0 is never handed out and masked scores read nothing
        pid = torch.where(valid, pid, torch.zeros_like(pid))
        off = torch.where(valid, pos % page, torch.zeros_like(pos))
        kp.index_put_((pid, off), k.to(kp.dtype))
        vp.index_put_((pid, off), v.to(vp.dtype))
        return ops.flash_attention_paged(q, kp, vp, table, positions, q_len,
                                         window=self.cfg.sliding_window,
                                         plain=plain)

    def _decode(self, q, k, v, positions, cache, plain):
        kc, vc = cache["k"], cache["v"]
        pos = positions[:1, 0].long()     # uniform across the batch, as JAX
        kc.index_copy_(1, pos, k.to(kc.dtype))
        vc.index_copy_(1, pos, v.to(vc.dtype))
        kp, table = dense_page_view(kc)
        vp, _ = dense_page_view(vc)
        q_len = torch.ones((q.shape[0],), dtype=torch.int32, device=q.device)
        return ops.flash_attention_paged(
            q, kp, vp, table, positions.to(torch.int32).contiguous(), q_len,
            window=self.cfg.sliding_window, plain=plain)

    def _decode_seqshard(self, q, k, v, positions, cache, plain):
        """The reference's owner-only write: the token's K/V lands in the
        shard with 0 <= pos - shard S_local < S_local; every other shard
        writes its own row back (a clamped index, no host sync)."""
        kc, vc = cache["k"], cache["v"]
        S_local = kc.shape[1]
        local = positions[:1, 0].long() - M.axis_index(self.axes, "data") \
            * S_local
        owns = (local >= 0) & (local < S_local)
        safe = torch.clamp(local, 0, S_local - 1)
        for c, new in ((kc, k), (vc, v)):
            c.index_copy_(1, safe, torch.where(owns, new.to(c.dtype),
                                               c.index_select(1, safe)))
        return decode_core_seqsharded(q, kc, vc, positions[0, 0], self.axes,
                                      window=self.cfg.sliding_window,
                                      plain=plain)


def partial_chain(q, kg, vg, rank: int, p: int, *, window: int = 0,
                  carry=None, plain: bool = False):
    """Seq-rank ``rank``'s chain of K4 over the p blocks of the gathered
    keys kg/vg (B, p C, nkv, hd): block rho holds global keys rho + i p,
    the rank's queries q (B, C, nq, hd) sit at rank + j p. Starts from
    ``carry`` (default: fresh) and returns the final fp32 carry."""
    B, C, nq, hd = q.shape
    if carry is None:
        carry = FA.attn_partial_init(B, C, nq, hd, device=q.device)
    for rho in range(p):
        blk = slice(rho * C, (rho + 1) * C)
        carry = ops.flash_attention_partial(
            q, kg[:, blk], vg[:, blk], *carry, q_pos0=rank, q_stride=p,
            k_pos0=rho, k_stride=p, window=window, plain=plain)
    return carry


def partial_chain_bwd(q, kg, vg, dout, out, carry, rank: int, p: int, *,
                      window: int = 0, plain: bool = False):
    """K4's backward over :func:`partial_chain`, given the chain's output
    ``out`` (finalised), its final carry and the output's gradient: the
    first block's call closes the chain (lse = m + log l, delta = rowsum(dO
    O)); each block adds into one fp32 dQ in block order and writes its
    slice of the gathered keys' dK and dV. Returns (dq, dkg, dvg), fp32."""
    B, C, nq, hd = q.shape
    m, l, _ = carry
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    lse, delta = torch.empty((2, B, nq, C), **f32)
    dq = torch.zeros((B, C, nq, hd), **f32)
    dkg, dvg = torch.empty((2, B, p * C, kg.shape[2], hd), **f32)
    for rho in range(p):
        blk = slice(rho * C, (rho + 1) * C)
        ops.flash_attention_partial_bwd(
            q, kg[:, blk], vg[:, blk], dout, lse, delta, dq,
            close=(out, m, l) if rho == 0 else None, dk=dkg[:, blk],
            dv=dvg[:, blk], q_pos0=rank, q_stride=p, k_pos0=rho, k_stride=p,
            window=window, plain=plain)
    return dq, dkg, dvg


class _SeqAttention(torch.autograd.Function):
    """The blocking schedule of ``seq_attn`` over kernel K4, forward and
    backward. Forward: all-gather K and V over seq, run
    :func:`partial_chain` and finalise. Backward: :func:`partial_chain_bwd`
    gives dQ and the gathered blocks' dK and dV, which a psum_scatter over
    seq (the all-gather's transpose) returns to their owners."""

    @staticmethod
    def forward(ctx, q, k, v, axes, window, plain):
        kg = M.all_gather(k, axes, "seq", dim=1)
        vg = M.all_gather(v, axes, "seq", dim=1)
        rank = M.axis_index(axes, "seq")
        carry = partial_chain(q, kg, vg, rank, axes.gseq, window=window,
                              plain=plain)
        out = FA.attn_partial_finalize(carry, q.dtype)
        ctx.save_for_backward(q, kg, vg, out, *carry[:2])
        ctx.cfg = (axes, rank, window, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kg, vg, out, m, l = ctx.saved_tensors
        axes, rank, window, plain = ctx.cfg
        dq, dkg, dvg = partial_chain_bwd(q, kg, vg, dout, out, (m, l, None),
                                         rank, axes.gseq, window=window,
                                         plain=plain)
        dk = M.psum_scatter(dkg, axes, "seq", dim=1)
        dv = M.psum_scatter(dvg, axes, "seq", dim=1)
        return (dq.to(q.dtype), dk.to(kg.dtype), dv.to(vg.dtype), None,
                None, None)


class _SeqRingAttention(torch.autograd.Function):
    """The ring schedule of ``seq_attn`` (``overlap.ring_attention``) over
    kernel K4, forward and backward. Forward: p - 1 hops circulate K and V
    to the right; each hop is posted before K4 runs on the block in hand
    (after s hops, seq-rank (r - s) mod p's, keys at ``local + owner``),
    chaining the fp32 carry. The blocks in hand are kept for the backward,
    as the gathered K and V are in the blocking schedule. Backward: K4's
    backward per hop in reverse hop order (the first call closes the
    chain), dQ summed in one fp32 buffer; each hop's dK and dV go back one
    step along the reverse ring, added as ``dK4_s + recv``, so that each
    block's gradient ends with its owner.

    With tracing on, step s runs under ``ring_exchange[seq]/hop{s}`` as in
    the reference. Backward scopes: K4's backward of block s under
    ``ring_exchange[seq]/hop{s}``, and the hops that send block s's dK and
    dV back under ``ring_exchange[seq]/hop{s-1}``, the scope of the forward
    hop whose transpose they are."""

    @staticmethod
    def forward(ctx, q, k, v, axes, window, plain):
        B, C, nq, hd = q.shape
        p, r = axes.gseq, M.axis_index(axes, "seq")
        carry = FA.attn_partial_init(B, C, nq, hd, device=q.device)
        ks, vs = [], []
        cur_k, cur_v, host_k, host_v = k, v, None, None
        for s in range(p):
            with trace.scope("ring_exchange", "seq", f"hop{s}"):
                hops = ((M.Hop(cur_k, axes, "seq", host=host_k),
                         M.Hop(cur_v, axes, "seq", host=host_v))
                        if s < p - 1 else ())
                carry = ops.flash_attention_partial(
                    q, cur_k, cur_v, *carry, q_pos0=r, q_stride=p,
                    k_pos0=(r - s) % p, k_stride=p, window=window,
                    plain=plain)
                ks.append(cur_k)
                vs.append(cur_v)
                if hops:
                    cur_k, cur_v = (h.wait() for h in hops)
                    host_k, host_v = (h.recv for h in hops)
        out = FA.attn_partial_finalize(carry, q.dtype)
        ctx.save_for_backward(q, out, *carry[:2], *ks, *vs)
        ctx.cfg = (axes, r, window, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, out, m, l, *kv = ctx.saved_tensors
        axes, r, window, plain = ctx.cfg
        p = axes.gseq
        ks, vs = kv[:p], kv[p:]
        B, C, nq, hd = q.shape
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        f32 = dict(dtype=torch.float32, device=q.device)
        lse, delta = torch.empty((2, B, nq, C), **f32)
        dq = torch.zeros((B, C, nq, hd), **f32)
        hops = ()
        for s in reversed(range(p)):
            with trace.scope("ring_exchange", "seq", f"hop{s}"):
                dk, dv = ops.flash_attention_partial_bwd(
                    q, ks[s], vs[s], dout, lse, delta, dq,
                    close=(out, m, l) if s == p - 1 else None, q_pos0=r,
                    q_stride=p, k_pos0=(r - s) % p, k_stride=p,
                    window=window, plain=plain)
                if hops:
                    dk, dv = (d + h.wait() for d, h in zip((dk, dv), hops))
            if s > 0:
                # the transpose of forward hop s - 1, which brought block s
                with trace.scope("ring_exchange", "seq", f"hop{s - 1}"):
                    hops = (M.Hop(dk, axes, "seq", -1),
                            M.Hop(dv, axes, "seq", -1))
        return (dq.to(q.dtype), dk.to(ks[0].dtype), dv.to(vs[0].dtype),
                None, None, None)


def seq_attn(q, k, v, axes: M.MeshAxes, *, window: int = 0,
             plain: bool = False):
    """Context-parallel causal attention over the seq axis (port of
    ``repro.layers.attention.seq_attn``): q (B, C, nq, hd), k/v (B, C,
    nkv, hd) hold this rank's stripe (global positions r, r + p, ...;
    ``mesh.stripe_seq``). Two schedules, both kernel K4 forward and
    backward, equal to attention over the whole sequence up to fp32
    reassociation: the blocking one (:class:`_SeqAttention`, one
    all-gather of K and V; the JAX package runs one partial pass over the
    gathered non-monotone position vector, the port one K4 call per
    gathered block) and, under ``axes.overlap.ring_attention``, the ring
    (:class:`_SeqRingAttention`)."""
    if axes.overlap.ring_attention:
        return _SeqRingAttention.apply(q, k, v, axes, window, plain)
    return _SeqAttention.apply(q, k, v, axes, window, plain)


def decode_core_seqsharded(q, kc, vc, pos, axes: M.MeshAxes, *,
                           window: int = 0, plain: bool = False):
    """Port of ``repro.layers.attention.decode_core_seqsharded``: one
    query token per sequence, q (B, 1, nq, hd), against a cache kc/vc (B,
    S_local, nkv, hd) whose sequence dim is sharded over data (shard s
    holds global positions s S_local + j), at the global position ``pos``
    (an int or a 0-d tensor; keys past it are masked, and outside the
    window where one is set).

    Each shard runs K5 over its own keys, seen as pages of ``DENSE_PAGE``
    rows, at the local position pos - s S_local, which returns the
    shard's normalised output and its rows' log-sum-exp (a shard wholly
    past ``pos`` sees no key: output 0, lse NEG_INF). The shards merge as
    the flash-decoding combine: M = pmax(lse), w = exp(lse - M) (0 for a
    shard with no key), out = psum(out_s w) / psum(w), the two sums in
    one psum of their concatenation over data. This is the reference's
    sum of exp(scores - M) v over every key, regrouped by shard. In
    bfloat16 K5 rounds each shard's output before the merge, where the
    reference merges fp32 sums: one more bf16 rounding of the output."""
    B, _, nq, hd = q.shape
    S_local = kc.shape[1]
    kp, table = dense_page_view(kc)
    vp, _ = dense_page_view(vc)
    shard = M.axis_index(axes, "data")
    q_pos = (torch.as_tensor(pos, device=q.device).to(torch.int32)
             - shard * S_local).expand(B, 1).contiguous()
    q_len = torch.ones((B,), dtype=torch.int32, device=q.device)
    out, lse = ops.flash_attention_paged(q, kp, vp, table, q_pos, q_len,
                                         window=window, return_lse=True,
                                         plain=plain)
    m = M.pmax(lse, axes, "data")                        # (B, 1, nq)
    w = torch.exp(lse - m)[..., None]
    num_den = M.psum(torch.cat([out.float() * w, w], dim=-1), axes, "data")
    return (num_den[..., :hd] / num_den[..., hd:]).to(q.dtype)


def dense_page_view(cache):
    """A dense cache (B, S, nkv, hd), S a multiple of ``DENSE_PAGE``, seen
    as K5's page pool (B·S/DENSE_PAGE, DENSE_PAGE, nkv, hd) with no copy,
    and the (B, S/DENSE_PAGE) int32 table that gives row b its own pages in
    order."""
    B, S, nkv, hd = cache.shape
    n = S // DENSE_PAGE
    idx = torch.arange(n, dtype=torch.int32, device=cache.device)
    table = idx[None, :] + n * torch.arange(B, dtype=torch.int32,
                                            device=cache.device)[:, None]
    return cache.view(B * n, DENSE_PAGE, nkv, hd), table


# the layout of the dense and paged K/V caches (the JAX
# ``attn_cache_spec``): sequences or pages over the batch axes, KV heads
# over y; under ``seqshard`` the sequence's positions over data
CACHE_SPEC = (M.MeshAxes.batch_axes(), None, "y", None)
SEQ_CACHE_SPEC = (None, "data", "y", None)


def attn_cache_spec(cfg, axes: M.MeshAxes, batch: int, seq: int, *,
                    dtype=torch.float32, seqshard: bool = False):
    """(shape, dtype) of this rank's dense K and V caches for a global
    ``batch``: (batch / (g_data g_z), S, local kv heads, head_dim), S =
    ``seq`` rounded up to a multiple of ``DENSE_PAGE``; KV heads shard
    over y (one duplicated head a y rank where G_y > n_kv_heads). With
    ``seqshard`` every rank holds all ``batch`` rows and S / g_data
    positions, S rounded up to a multiple of g_data ``DENSE_PAGE`` (the
    reference's shards are S / g_data; they agree where the rounding
    changes nothing)."""
    _, nkv_l, _ = kv_layout(cfg, axes)
    unit = DENSE_PAGE * (axes.dp if seqshard else 1)
    S = -(-seq // unit) * unit
    shape = M.local_shape((batch, S, nkv_l * axes.gy, cfg.head_dim_), axes,
                          SEQ_CACHE_SPEC if seqshard else CACHE_SPEC)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def paged_attn_cache_spec(cfg, axes: M.MeshAxes, n_pages: int,
                          page_size: int, *, dtype=torch.float32):
    """(shape, dtype) of this rank's K and V page pools of a global pool
    of ``n_pages``: (n_pages / (g_data g_z), page_size, local kv heads,
    head_dim). Each batch shard's page 0 is its reserved null page, and
    its page tables hold its local page ids."""
    _, nkv_l, _ = kv_layout(cfg, axes)
    shape = M.local_shape((n_pages, page_size, nkv_l * axes.gy,
                           cfg.head_dim_), axes, CACHE_SPEC)
    return {"k": (shape, dtype), "v": (shape, dtype)}
