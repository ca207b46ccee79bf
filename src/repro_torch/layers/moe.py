"""Mixture-of-Experts under the 4D layout (port of ``repro.layers.moe``).

The residual stream is replicated over y, so sharding the expert bank over
y makes dispatch free within the tensor group: every y rank holds every
token and computes its own E/G_y experts; the one collective the layer adds
over a dense MLP is the combine's all-reduce over y (and the router's over
x). Dispatch is the reference's capacity-based gather and scatter, with
O(T E_local) bookkeeping and no (T, E, C) one-hot tensor: each (token,
slot) takes the next place in its expert's queue (a cumulative sum), and a
place past the capacity drops to an extra slot that is cut off.

Expert axis (g_expert > 1): the batch shards over it as a second data
axis, and each y rank's expert block is split over it, global expert e on
y rank e // (E/G_y) and expert rank (e % (E/G_y)) // e_local (y-major,
expert-inner). Tokens reach the experts of their y block on other expert
ranks through a (g_expert, e_local, capacity, d) dispatch buffer exchanged
by an all-to-all over the expert axis, and come back by the reverse
exchange (``collective_matmul.a2a_expert``): the blocking
``mesh.all_to_all``, or with ``OverlapConfig.expert_a2a`` pairwise
shifts (``collective_matmul.ring_a2a_expert``).

Every expert product runs on K1's batched entry (``parallel.
tp_batched_matmul``): one launch for the rank's e_local experts. The
gather of tokens into slots and the combine's sum back to tokens are
written with a fixed order: a token's slots are summed in slot order
(``parallel.segment_sum``), forward and backward, so two runs give the
same bits; an ``index_add_`` would sum them in the order of CUDA's atomics.

Two gradients the reference leaves partial where G_y > 1 are summed over y
here (``parallel.bwd_psum``): the tokens' input to the dispatch (each y
rank back-propagates only its own experts) and the gates (each y rank
sees only its own experts' slots). The router's logits and the aux loss
are replicated over y, so with both sums every y rank's router gradient is
the whole one.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import collective_matmul as CMM
from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.layers.mlp import MLP, _act


def topk_gates(logits, mc):
    """Router scores -> (gates, indices) (the reference's ``_topk_gates``):
    logits (T, E) fp32, replicated. softmax over the top-k logits, or
    (DeepSeek-V3) the top-k sigmoid scores normalised and scaled."""
    if mc.score_fn == "sigmoid":
        vals, idx = torch.topk(torch.sigmoid(logits), mc.top_k, dim=-1)
        gates = vals / (torch.sum(vals, -1, keepdim=True) + 1e-20)
        return gates * mc.routed_scale, idx
    vals, idx = torch.topk(logits, mc.top_k, dim=-1)
    return torch.softmax(vals, dim=-1), idx


def aux_losses(logits, idx, mc):
    """Switch-style load-balance loss plus the router z-loss (the
    reference's ``_aux_losses``), replicated values."""
    T, E = logits.shape
    me = torch.mean(torch.softmax(logits, dim=-1), dim=0)
    onehot = F.one_hot(idx, E).float()                   # (T, k, E)
    ce = torch.mean(torch.sum(onehot, dim=1), dim=0) / mc.top_k
    lb = E * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return mc.aux_loss_coef * lb + mc.z_loss_coef * z


def capacity_of(mc, n_tok: int) -> int:
    """Slots an expert holds for ``n_tok`` tokens: the reference's
    ``max(int(capacity_factor * n_tok * top_k / E), 4)``."""
    return max(int(mc.capacity_factor * n_tok * mc.top_k / mc.n_experts), 4)


@torch.no_grad()
def dispatch_indices(idx, y_start: int, e_block: int, capacity: int):
    """The reference's capacity dispatch for this y rank's expert block
    [y_start, y_start + e_block), from the routed experts idx (n_tok, k):
    ``slot`` (n_tok k,) each (token, slot)'s place (expert * capacity +
    its position in the expert's queue, by token order; ``e_block *
    capacity``, the drop slot, where the expert is off this block or its
    queue is full), ``owner`` (e_block capacity,) the token of each place
    (0 where empty), ``filled`` whether a token holds it, and ``dropped``,
    the (token, slot) pairs of this block that found no place."""
    n_tok, k = idx.shape
    local = idx.long() - y_start
    ok = (local >= 0) & (local < e_block)
    eflat = torch.where(ok, local, torch.full_like(local, e_block)
                        ).reshape(-1)
    onehot = F.one_hot(eflat, e_block + 1).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, eflat[:, None])[:, 0].long()
    fits = (pos < capacity) & ok.reshape(-1)
    drop = e_block * capacity
    slot = torch.where(fits, eflat * capacity + pos,
                       torch.full_like(pos, drop))
    tok = torch.arange(n_tok, device=idx.device).repeat_interleave(k)
    owner = torch.zeros(drop + 1, dtype=torch.long, device=idx.device)
    owner[slot] = tok
    filled = torch.zeros(drop + 1, dtype=torch.bool, device=idx.device)
    filled[slot] = True
    dropped = torch.sum(ok.reshape(-1) & ~fits)
    return slot, owner[:-1], filled[:-1], dropped


def slot_gates(gates, slot, n_slots: int):
    """(n_slots,) fp32: each place's gate (0 where empty), the gates (n_tok,
    k) scattered to their (token, slot)'s place (the reference's
    ``gate_of_slot``); differentiable in ``gates``."""
    return torch.zeros(n_slots + 1, dtype=torch.float32,
                       device=gates.device).index_put(
        (slot,), gates.reshape(-1).float())[:-1]


class _TakeRows(torch.autograd.Function):
    """rows[idx[s]] where keep[s], else 0; the backward sums each row's
    gradients in slot order (``segment_sum``), so it repeats bitwise."""

    @staticmethod
    def forward(ctx, rows, idx, keep):
        ctx.save_for_backward(idx, keep)
        ctx.n = rows.shape[0]
        out = rows[idx]
        return torch.where(keep[:, None], out, torch.zeros_like(out))

    @staticmethod
    def backward(ctx, dy):
        idx, keep = ctx.saved_tensors
        sel = keep.nonzero()[:, 0]
        return PP.segment_sum(idx[sel], dy[sel], ctx.n), None, None


class _SumRows(torch.autograd.Function):
    """(n, d) whose row t sums vals[s] over the kept s with idx[s] == t, in
    slot order (the reference's ``.at[owner].add``); the backward gathers."""

    @staticmethod
    def forward(ctx, vals, idx, keep, n: int):
        ctx.save_for_backward(idx, keep)
        sel = keep.nonzero()[:, 0]
        return PP.segment_sum(idx[sel], vals[sel], n)

    @staticmethod
    def backward(ctx, dy):
        idx, keep = ctx.saved_tensors
        out = dy[idx]
        return (torch.where(keep[:, None], out, torch.zeros_like(out)), None,
                None, None)


class MoE(nn.Module):
    """``moe_init``/``moe_apply``: the router ``w_router`` (d/x, E) fp32,
    the expert bank ``w_up`` (E/(y ex), d/x, up/z) and ``w_down`` (E/(y
    ex), f, d/(x z)), up = 2 f gated (the gate then the up projection
    along its last dim) or f, and ``n_shared`` shared experts as one MLP
    ``shared`` of width n_shared f. The draws follow the reference's order
    of leaves."""

    def __init__(self, cfg, axes: M.MeshAxes, *, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        mc = cfg.moe
        d, f = cfg.d_model, mc.d_expert
        if mc.n_experts % (axes.gy * axes.gexpert):
            raise ValueError(f"{mc.n_experts} experts not divisible by "
                             f"G_y*G_expert={axes.gy * axes.gexpert}")
        self.cfg, self.axes = cfg, axes
        self.gated = cfg.act != "squared_relu"
        up = 2 * f if self.gated else f
        self.w_router = nn.Parameter(PP.tp_linear_init(
            gen, d, mc.n_experts, axes, "x", None, dtype=torch.float32))
        self.w_up = nn.Parameter(PP.tp_expert_init(
            gen, mc.n_experts, d, up, axes, in_shard="x", out_shard=None,
            dtype=dtype))
        self.w_down = nn.Parameter(PP.tp_expert_init(
            gen, mc.n_experts, f, d, axes, in_shard=None, out_shard="x",
            dtype=dtype))
        if mc.n_shared:
            self.shared = MLP(d, mc.n_shared * f, axes, gen=gen, act=cfg.act,
                              gated=self.gated, dtype=dtype)
        # (token, slot) pairs dropped for want of capacity, summed over the
        # forwards since reset_dropped (a rematerialized block's recompute
        # is not counted again)
        self.dropped = None

    def _ffn(self, block, plain: bool):
        """(e_local, C, d/x) -> (e_local, C, d/x) through this rank's
        experts; the gates stay with the source rank."""
        axes = self.axes
        u = PP.tp_batched_matmul(block, self.w_up, axes, "x", None,
                                 plain=plain)
        if self.gated:
            g, u2 = u.chunk(2, dim=-1)
            hidden = _act(self.cfg.act, g) * u2
        else:
            hidden = _act(self.cfg.act, u)
        return PP.tp_batched_matmul(hidden, self.w_down, axes, None, "x",
                                    plain=plain)

    def forward(self, h, *, plain: bool = False):
        """h (B, T, d/x), replicated over y, the batch sharded over (data,
        z, expert) -> (out (B, T, d/x), aux loss)."""
        cfg, axes, mc = self.cfg, self.axes, self.cfg.moe
        B, T, dx = h.shape
        n_tok = B * T
        p_ex = axes.gexpert
        e_block = mc.n_experts // axes.gy
        e_local = e_block // p_ex

        hf = h.reshape(n_tok, dx)
        logits = PP.tp_matmul(hf, self.w_router.to(hf.dtype), axes, "x",
                              None, plain=plain).float()
        gates, idx = topk_gates(logits, mc)
        aux = aux_losses(logits, idx, mc)
        capacity = capacity_of(mc, n_tok)
        slot, owner, filled, dropped = dispatch_indices(
            idx, M.axis_index(axes, "y") * e_block, e_block, capacity)
        if torch._C._current_graph_task_id() == -1:     # not a recompute
            self.dropped = (dropped if self.dropped is None
                            else self.dropped + dropped)
        n_slots = e_block * capacity
        gate_of_slot = slot_gates(PP.bwd_psum(gates, axes, "y"), slot,
                                  n_slots)
        xe = _TakeRows.apply(PP.bwd_psum(hf, axes, "y"), owner, filled)

        if p_ex > 1:
            # the dispatch buffer's dim 0 is the destination expert rank
            # (the queue index eflat = rank * e_local + local expert)
            buf = xe.reshape(p_ex, e_local, capacity, dx)
            out_b = CMM.a2a_expert(buf, axes, "expert",
                                   lambda b: self._ffn(b, plain),
                                   ring=axes.overlap.expert_a2a)
            out_e = out_b.reshape(n_slots, dx)
        else:
            out_e = self._ffn(xe.reshape(e_block, capacity, dx), plain
                              ).reshape(n_slots, dx)
        out_e = out_e * gate_of_slot[:, None].to(out_e.dtype)

        # combine: each token's slots summed in slot order, then the y
        # ranks' expert blocks summed
        combined = _SumRows.apply(out_e, owner, filled, n_tok)
        out = PP.ar_bwd_identity(combined, axes, "y").reshape(B, T, dx)
        if mc.n_shared:
            out = out + self.shared(h, plain=plain)
        return out, aux


def reset_dropped(model: nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, MoE):
            m.dropped = None


def dropped(model: nn.Module) -> int:
    """(token, slot) pairs the MoE layers of ``model`` dropped since
    :func:`reset_dropped`, on this rank."""
    return int(sum(int(m.dropped) for m in model.modules()
                   if isinstance(m, MoE) and m.dropped is not None))
