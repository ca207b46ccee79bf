"""Mamba (S6) mixer (port of ``repro.layers.mamba``, used by Jamba).

The in/out projections are paper normal/transposed tp layers, each a K1
product through ``parallel.tp_matmul``; the selective scan is per channel
and runs as kernel K6, for the whole prompt in prefill and as one step from
the carried state in decode. The depthwise causal convolution stays in
PyTorch ops, as the JAX package computes it outside any kernel. Training
runs the prefill branch from a zero state with autograd recording: the
scan through ``kernels.selective_scan.SelectiveScan`` (K6's forward, then
its backward kernel), the convolution, SiLU, softplus, the D term and the
gate through autograd.

On a mesh the inner channels shard over y: each rank holds d_inner / g_y
of them, with their slices of ``w_in``, ``w_gate`` (outputs), ``w_x`` and
``w_out`` (inputs) and ``w_dt`` (outputs) and of the per-channel
parameters; the convolution and the scan run on the rank's channels
alone. ``w_x``'s product sums over y, so every y rank sees the whole dt,
B and C. In the backward each rank's scan gives B's and C's gradients
summed over its own channels only: they are summed over y
(``parallel.bwd_psum``) before ``w_x``'s backward, once. The low-rank
dt's gradient needs no sum: ``w_dt``'s backward sums it over y already.
The reference passes the partial sums on (ROADMAP.md §3).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core import partition as PT
from repro_torch.kernels import ops


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B, T, d); w: (d, K)."""
    K = w.shape[-1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, k:k + x.shape[1], :] * w[:, k] for k in range(K))
    return out + b


class Mamba(nn.Module):
    """``mamba_init`` / ``mamba_apply``: the x-path and gate projections
    ``w_in`` and ``w_gate`` (d -> d_inner), ``w_x`` (d_inner -> dt_rank +
    2N: the low-rank dt, B and C), ``w_dt`` (dt_rank -> d_inner) and
    ``w_out`` (d_inner -> d); the conv weights; and ``b_dt``, ``A_log`` and
    ``D``, which stay float32 whatever the model's dtype."""

    def __init__(self, cfg, axes: M.MeshAxes, *, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.axes = cfg, axes
        mc = cfg.mamba
        d, di, N, dtr = cfg.d_model, mc.expand * cfg.d_model, mc.d_state, \
            cfg.dt_rank
        dev = gen.device

        def lin(k, n, in_shard="x", out_shard="y"):
            return nn.Parameter(PP.tp_linear_init(
                gen, k, n, axes, in_shard, out_shard, dtype=dtype))
        self.w_in, self.w_gate = lin(d, di), lin(d, di)
        self.w_x, self.w_dt, self.w_out = lin(di, dtr + 2 * N, "y", None), \
            lin(dtr, di, None, "y"), lin(di, d, "y", "x")

        def per_channel(name, full):
            """This rank's y block of the whole tensor ``full``."""
            return nn.Parameter(PT.keep_shard(full, axes,
                                              PT.LEAF_SPECS[name].spec))
        f32 = torch.float32
        self.conv_w = per_channel("conv_w", (torch.randn(
            (di, mc.d_conv), generator=gen, device=dev) * 0.1).to(dtype))
        self.conv_b = per_channel("conv_b", torch.zeros(di, dtype=dtype,
                                                        device=dev))
        self.b_dt = per_channel("b_dt", torch.full(
            (di,), -4.6, dtype=f32, device=dev))  # softplus^-1(.01)
        self.A_log = per_channel("A_log", torch.log(torch.arange(
            1, N + 1, dtype=f32, device=dev)).expand(di, N).contiguous())
        self.D = per_channel("D", torch.ones(di, dtype=f32, device=dev))

    def _dt_bc(self, xc, plain):
        """w_x, then w_dt on the low-rank part: (dt fp32, B, C), B and C as
        column views of w_x's output (their gradient summed over y)."""
        N, dtr = self.cfg.mamba.d_state, self.cfg.dt_rank
        xdbc = PP.tp_matmul(xc, self.w_x, self.axes, "y", None, plain=plain)
        dt_low, bcc = torch.split(xdbc, [dtr, 2 * N], dim=-1)
        if self.axes.gy > 1:
            bcc = PP.bwd_psum(bcc, self.axes, "y")
        bc, cc = torch.split(bcc, [N, N], dim=-1)
        dt = F.softplus(PP.tp_matmul(dt_low, self.w_dt, self.axes, None, "y",
                                     plain=plain) + self.b_dt.float())
        return dt, bc, cc

    def forward(self, h, *, mode: str, state=None, plain: bool = False):
        """h (B, T, d/x) -> the mixer's output (B, T, d/x).

        ``mode="train"``: the scan over the T rows from a zero state,
        differentiable (K6's backward kernel); no state. ``mode="prefill"``:
        the same scan;
        ``state`` (this layer's cache {"conv": (B, K-1, di), "ssm": (B, di,
        N) fp32}) is filled in place with the last K-1 inputs of the
        convolution and the final scan state. ``mode="decode"``: one row
        (T = 1) steps both from ``state`` and updates them in place (the
        JAX step returns new states; in place saves a copy per layer and
        step)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(mode)
        axes = self.axes
        K = self.cfg.mamba.d_conv
        xs = PP.tp_matmul(h, self.w_in, axes, "x", "y", plain=plain)
        zgate = PP.tp_matmul(h, self.w_gate, axes, "x", "y", plain=plain)
        A = -torch.exp(self.A_log.float())
        if mode in ("train", "prefill"):
            xc = F.silu(causal_conv1d(xs, self.conv_w, self.conv_b))
            dt, bc, cc = self._dt_bc(xc, plain)
            y, s_fin = ops.selective_scan(xc, dt, A, bc, cc, plain=plain)
            if mode == "prefill" and state is not None:
                # the last K-1 inputs of the conv; a prompt shorter than
                # that keeps zeros in front, as the conv's padding has
                tail = F.pad(xs, (0, 0, K - 1, 0))[:, -(K - 1):]
                state["conv"].copy_(tail)
                state["ssm"].copy_(s_fin)
        else:
            conv_st = torch.cat([state["conv"], xs], dim=1)   # (B, K, di)
            # the JAX einsum "bkd,dk->bd", as a product and a sum over the
            # K taps (a batched GEMM would leave channels strided for K6)
            xc = (conv_st * self.conv_w.t()).sum(dim=1) + self.conv_b
            xc = F.silu(xc)[:, None, :]                       # (B, 1, di)
            dt, bc, cc = self._dt_bc(xc, plain)
            y, s = ops.selective_scan(xc, dt, A, bc, cc, s0=state["ssm"],
                                      plain=plain)
            state["conv"].copy_(conv_st[:, 1:])
            state["ssm"].copy_(s)
        y = y.float() + self.D.float() * xc.float()
        y = (y * F.silu(zgate.float())).to(h.dtype)
        return PP.tp_matmul(y, self.w_out, axes, "y", "x", plain=plain)


# the layout of the decode state (the JAX ``mamba_state_spec``): sequences
# over the batch axes, inner channels over y; under ``seqshard`` (one
# sequence) replicated over the batch axes
STATE_SPECS = {"conv": (M.MeshAxes.batch_axes(), None, "y"),
               "ssm": (M.MeshAxes.batch_axes(), "y", None)}
SEQ_STATE_SPECS = {"conv": (None, None, "y"), "ssm": (None, "y", None)}


def mamba_state_spec(cfg, axes: M.MeshAxes, batch: int, *,
                     dtype=torch.float32, seqshard: bool = False):
    """(shape, dtype) of this rank's decode state for a global ``batch``:
    the conv's last K-1 inputs (B, K-1, d_inner / g_y) in the model's
    dtype and the scan state (B, d_inner / g_y, N) in fp32, B = batch /
    (g_data g_z), or ``batch`` under ``seqshard``."""
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    shapes = {"conv": (batch, mc.d_conv - 1, di),
              "ssm": (batch, di, mc.d_state)}
    dtypes = {"conv": dtype, "ssm": torch.float32}
    specs = SEQ_STATE_SPECS if seqshard else STATE_SPECS
    return {k: (M.local_shape(v, axes, specs[k]), dtypes[k])
            for k, v in shapes.items()}

