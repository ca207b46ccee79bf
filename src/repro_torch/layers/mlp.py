"""Gated SiLU feed-forward layer (port of ``repro.layers.mlp``).

The up and gate projections are paper "normal" layers and the down
projection a "transposed" one (§4.1). ``wi``, ``wg`` and ``wo`` stay
separate weights, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, axes: M.MeshAxes, *,
                 gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.axes = axes
        self.wi = nn.Parameter(PP.tp_linear_init(gen, d_model, d_ff, axes,
                                                 dtype=dtype),
                               requires_grad=False)
        self.wo = nn.Parameter(PP.tp_linear_init(gen, d_ff, d_model, axes,
                                                 dtype=dtype),
                               requires_grad=False)
        self.wg = nn.Parameter(PP.tp_linear_init(gen, d_model, d_ff, axes,
                                                 dtype=dtype),
                               requires_grad=False)

    def forward(self, h):
        u = PP.tp_matmul(h, self.wi, self.axes, "x", "y")
        g = PP.tp_matmul(h, self.wg, self.axes, "x", "y")
        return PP.tp_matmul(F.silu(g) * u, self.wo, self.axes, "y", "x")
