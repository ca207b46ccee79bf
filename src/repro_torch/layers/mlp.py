"""Gated SiLU feed-forward layer (port of ``repro.layers.mlp``).

The up and gate projections are paper "normal" layers and the down
projection a "transposed" one (§4.1). ``wi``, ``wg`` and ``wo`` stay
separate weights, as in the JAX package; each rank holds its block by
``partition.wspec``: ``wi`` and ``wg`` (d/x, d_ff/(y z)), ``wo`` (d_ff/y,
d/(x z)).
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
                                                 dtype=dtype))
        self.wo = nn.Parameter(PP.tp_linear_init(gen, d_ff, d_model, axes,
                                                 "y", "x", dtype=dtype))
        self.wg = nn.Parameter(PP.tp_linear_init(gen, d_model, d_ff, axes,
                                                 dtype=dtype))

    def forward(self, h, *, plain: bool = False):
        u = PP.tp_matmul(h, self.wi, self.axes, "x", "y", plain=plain)
        g = PP.tp_matmul(h, self.wg, self.axes, "x", "y", plain=plain)
        return PP.tp_matmul(F.silu(g) * u, self.wo, self.axes, "y", "x",
                            plain=plain)
