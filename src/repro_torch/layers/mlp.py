"""Feed-forward layers: gated and ungated, of SiLU, GELU or squared ReLU
(port of ``repro.layers.mlp``).

The up and gate projections are paper "normal" layers and the down
projection a "transposed" one (§4.1). ``wi``, ``wg`` and ``wo`` stay
separate weights, as in the JAX package; each rank holds its block by
``partition.wspec``: ``wi`` and ``wg`` (d/x, d_ff/(y z)), ``wo`` (d_ff/y,
d/(x z)). An ungated MLP has no ``wg``: act(h wi) wo.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP


def _act(name: str, x):
    """The reference's ``_act``. Its GELU is ``jax.nn.gelu``'s default,
    the tanh approximation."""
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "squared_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, axes: M.MeshAxes, *,
                 gen: torch.Generator, act: str = "silu", gated: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.axes, self.act, self.gated = axes, act, gated
        self.wi = nn.Parameter(PP.tp_linear_init(gen, d_model, d_ff, axes,
                                                 dtype=dtype))
        self.wo = nn.Parameter(PP.tp_linear_init(gen, d_ff, d_model, axes,
                                                 "y", "x", dtype=dtype))
        if gated:
            self.wg = nn.Parameter(PP.tp_linear_init(gen, d_model, d_ff,
                                                     axes, dtype=dtype))

    def forward(self, h, *, plain: bool = False):
        u = PP.tp_matmul(h, self.wi, self.axes, "x", "y", plain=plain)
        if self.gated:
            g = PP.tp_matmul(h, self.wg, self.axes, "x", "y", plain=plain)
            hidden = _act(self.act, g) * u
        else:
            hidden = _act(self.act, u)
        return PP.tp_matmul(hidden, self.wo, self.axes, "y", "x",
                            plain=plain)
