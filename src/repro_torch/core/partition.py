"""Gradient reductions by parameter layout (port of
``repro.core.partition.z_reduce_grads``).

The JAX package tags each parameter with whether its gradient leaves its
``custom_vjp`` already reduced over z: the tensor-parallel weights and the
embedding (2-D, reduce-scattered over z by their backward) are; the norm
gains (1-D, replicated, each z rank seeing its own batch shard) are not.
The port reads the same split off the parameter's rank.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import mesh as M


def z_reduce_grads(grads: Dict[str, torch.Tensor],
                   axes: M.MeshAxes) -> Dict[str, torch.Tensor]:
    """psum over z the gradient of every parameter whose backward did not
    reduce it there already."""
    return {n: g if g.dim() >= 2 else M.psum(g, axes, "z")
            for n, g in grads.items()}
