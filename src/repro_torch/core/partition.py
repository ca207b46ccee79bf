"""Parameter layouts: each parameter's PartitionSpec, and gradient
reductions by layout (port of ``repro.core.partition``).

The JAX package boxes each parameter with its PartitionSpec
(``Boxed.spec``). The port keeps the same specs in one table,
:data:`LEAF_SPECS`, keyed by the parameter's leaf name (the last part of
its name, ``layers.3.mixer.wq`` -> ``wq``): one entry per dim, each None
(replicated), an axis name or a tuple of names (first-name-major). Every
init draws the global tensor and keeps its rank's block by this table
(``mesh.shard``), and ``convert`` slices the JAX leaves by it.

The JAX package also tags each parameter with whether its gradient leaves
its ``custom_vjp`` already reduced over z: the tensor-parallel weights and
the embedding (2-D, reduce-scattered over z by their backward) are; the
norm gains (1-D, replicated, each z rank seeing its own batch shard) are
not. The port reads the same split off the parameter's rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import mesh as M

Spec = Tuple[M.Axis, ...]


def _dim(names: Tuple[str, ...]) -> M.Axis:
    """A PartitionSpec entry: None, one name, or a tuple of names."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def wspec(in_shard: Optional[str], out_shard: Optional[str]) -> Spec:
    """The spec of a tensor-parallel weight W (k, n) (``parallel.wspec``):
    k over the contraction shard, n over (output shard, z)."""
    out = ((out_shard,) if out_shard else ()) + ("z",)
    return (in_shard, _dim(out))


NORMAL = wspec("x", "y")          # paper "normal" layer: (x, (y, z))
TRANSPOSED = wspec("y", "x")      # paper "transposed" layer: (y, (x, z))

LEAF_SPECS: Dict[str, Spec] = {
    "embed": ("y", ("x", "z")),     # vocab over y, features over (x, z)
    "lm_head": NORMAL,              # the untied head, d -> V
    "g": ("x",),                    # norm gains: the residual layout
    # attention: separate q/k/v, or the duplicated-KV layout's one kv
    # projection (replicated over y, its grads psum'd over y)
    "wq": NORMAL, "wk": NORMAL, "wv": NORMAL, "wo": TRANSPOSED,
    "wkv_dup": wspec("x", None),
    "q_norm": (None,), "k_norm": (None,),
    # the gated MLP (its "wo" is the transposed down projection too)
    "wi": NORMAL, "wg": NORMAL,
    # Mamba: projections, then per-inner-channel params over y
    "w_in": NORMAL, "w_gate": NORMAL, "w_x": wspec("y", None),
    "w_dt": wspec(None, "y"), "w_out": TRANSPOSED,
    "conv_w": ("y", None), "conv_b": ("y",), "b_dt": ("y",),
    "A_log": ("y", None), "D": ("y",),
}


def param_spec(name: str) -> Spec:
    """The PartitionSpec of the port parameter ``name``."""
    return LEAF_SPECS[name.rsplit(".", 1)[-1]]


def keep_shard(v: torch.Tensor, axes: M.MeshAxes, spec: Spec,
               rank: Optional[int] = None) -> torch.Tensor:
    """A contiguous copy of ``rank``'s block of the global ``v`` (default:
    this process's), so that the caller's global tensor can be freed."""
    if axes.world == 1:
        return v
    return M.shard(v, axes, spec, rank).clone(
        memory_format=torch.contiguous_format)


def z_reduce_grads(grads: Dict[str, torch.Tensor],
                   axes: M.MeshAxes) -> Dict[str, torch.Tensor]:
    """psum over z the gradient of every parameter whose backward did not
    reduce it there already."""
    return {n: g if g.dim() >= 2 else M.psum(g, axes, "z")
            for n, g in grads.items()}
