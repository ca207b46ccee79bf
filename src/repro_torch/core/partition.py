"""Parameter layouts: each parameter's PartitionSpec, and gradient
reductions by layout (port of ``repro.core.partition``).

The JAX package boxes each parameter with its PartitionSpec and two flags
(``Boxed``/``ParamSpec``): ``z_reduced``, the gradient leaves its
``custom_vjp`` already reduce-scattered over z (the tensor-parallel
weights and the embedding), and ``y_reduce``, the gradient needs a psum
over y (the duplicated-KV projection: each y rank back-props only the head
it keeps). The port keeps the same specs and flags in one table,
:data:`LEAF_SPECS`, keyed by the parameter's leaf name (the last part of
its name, ``layers.3.mixer.wq`` -> ``wq``): the spec has one entry per dim,
each None (replicated), an axis name or a tuple of names
(first-name-major). Every init draws the global tensor and keeps its
rank's block by this table (``mesh.shard``), and ``convert`` slices the
JAX leaves by it.

One flag departs from the reference: ``y_heads``, the gradient holds only
this y rank's heads and is summed over y. It is set on the qk-norm gains,
which the reference marks with neither flag: there each y rank applies
its own update to gains the y ranks share (ROADMAP.md §3).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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


class ParamSpec(NamedTuple):
    """A parameter's PartitionSpec and how its gradient is reduced."""
    spec: Spec
    z_reduced: bool = False   # the backward reduce-scattered it over z
    y_reduce: bool = False    # psum over y (the reference's flag)
    y_heads: bool = False     # psum over y (the port's departure)


def _tp(spec: Spec, **flags) -> ParamSpec:
    """A weight of ``tp_matmul`` or the embedding: its backward
    reduce-scatters the gradient over z."""
    return ParamSpec(spec, z_reduced=True, **flags)


LEAF_SPECS: Dict[str, ParamSpec] = {
    "embed": _tp(("y", ("x", "z"))),   # vocab over y, features over (x, z)
    "lm_head": _tp(NORMAL),            # the untied head, d -> V
    "g": ParamSpec(("x",)),            # norm gains: the residual layout
    "b": ParamSpec(("x",)),            # LayerNorm biases: the same
    # attention: separate q/k/v, or the duplicated-KV layout's one kv
    # projection (replicated over y, its grads psum'd over y)
    "wq": _tp(NORMAL), "wk": _tp(NORMAL), "wv": _tp(NORMAL),
    "wo": _tp(TRANSPOSED),
    "wkv_dup": _tp(wspec("x", None), y_reduce=True),
    # qk-norm gains act on this y rank's heads only; the reference
    # (attention.attn_init) reduces them over data and z alone
    "q_norm": ParamSpec((None,), y_heads=True),
    "k_norm": ParamSpec((None,), y_heads=True),
    # the MLP (its "wo" is the transposed down projection too; "wg" only
    # where it is gated)
    "wi": _tp(NORMAL), "wg": _tp(NORMAL),
    # Mamba: projections, then per-inner-channel params over y
    "w_in": _tp(NORMAL), "w_gate": _tp(NORMAL), "w_x": _tp(wspec("y", None)),
    "w_dt": _tp(wspec(None, "y")), "w_out": _tp(TRANSPOSED),
    "conv_w": ParamSpec(("y", None)), "conv_b": ParamSpec(("y",)),
    "b_dt": ParamSpec(("y",)), "A_log": ParamSpec(("y", None)),
    "D": ParamSpec(("y",)),
    # MoE: the router contracts x, its logits replicated; the expert bank
    # (E, k, n), E over (y, expert) y-major (``parallel.tp_expert_init``),
    # k over the contraction shard, n over (output shard, z); a shared
    # expert is an MLP (wi, wg, wo above)
    "w_router": _tp(wspec("x", None)),
    "w_up": _tp((("y", "expert"), "x", "z")),
    "w_down": _tp((("y", "expert"), None, ("x", "z"))),
    # MLA: q and the latent kv down projection contract x; the latent's
    # up projections shard their heads over y; kv_norm is the latent's
    # replicated gain. The compressed query (DeepSeek-V3): w_dq contracts
    # x into the replicated q latent, w_uq shards its heads over y, and
    # the latent's gain is ``cq_norm`` (the reference's leaf ``q_norm``,
    # ``convert.jax_path`` renames it): replicated, and whole on every y
    # rank, since w_uq's backward psums the latent's gradient over y
    "w_q": _tp(NORMAL), "w_dkv": _tp(wspec("x", None)),
    "kv_norm": ParamSpec((None,)),
    "w_uk": _tp(wspec(None, "y")), "w_uv": _tp(wspec(None, "y")),
    "w_dq": _tp(wspec("x", None)), "cq_norm": ParamSpec((None,)),
    "w_uq": _tp(wspec(None, "y")),
    # DeepSeek-V3's multi-token prediction: h and the next token's
    # embedding each through a normal layer, summed, then a transposed one
    # (its norms are "g", its block's leaves those above)
    "w_comb_h": _tp(NORMAL), "w_comb_e": _tp(NORMAL),
    "w_comb_o": _tp(TRANSPOSED),
}

# the port's leaf names that the reference's tree spells otherwise
JAX_LEAF_NAMES = {"cq_norm": "q_norm"}


def leaf_spec(name: str) -> ParamSpec:
    """The :class:`ParamSpec` of the port parameter ``name``."""
    return LEAF_SPECS[name.rsplit(".", 1)[-1]]


def param_spec(name: str) -> Spec:
    """The PartitionSpec of the port parameter ``name``."""
    return leaf_spec(name).spec


def spec_names(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` shards over, in mesh order."""
    names = {n for entry in spec if entry is not None
             for n in ((entry,) if isinstance(entry, str) else entry)}
    return tuple(a for a in M.AXES if a in names)


def keep_shard(v: torch.Tensor, axes: M.MeshAxes, spec: Spec,
               rank: Optional[int] = None) -> torch.Tensor:
    """A contiguous copy of ``rank``'s block of the global ``v`` (default:
    this process's), so that the caller's global tensor can be freed."""
    if axes.world == 1:
        return v
    return M.shard(v, axes, spec, rank).clone(
        memory_format=torch.contiguous_format)


def expert_reduce_grads(grads: Dict[str, torch.Tensor],
                        axes: M.MeshAxes) -> Dict[str, torch.Tensor]:
    """psum over the expert axis the gradient of every parameter not
    sharded over it (the reference's ``expert_reduce_grads``): for the
    dense layers the expert axis is a second data axis (each expert rank
    sees its own batch shard); the expert bank is sharded over it, and
    each rank's gradient holds exactly its own experts' contributions,
    so summing those would be wrong, not only wasteful."""
    return {n: g if "expert" in spec_names(param_spec(n))
            else M.psum(g, axes, "expert") for n, g in grads.items()}


def z_reduce_grads(grads: Dict[str, torch.Tensor],
                   axes: M.MeshAxes) -> Dict[str, torch.Tensor]:
    """psum over y the gradient of every parameter flagged ``y_reduce`` or
    ``y_heads``, then over z that of every parameter whose backward did
    not reduce it there already (``z_reduced``), as the reference's
    ``z_reduce_grads`` does by its flags."""
    out = {}
    for n, g in grads.items():
        s = leaf_spec(n)
        if s.y_reduce or s.y_heads:
            g = M.psum(g, axes, "y")
        out[n] = g if s.z_reduced else M.psum(g, axes, "z")
    return out
