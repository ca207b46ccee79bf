"""AdamW with fp32 master weights (port of ``repro.optim.adamw``).

Parameters live in the model's dtype; the first and second moments and an
fp32 master copy are kept per parameter, as in the JAX package (its
``init_state`` copies even float32 parameters). On a mesh each rank holds
its block of every parameter and of its state. Gradients arrive at
:func:`apply_updates` already reduced over data (and over z and y where
their layout asks) by the train step. The update is the JAX package's, element by element; it
runs in place on the state and the parameters (the JAX step returns new
trees; updating in place saves a copy of the state and the parameters).

:func:`apply_updates_sharded` is the ZeRO-1 variant on top of
:mod:`repro_torch.core.gradsync`: gradients arrive as data-axis-scattered
fp32 bucket shards, each rank updates only its ``1/G_data`` slice of the
fp32 state, and the updated parameters are rebuilt by an all-gather over
data (ZeRO-1), or under ZeRO-3 written straight into the parameter
shards. The per-element math is :func:`apply_updates`'s, op for op.
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, Optional

import numpy as np
import torch

from repro_torch.core import gradsync as GS
from repro_torch.core import mesh as M
from repro_torch.core.partition import Spec, spec_names


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_ratio * lr, in float32 as
    the JAX package computes it."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
    return float(f32(cfg.lr) * warm * (f32(cfg.min_lr_ratio)
                                       + f32(1 - cfg.min_lr_ratio) * cos))


def init_state(params: Dict[str, torch.Tensor]):
    """m / v / fp32 master per parameter, keyed like ``params``."""
    def one(p):
        f32 = p.detach().to(torch.float32, copy=True)
        return {"m": torch.zeros_like(f32), "v": torch.zeros_like(f32),
                "master": f32}
    return {"opt": {n: one(p) for n, p in params.items()}, "step": 0}


def _no_decay(path: str) -> bool:
    """The JAX package's rule, on a JAX tree path ("a/b/c"). Every layer
    leaf of a stacked decoder lives under ``segments/seg0/pos0/...``, so
    the tag "pos" exempts all of them: in the reference only the
    embedding (and nothing else of a dense decoder) decays."""
    for tag in ("norm", "gn", "bias", "b_if", "b_gates", "b_dt", "bqkv",
                "bo", "bi", "bq", "skip", "conv_b", "A_log", "D", "pos"):
        if tag in path:
            return True
    return False


def global_grad_norm(grads: Dict[str, torch.Tensor],
                     specs: Optional[Dict[str, Spec]] = None,
                     axes: M.MeshAxes = M.MeshAxes()) -> torch.Tensor:
    """L2 norm of the *global* gradient, in fp32: each leaf's local sum of
    squares is psum'd over exactly the mesh axes its spec (``specs[name]``;
    None: every leaf whole) shards it over, as in the reference. The
    leaves that share a set of axes share one psum, in the order of
    ``grads``: a handful of collectives a step, not one a leaf."""
    groups: Dict[tuple, list] = {}
    for n, g in grads.items():
        names = spec_names(specs[n]) if specs is not None else ()
        groups.setdefault(names, []).append(torch.sum(torch.square(g.float())))
    total = 0.0
    for names, sums in groups.items():
        total = total + torch.sum(M.psum(torch.stack(sums), axes, names))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state,
                  cfg: AdamWConfig, *, no_decay: Collection[str] = (),
                  specs: Optional[Dict[str, Spec]] = None,
                  axes: M.MeshAxes = M.MeshAxes()):
    """One AdamW step on this rank's blocks. ``params`` and ``grads`` are
    keyed alike; names in ``no_decay`` take no weight decay; ``specs``
    (name -> PartitionSpec) and ``axes`` say how the gradient norm sums the
    blocks (:func:`global_grad_norm`). Updates ``params`` and ``state`` in
    place; returns the metrics {"grad_norm", "lr"}."""
    step = state["step"]
    lr = lr_at(cfg, step)
    gnorm = global_grad_norm(grads, specs, axes)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if cfg.grad_clip else 1.0)
    t = np.float32(step + 1)
    bc1 = float(1 - np.float32(cfg.b1) ** t)
    bc2 = float(1 - np.float32(cfg.b2) ** t)
    for name, p in params.items():
        st = state["opt"][name]
        gf = grads[name].float() * scale
        m = st["m"].mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v = st["v"].mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and name not in no_decay:
            upd += cfg.weight_decay * st["master"]
        st["master"].sub_(lr * upd)
        p.copy_(st["master"])
    state["step"] = step + 1
    return {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates_sharded(shards, state, plan, axes: M.MeshAxes,
                          cfg: AdamWConfig, *,
                          params: Dict[str, torch.Tensor],
                          ring: bool = True, rebuild: bool = True):
    """One ZeRO-1/3 AdamW step on data-axis-scattered gradient shards.

    ``shards`` are the per-bucket fp32 gradients (already reduced over
    data/z/y, scaled by 1/microbatches); ``state`` holds m/v/master only
    for this rank's shard of each bucket (``gradsync.init_sharded_state``)
    and is updated in place. Element-wise math is identical to
    :func:`apply_updates`; weight decay uses the plan's per-element
    group-id masks in place of the per-leaf path check (so it keeps the
    reference's exemption of every stacked layer leaf, ROADMAP.md §3).
    With ``rebuild`` the model's parameters ``params`` (name -> tensor)
    are rebuilt from the updated master shards by an all-gather over data
    (``gradsync.rebuild_params``, ZeRO-1); without it (ZeRO-3) ``params``
    are the parameter shards (name -> this rank's shard), and the updated
    masters, cast to each leaf's dtype, are written into them in place
    (``gradsync.shards_to_tree``): no collective. Returns the metrics
    {"grad_norm", "lr"}."""
    step = state["step"]
    lr = lr_at(cfg, step)
    gnorm = GS.sharded_grad_norm(shards, plan, axes)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if cfg.grad_clip else 1.0)
    t = np.float32(step + 1)
    bc1 = float(1 - np.float32(cfg.b1) ** t)
    bc2 = float(1 - np.float32(cfg.b2) ** t)
    for b, g, st in zip(plan.buckets, shards, state["buckets"]):
        gf = g.float() * scale
        m = st["m"].mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v = st["v"].mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            mask = GS.decay_mask(b, GS.gid_shard(plan, b, axes,
                                                 device=g.device))
            upd += cfg.weight_decay * st["master"] * mask
        st["master"].sub_(lr * upd)
    masters = [st["master"] for st in state["buckets"]]
    if rebuild:
        GS.rebuild_params(masters, plan, axes, params, ring=ring)
    else:
        GS.shards_to_tree(masters, plan, params)
    state["step"] = step + 1
    return {"grad_norm": gnorm, "lr": lr}
