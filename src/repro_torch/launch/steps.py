"""Model init, the train step and the serving steps (port of
``repro.launch.steps``).

PyTorch runs eagerly, so where the JAX package builds a jitted,
shard_map'ped step, ``make_train_step``, ``make_paged_step``,
``make_prefill_step`` and ``make_decode_step`` only bind the configuration
and return the step. Each binds its overlapped schedule
(``core/overlap.py``) with ``axes.with_overlap``, as the JAX steps do, and
the step runs the model under it (``decoder.overlap_bound``). A serving
step takes the global batch, as the JAX step does, and runs this rank's
rows of it: the rows of batch shard ``axis_index((data, z))``,
first-name-major (``mesh.batch_shard``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Optional

import torch

from repro_torch import convert
from repro_torch.core import gradsync as GS
from repro_torch.core import mesh as M
from repro_torch.core.overdecompose import split_batch
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import (expert_reduce_grads, param_spec,
                                        z_reduce_grads)
from repro_torch.models import decoder as D
from repro_torch.models.base import ArchConfig
from repro_torch.optim import adamw as OPT


def resolve_device(device="cuda") -> torch.device:
    """The device the entry points run on: the card unless the caller asks
    for the CPU. Raises when a CUDA device is asked for and there is none.
    Float32 stays float32 on the card: TF32 is switched off for matrix
    products and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch sees no CUDA device; "
            f"pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def init_model(cfg: ArchConfig, axes: Optional[M.MeshAxes] = None,
               seed: int = 0, *, device="cuda", dtype=torch.float32,
               zero3: bool = False) -> D.Decoder:
    """Random weights from ``seed``, drawn on ``device`` from the JAX
    package's distributions (N(0, 1/k) projections, N(0, 0.02^2)
    embedding, unit norms). The values differ from ``jax.random``'s. On a
    mesh each rank keeps its block of every parameter by its
    PartitionSpec: the slices of the one-card model of the same seed.
    ``zero3``: each part is sharded over data as soon as it is drawn
    (``Decoder(shard=...)``, ``gradsync.shard_tensor``), so the whole
    local model is never on the device; the shards are bitwise those of
    sharding the model drawn whole."""
    dev = resolve_device(device)
    axes = axes or M.MeshAxes()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return D.Decoder(cfg, axes, gen=gen, dtype=dtype, shard=(
        (lambda t: GS.shard_tensor(t, axes)) if zero3 else None))


def shard_model(model: D.Decoder) -> D.Decoder:
    """``model`` moved to the ZeRO-3 layout in place: every parameter
    replaced by this rank's shard over data (``model.shards``)."""
    return model.shard_(lambda t: GS.shard_tensor(t, model.axes))


# ---------------------------------------------------------------------- #
# train step
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TrainOptions:
    overdecompose: int = 2      # paper §4.2 (2 batch-shards); 1 = off
    remat: bool = True
    remat_policy: str = "full"  # "full" or "dots" (decoder.Decoder.hidden)
    xent_chunks: int = 1
    dtype: torch.dtype = torch.bfloat16
    mtp_weight: float = 0.0     # DeepSeek MTP loss weight (0 = off)
    # ring-decomposed collective matmuls, the seq ring and weight-gather
    # caching (core/overlap.py; rides down to the layers on the axes)
    overlap: OverlapConfig = OverlapConfig()
    # data-parallel gradient sync (core/gradsync.py): the default is the
    # blocking per-leaf psum
    gradsync: GS.GradSyncConfig = GS.GradSyncConfig()


def _loss_fn(cfg: ArchConfig, axes: M.MeshAxes, opts: TrainOptions):
    def f(model, batch, plain: bool = False, pstream=None):
        return D.lm_loss(model, batch["tokens"], batch["labels"],
                         image_embeds=batch.get("image_embeds"),
                         remat=opts.remat, xent_chunks=opts.xent_chunks,
                         remat_policy=opts.remat_policy,
                         mtp_weight=opts.mtp_weight, pstream=pstream,
                         plain=plain)
    return f


def stripe_batch(batch, axes: M.MeshAxes):
    """Stripe a global train batch for context parallelism: tokens and
    labels are permuted along seq so that seq-rank r's contiguous shard
    holds global positions r, r + g_seq, ... (``mesh.stripe_seq``). The
    identity when seq is 1; the LM loss is a per-token mean, so the
    permutation leaves it unchanged."""
    return {k: M.stripe_seq(v, axes.gseq, dim=1)
            if k in ("tokens", "labels") else v for k, v in batch.items()}


def no_decay_names(model: D.Decoder):
    """Names of the parameters that take no weight decay: the JAX rule
    (``adamw._no_decay``) applied to each parameter's JAX path."""
    return {n for n, path in convert.jax_paths(model).items()
            if OPT._no_decay(path)}


def sync_grads(grads, axes: M.MeshAxes):
    """The train step's reductions of this rank's gradients (name ->
    tensor): the data-parallel all-reduce (paper §3.1) and over seq, in
    place, one leaf at a time in the same order on every rank (parameters
    are replicated over seq, and each seq-rank's gradients hold only its
    own tokens' contributions); then over the expert axis for every
    parameter not sharded over it (``partition.expert_reduce_grads``: for
    the dense layers it is a second data axis), over z for parameters
    whose backward has not reduced them there, and over y for those whose
    y ranks hold parts of them (``partition.z_reduce_grads``). Every rank
    holding the same block gets the same bits."""
    if axes.size(("data", "seq")) > 1:
        for g in grads.values():
            g.copy_(M.psum(g, axes, ("data", "seq")))
    if axes.gexpert > 1:
        grads = expert_reduce_grads(grads, axes)
    return z_reduce_grads(grads, axes)


def train_plan(params: Dict[str, torch.Tensor], cfg: ArchConfig,
               axes: M.MeshAxes, gs: GS.GradSyncConfig) -> GS.BucketPlan:
    """The bucket plan of the train step of ``gs`` for the model whose
    parameters (this rank's blocks, or under ZeRO-3 the module tree's
    meta tensors) are ``params``: the reference's ``make_plan`` of the
    same model and mesh, under ``zero3`` its ``make_leaf_plan``."""
    leaves = GS.model_leaves(params, cfg)
    if gs.zero3:
        return GS.make_leaf_plan(leaves, axes, no_decay=OPT._no_decay)
    return GS.make_plan(leaves, axes, gs.bucket_bytes,
                        no_decay=OPT._no_decay)


def _shard_rows(acc, shards, plan: GS.BucketPlan):
    """(shard, its row of its bucket's accumulator) for every shard."""
    for buf, b in zip(acc, plan.buckets):
        for k, n in enumerate(plan.leaves[b.segments[0].leaf].names):
            yield shards[n], (buf[k] if b.stack > 1 else buf)


def shard_grad_buffers(shards, plan: GS.BucketPlan, fp32: bool):
    """ZeRO-3's zeroed per-bucket gradient accumulators ((stack,
    padded/dp) or (padded/dp,)), in fp32 when ``fp32`` (more than one
    microbatch: each is cast before the sum, so two microbatches never add
    in bf16), else in the leaves' dtype (one microbatch, as the
    reference). Where a shard's dtype is its accumulator's, its ``.grad``
    is bound to its row, and autograd adds each microbatch's gradient
    into it in place (no copy)."""
    acc = [torch.zeros((b.stack, b.padded // plan.dp) if b.stack > 1
                       else (b.padded // plan.dp,),
                       dtype=torch.float32 if fp32 else b.dtype,
                       device=shards[plan.leaves[b.segments[0].leaf]
                                     .names[0]].device)
           for b in plan.buckets]
    for p, row in _shard_rows(acc, shards, plan):
        p.grad = row if p.dtype == row.dtype else None
    return acc


def add_shard_grads(acc, shards, plan: GS.BucketPlan) -> None:
    """After a microbatch's backward: each shard's ``.grad``, this rank's
    block of the data sum (the gathers' backward), is in its accumulator
    row: already there when bound to it, else cast, added and cleared."""
    for p, row in _shard_rows(acc, shards, plan):
        if p.dtype == row.dtype:
            if p.grad is None or p.grad.data_ptr() != row.data_ptr():
                raise RuntimeError("a shard's gradient left its "
                                   "accumulator row")
        elif p.grad is not None:
            row.add_(p.grad.to(row.dtype))
            p.grad = None


def make_train_step(cfg: ArchConfig, axes: M.MeshAxes,
                    opt_cfg: OPT.AdamWConfig,
                    opts: TrainOptions = TrainOptions(), *,
                    tools: Optional["GradSyncTools"] = None):
    """The JAX ``make_train_step``: ``step(model, opt_state, batch,
    plain=False) -> metrics``. ``batch`` is the global batch, striped by
    :func:`stripe_batch` on a seq axis; each rank takes its rows (batch
    shard ``axis_index((data, z))``) and then its contiguous shard of the
    sequence, as the JAX step's ``shard_map`` in_specs do. It splits them
    into ``opts.overdecompose`` microbatches and runs their forward and
    backward. The model's parameters (this rank's blocks) and
    ``opt_state`` are updated in place; every rank holding the same block
    ends with the same bits. ``opts.overlap`` picks the overlapped
    schedule's rings; ``OverlapConfig()`` is the blocking schedule.

    ``opts.gradsync`` picks the data-parallel sync:

    * ``GradSyncConfig()``, the blocking schedule: the gradients
      accumulate in fp32 and are divided by the microbatch count, psum'd
      over data and seq, reduced over z and y by each parameter's layout
      (``partition.z_reduce_grads``); AdamW (``adamw.apply_updates`` on
      ``adamw.init_state``'s state), whose gradient norm psums each block
      over its spec's axes. In float32 the parameters' ``.grad`` is the
      accumulator; in bfloat16 with more than one microbatch a separate
      fp32 one is, as the JAX step casts each microbatch's gradients to
      fp32 before summing. With one microbatch the gradients keep their
      dtype and are reduced in it, as the JAX step's are.
    * ``bucketed`` or ``zero`` (``core/gradsync.py``): with ``stream``
      each microbatch's gradients are reduce-scattered over data into fp32
      bucket shards right after its backward and ``p.grad`` is freed;
      without it they accumulate as above and one reduce-scatter runs.
      The shards are psum'd over seq, then reduced over y and z as whole
      buckets. ``zero``: ``adamw.apply_updates_sharded`` on
      ``gradsync.init_sharded_state``'s state (:func:`make_gradsync_tools`),
      which rebuilds the parameters by an all-gather over data;
      ``bucketed`` alone all-gathers the gradients, then ``apply_updates``.
      The bucket plan is ``tools.plan`` when ``tools`` is given (the one
      the state was made with; the step checks the state's shard sizes
      against it), else :func:`train_plan` of the model the first call
      gets, kept for later calls.
    * ``zero3``: the model holds its parameters as shards over data
      (``init_model(zero3=True)`` or :func:`shard_model`; ``model.shards``,
      updated in place), and ``opt_state`` is ``tools.init(model.shards)``.
      Each microbatch's forward gathers the working copies as a
      ``gradsync.ParamStreamer`` says (``prefetch``: one layer ahead, kept
      for the backward), and the gathers' backward reduce-scatters each
      gradient over data, so a shard's ``.grad`` is this rank's block of
      the data sum. Those are added into fp32 accumulators after each
      microbatch (in the leaf's dtype at one microbatch, as the reference
      does), divided by the microbatch count, psum'd over seq and reduced
      over y and z (``tensor_reduce_shards``); then
      ``adamw.apply_updates_sharded(rebuild=False)`` writes the new
      shards. The plan is the reference's ``make_leaf_plan``."""
    axes = axes.with_overlap(opts.overlap)
    gs = opts.gradsync
    if axes.gexpert > 1 and gs.enabled:
        raise NotImplementedError(
            "expert parallelism with sharded grad sync (--zero/--zero3/"
            "stream) is not wired yet: the bucket shards lose the "
            "per-param specs the expert-axis reduction needs")
    loss_fn = _loss_fn(cfg, axes, opts)
    plans = [tools.plan] if tools is not None else []

    def plan_of(params, opt_state):
        if not plans:
            plans.append(train_plan(params, cfg, axes, gs))
        plan = plans[0]
        if gs.state_sharded and [st["master"].numel()
                                 for st in opt_state["buckets"]] != [
                b.padded // plan.dp * b.stack for b in plan.buckets]:
            raise ValueError("the optimizer state's shards are not the "
                             "step's bucket plan's: make the state and the "
                             "step from one GradSyncTools")
        return plan

    def step(model, opt_state, batch, plain: bool = False):
        with D.overlap_bound(model, axes.overlap):
            return _step(model, opt_state, batch, plain)

    def _step(model, opt_state, batch, plain):
        params = dict(model.named_parameters())
        dtypes = {p.dtype for p in params.values()}
        if dtypes != {opts.dtype}:
            raise TypeError(f"TrainOptions.dtype is {opts.dtype}, the model's "
                            f"parameters are {sorted(map(str, dtypes))}")
        if gs.zero3 != (model.shards is not None):
            raise ValueError(
                "a zero3 step takes a model in the ZeRO-3 layout "
                "(init_model(zero3=True) or steps.shard_model), and only a "
                "zero3 step does" if gs.zero3 else
                "a model in the ZeRO-3 layout needs GradSyncConfig(zero3="
                "True)")
        plan = plan_of(params, opt_state) if gs.enabled else None
        pstream = (GS.ParamStreamer(plan, axes, ring=gs.ring,
                                    prefetch=gs.prefetch)
                   if gs.zero3 else None)
        trained = model.shards if gs.zero3 else params
        stream = gs.enabled and not gs.zero3 and gs.stream
        n = opts.overdecompose
        mbs = split_batch({k: M.seq_shard(M.batch_shard(v, axes), axes)
                           for k, v in batch.items()}, n, axes=axes)
        acc = None
        if (n > 1 and opts.dtype != torch.float32 and not stream
                and not gs.zero3):
            acc = {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()}
        for p in trained.values():
            p.grad = None
        loss = metrics = shards = None
        if gs.zero3:
            shards = shard_grad_buffers(model.shards, plan, n > 1)
        for i in range(n):
            li, mi = loss_fn(model, {k: v[i] for k, v in mbs.items()},
                             plain=plain, pstream=pstream)
            li.backward()
            if gs.zero3:
                add_shard_grads(shards, model.shards, plan)
            elif stream and n > 1:
                # this microbatch's buckets leave now, in fp32 shards
                si = GS.reduce_scatter_grads(
                    {k: p.grad for k, p in params.items()}, plan, axes,
                    ring=gs.ring)
                for p in params.values():
                    p.grad = None
                shards = si if shards is None else [
                    a.add_(b) for a, b in zip(shards, si)]
            elif acc is not None:
                for k, p in params.items():
                    acc[k] += p.grad.float()
                    p.grad = None
            li, mi = li.detach(), {k: v.detach() for k, v in mi.items()}
            loss = li if loss is None else loss + li
            metrics = mi if metrics is None else {
                k: metrics[k] + mi[k] for k in metrics}
        grads = None
        if shards is None:
            grads = {k: (p.grad if acc is None else acc[k])
                     for k, p in params.items()}
        if n > 1:
            loss = loss / n
            metrics = {k: v / n for k, v in metrics.items()}
            if shards is not None:
                shards = [s.div_(n) for s in shards]
            else:
                grads = {k: g.div_(n) for k, g in grads.items()}
        if not gs.enabled:
            grads = sync_grads(grads, axes)
            om = OPT.apply_updates(params, grads, opt_state, opt_cfg,
                                   no_decay=no_decay_names(model),
                                   specs={k: param_spec(k) for k in params},
                                   axes=axes)
        else:
            if shards is None:
                shards = GS.reduce_scatter_grads(grads, plan, axes,
                                                 ring=gs.ring)
            del grads
            for p in trained.values():
                p.grad = None
            if axes.gseq > 1:
                # parameters are replicated over seq; each seq-rank's
                # shards hold only its own tokens' contributions
                shards = [M.psum(s, axes, "seq") for s in shards]
            # ZeRO-3's one microbatch kept the leaf's dtype to here
            shards = GS.tensor_reduce_shards([s.float() for s in shards],
                                             plan, axes)
            if gs.zero3:
                om = OPT.apply_updates_sharded(shards, opt_state, plan, axes,
                                               opt_cfg, params=model.shards,
                                               ring=gs.ring, rebuild=False)
            elif gs.zero:
                om = OPT.apply_updates_sharded(shards, opt_state, plan, axes,
                                               opt_cfg, params=params,
                                               ring=gs.ring)
            else:
                grads = GS.all_gather_grads(shards, plan, axes, ring=gs.ring)
                om = OPT.apply_updates(
                    params, grads, opt_state, opt_cfg,
                    no_decay=no_decay_names(model),
                    specs={k: param_spec(k) for k in params}, axes=axes)
        for p in trained.values():
            p.grad = None
        return dict(metrics, loss=loss, **om)

    return step


# ---------------------------------------------------------------------- #
# optimizer state: replicated AdamW or ZeRO-1 data-sharded
# ---------------------------------------------------------------------- #

def state_layouts(cfg: ArchConfig, axes: M.MeshAxes, params,
                  opts: TrainOptions = TrainOptions()) -> dict:
    """This rank's persistent training state, in bytes, for the train step
    of ``opts`` and the model whose parameters are ``params`` (under
    ZeRO-3 the module tree's meta tensors): its parameter blocks, under
    ``gradsync.zero3`` their 1/g_data shards, and its optimizer state
    (fp32 m/v/master: each block whole, or under ``zero``/``zero3`` its
    1/g_data shard of every bucket), padding included, as the reference's
    ``state_layouts`` sizes them."""
    params = dict(params)
    p_bytes = sum(p.numel() * p.element_size() for p in params.values())
    if opts.gradsync.state_sharded:
        plan = train_plan(params, cfg, axes, opts.gradsync)
        s_elems = plan.shard_elements
        if opts.gradsync.zero3:
            p_bytes = sum(b.padded // plan.dp * b.stack
                          * torch.finfo(b.dtype).bits // 8
                          for b in plan.buckets)
    else:
        s_elems = sum(p.numel() for p in params.values())
    return {"params": p_bytes, "opt_state": 3 * 4 * s_elems}


@dataclasses.dataclass(frozen=True)
class GradSyncTools:
    """Companions of a ZeRO-sharded train step, on this rank's tensors.

    ``init(params)`` builds the scattered fp32 state from the full
    (replicated-over-data) parameters (name -> this rank's block), under
    ZeRO-3 from the parameter shards (``model.shards``; the same bits);
    ``gather(state)`` / ``scatter(full_state)`` convert to/from the
    replicated per-parameter layout of ``adamw.init_state`` (the
    checkpoint format — ckpt.py save_sharded/restore_sharded); ``plan`` is
    the bucket layout the step was built with. Under ZeRO-3
    ``shard_params(full)`` / ``unshard_params(shards)`` convert parameters
    (name -> tensor) to/from their shards (checkpoints stay replicated, so
    g_data may change across a resume). ``gather`` and ``unshard_params``
    run collectives over data: every rank calls them."""

    plan: GS.BucketPlan
    init: Callable
    gather: Callable
    scatter: Callable
    shard_params: Optional[Callable] = None
    unshard_params: Optional[Callable] = None


def make_gradsync_tools(cfg: ArchConfig, axes: M.MeshAxes, params,
                        opts: TrainOptions = TrainOptions()
                        ) -> GradSyncTools:
    """Build the ZeRO state helpers for the same (cfg, axes, opts) a train
    step was made with and the model whose parameters are ``params`` (the
    bucket plan must match)."""
    axes = axes.with_overlap(opts.overlap)
    plan = train_plan(dict(params), cfg, axes, opts.gradsync)
    tools = GradSyncTools(
        plan=plan,
        init=lambda p: GS.init_sharded_state(dict(p), plan, axes),
        gather=lambda s: GS.gather_sharded_state(s, plan, axes),
        scatter=lambda s: GS.scatter_full_state(s, plan, axes))
    if not opts.gradsync.zero3:
        return tools
    return dataclasses.replace(
        tools, init=lambda s: GS.init_state_from_shards(dict(s), plan),
        shard_params=lambda p: GS.shard_params(dict(p), axes),
        unshard_params=lambda s: GS.unshard_params(dict(s), plan, axes))


# ---------------------------------------------------------------------- #
# snapshot / restore (the replicated layout == the checkpoint layout)
# ---------------------------------------------------------------------- #

def snapshot_state(model, opt_state, tools: Optional[GradSyncTools],
                   opts: TrainOptions, *, step: int = 0,
                   keep: bool = True) -> dict:
    """Host snapshot of the run state in the reference's REPLICATED
    per-leaf layout: global, layer-stacked numpy trees keyed by JAX paths
    (``convert.params_to_jax`` / ``opt_state_to_jax``; the optimizer state
    gathered through ``tools.gather`` first when it is sharded). This is
    the tree ``ckpt.save`` persists; the plan fingerprint rides along so
    :func:`restore_state` can reject a rebuild whose tensor partitioning
    (not just g_data) changed. Every rank takes part in the gathers; with
    ``keep`` False this rank keeps nothing (its trees are None). A
    sharded state is gathered and converted one bucket at a time
    (``gradsync.iter_full_state``), and ZeRO-3's parameters one at a time
    through ``tools.unshard_params``, so no rank holds the whole
    replicated state on its device at once."""
    gs = opts.gradsync
    fp, blocks, full_s = None, None, opt_state
    if gs.state_sharded:
        assert tools is not None, "sharded state needs GradSyncTools"
        full_s = {"opt": GS.iter_full_state(opt_state, tools.plan,
                                            model.axes),
                  "step": opt_state["step"]}
        fp = GS.plan_fingerprint(tools.plan)
    if gs.zero3:
        blocks = ((n, tools.unshard_params({n: s})[n])
                  for n, s in model.shards.items())
    return {"params": convert.params_to_jax(model, keep=keep, blocks=blocks),
            "opt_state": convert.opt_state_to_jax(full_s, model, keep=keep),
            "step": int(step), "fingerprint": fp}


def restore_state(snapshot: dict, cfg: ArchConfig, axes: M.MeshAxes,
                  tools: Optional[GradSyncTools], opts: TrainOptions,
                  model):
    """Re-shard a :func:`snapshot_state` snapshot (or a checkpoint read
    into that form) onto this rank of ``axes``: the model's parameters
    take their blocks of the snapshot's in place; returns the optimizer
    state in the layout the train step of ``opts`` expects on that mesh,
    scattered through the new mesh's own ``tools.scatter`` when it is
    sharded (built on the host, then moved to the model's device), so
    restoring from the in-memory snapshot and from a checkpoint of the
    same step give the same bits. Under ZeRO-3 each parameter's block is
    sharded on the host (``tools.shard_params``) and copied into
    ``model.shards``."""
    gs = opts.gradsync
    if gs.state_sharded:
        assert tools is not None, "sharded state needs GradSyncTools"
        want = snapshot.get("fingerprint")
        if want is not None:
            have = GS.plan_fingerprint(tools.plan)
            if have != want:
                raise ValueError(
                    f"elastic restore: bucket-plan fingerprint {have} != "
                    f"snapshot's {want} — the rebuild changed the tensor "
                    f"partitioning, not just the data axis; the snapshot "
                    f"cannot be re-sharded onto this mesh")
    if gs.zero3:
        with torch.no_grad():
            for n, block in convert.param_blocks_from_jax(
                    model, snapshot["params"]):
                model.shards[n].copy_(tools.shard_params({n: block})[n])
    else:
        convert.load_params_from_jax(model, snapshot["params"])
    if not gs.state_sharded:
        return convert.opt_state_from_jax(snapshot["opt_state"], model)
    state = tools.scatter(convert.opt_state_from_jax(
        snapshot["opt_state"], model, device="cpu"))
    state["buckets"] = [{k: t.to(model.device) for k, t in b.items()}
                        for b in state["buckets"]]
    return state


@torch.no_grad()
def param_sha256(model) -> str:
    """SHA-256 of every parameter's bytes, in order: equal on two ranks
    only if their parameters are bitwise equal. Under ZeRO-3 each is
    gathered from its shards onto the host first (``mesh.GatherAsync``, a
    collective over data: every rank calls it), so the digest is the
    unsharded model's."""
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if model.shards is not None:
            p = M.GatherAsync(model.shards[n], model.axes, "data").wait(
                device=False)[:p.numel()]
        # a piece at a time: ranks sharing a host do not each copy a
        # whole leaf there at once
        for piece in p.detach().reshape(-1).split(1 << 24):
            h.update(piece.cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def gather_logits(logits, axes: M.MeshAxes, *, seqshard: bool = False):
    """This rank's logits (R_local, ..., V/y) as the global (R, ..., V):
    gathered over y (vocab) and over the batch axes (rows), as the JAX
    step's ``out_specs`` assemble them. Every rank gets the same bits.
    ``seqshard``: the rows are replicated over the batch axes (the
    seq-sharded decode step's), so only y is gathered."""
    logits = M.all_gather(logits, axes, "y", dim=-1)
    if seqshard:
        return logits
    return M.all_gather(logits, axes, axes.batch_axes(), dim=0)


def make_paged_step(cfg: ArchConfig, axes: M.MeshAxes, *,
                    dtype=torch.float32,
                    overlap: OverlapConfig = OverlapConfig()):
    """``build(n_pages, page_size)`` returns ``(step, cache_specs)``:
    step(model, tokens, pools, positions, q_len, table) -> (logits, pools),
    the continuous-batching step over the paged KV cache, and the (shape,
    dtype) of this rank's pools (``n_pages`` is the global pool, each batch
    shard owning ``n_pages / (g_data g_z)`` of them). The step takes the
    global rows (R, ...), the table holding each shard's local page ids,
    and runs this rank's batch shard of them: logits (R / (g_data g_z), 1,
    V/y). The engine runs the same step at two row widths: T = chunk while
    prefill work is pending, T = 1 for pure decode. ``overlap``: the
    overlapped schedule of the step's tp matmuls."""
    axes = axes.with_overlap(overlap)

    def step(model, tokens, pools, positions, q_len, table, *,
             plain: bool = False):
        tokens, positions, q_len, table = (
            M.batch_shard(t, axes) for t in (tokens, positions, q_len,
                                               table))
        with D.overlap_bound(model, axes.overlap):
            return D.paged_step(model, tokens, pools, positions, q_len,
                                table, plain=plain)

    def build(n_pages: int, page_size: int):
        return step, D.decoder_paged_cache_specs(
            cfg, axes, n_pages, page_size, dtype=dtype)
    return build


def make_prefill_step(cfg: ArchConfig, axes: M.MeshAxes, *,
                      dtype=torch.float32,
                      overlap: OverlapConfig = OverlapConfig()):
    """``build(batch, seq, cache_seq)`` returns ``(step, cache_specs)``:
    step(model, caches, tokens) -> (last-row logits, caches), the prefill
    of the global ``batch`` prompts (batch, seq) of ``seq`` tokens into
    fixed-batch caches of ``cache_seq`` positions, and the (shape, dtype)
    of this rank's caches (:func:`decoder.decoder_cache_specs`). The step
    runs this rank's batch shard: logits (batch / (g_data g_z), 1, V/y).
    ``overlap``: the overlapped schedule of the step's tp matmuls."""
    axes = axes.with_overlap(overlap)

    def build(batch: int, seq: int, cache_seq: int):
        if seq > cache_seq:
            raise ValueError(f"prompt of {seq} tokens exceeds the cache's "
                             f"{cache_seq} positions")

        def step(model, caches, tokens, plain: bool = False):
            with D.overlap_bound(model, axes.overlap):
                return D.prefill(model, M.batch_shard(tokens, axes), caches,
                                 plain=plain)
        return step, D.decoder_cache_specs(cfg, axes, batch, cache_seq,
                                           dtype=dtype)
    return build


def make_decode_step(cfg: ArchConfig, axes: M.MeshAxes, *,
                     seqshard: bool = False, dtype=torch.float32,
                     overlap: OverlapConfig = OverlapConfig()):
    """``build(batch, seq)`` returns ``(step, cache_specs)``: step(model,
    caches, tokens, pos) -> (logits, caches), one greedy decode step of the
    global ``batch`` sequences' tokens (batch, 1) at position ``pos``, run
    on this rank's batch shard (logits (batch / (g_data g_z), 1, V/y)), and
    the (shape, dtype) of this rank's caches of ``seq`` positions.
    ``seqshard`` (the reference's ``long_500k`` decode): the K/V caches'
    sequence dim is sharded over data instead, the tokens are replicated
    and every rank returns the whole batch's logits (batch, 1, V/y).
    ``overlap``: the overlapped schedule of the step's tp matmuls."""
    axes = axes.with_overlap(overlap)

    def build(batch: int, seq: int):
        def step(model, caches, tokens, pos, plain: bool = False):
            if not seqshard:
                tokens = M.batch_shard(tokens, axes)
            with D.overlap_bound(model, axes.overlap):
                return D.decode_step(model, tokens, caches, pos,
                                     seqshard=seqshard, plain=plain)
        return step, D.decoder_cache_specs(cfg, axes, batch, seq,
                                           dtype=dtype, seqshard=seqshard)
    return build


def zeros_caches(cache_specs, device="cuda"):
    """Zero-filled caches from a spec: a (shape, dtype) leaf, or a dict or
    list of specs (the paged pools are {name: (shape, dtype)}, the
    fixed-batch caches a list of such dicts, one per layer)."""
    dev = resolve_device(device)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [make(v) for v in spec]
        shape, dt = spec
        return torch.zeros(shape, dtype=dt, device=dev)
    return make(cache_specs)
