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
from typing import Optional

import torch

from repro_torch import convert
from repro_torch.core import mesh as M
from repro_torch.core.overdecompose import split_batch
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import param_spec, z_reduce_grads
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
               seed: int = 0, *, device="cuda",
               dtype=torch.float32) -> D.Decoder:
    """Random weights from ``seed``, drawn on ``device`` from the JAX
    package's distributions (N(0, 1/k) projections, N(0, 0.02^2)
    embedding, unit norms). The values differ from ``jax.random``'s. On a
    mesh each rank keeps its block of every parameter by its
    PartitionSpec: the slices of the one-card model of the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return D.Decoder(cfg, axes or M.MeshAxes(), gen=gen, dtype=dtype)


# ---------------------------------------------------------------------- #
# train step
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TrainOptions:
    overdecompose: int = 2      # paper §4.2 (2 batch-shards); 1 = off
    remat: bool = True
    remat_policy: str = "full"  # only "full" is ported
    xent_chunks: int = 1
    dtype: torch.dtype = torch.bfloat16
    # ring-decomposed collective matmuls, the seq ring and weight-gather
    # caching (core/overlap.py; rides down to the layers on the axes)
    overlap: OverlapConfig = OverlapConfig()
    # not ported; raises in make_train_step: the data-parallel sync modes
    # other than the blocking psum ("zero", "zero3", "stream")
    gradsync: str = "blocking"


def _loss_fn(cfg: ArchConfig, axes: M.MeshAxes, opts: TrainOptions):
    def f(model, batch, plain: bool = False):
        return D.lm_loss(model, batch["tokens"], batch["labels"],
                         image_embeds=batch.get("image_embeds"),
                         remat=opts.remat, xent_chunks=opts.xent_chunks,
                         remat_policy=opts.remat_policy, plain=plain)
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
    own tokens' contributions); then over z for parameters whose backward
    has not reduced them there, and over y for those whose y ranks hold
    parts of them (``partition.z_reduce_grads``). Every rank holding the
    same block gets the same bits."""
    if axes.size(("data", "seq")) > 1:
        for g in grads.values():
            g.copy_(M.psum(g, axes, ("data", "seq")))
    return z_reduce_grads(grads, axes)


def make_train_step(cfg: ArchConfig, axes: M.MeshAxes,
                    opt_cfg: OPT.AdamWConfig,
                    opts: TrainOptions = TrainOptions()):
    """The plain mode of the JAX ``make_train_step``, the blocking
    collective schedule: ``step(model, opt_state, batch, plain=False) ->
    metrics``. ``batch`` is the global batch, striped by
    :func:`stripe_batch` on a seq axis; each rank takes its rows (batch
    shard ``axis_index((data, z))``) and then its contiguous shard of the
    sequence, as the JAX step's ``shard_map`` in_specs do. It splits them
    into ``opts.overdecompose`` microbatches, accumulates their gradients
    in fp32 and divides by their count, psums over data and seq, reduces
    over z and y by each parameter's layout (``partition.z_reduce_grads``)
    and applies AdamW, whose gradient norm psums each block over its
    spec's axes. The model's parameters (this rank's blocks) and
    ``opt_state`` (``adamw.init_state`` of ``model.named_parameters()``)
    are updated in place; every rank holding the same block ends with the
    same bits. In float32 the parameters' ``.grad`` is the accumulator; in
    bfloat16 with more than one microbatch a separate fp32 one is, as the
    JAX step casts each microbatch's gradients to fp32 before summing.
    With one microbatch the gradients keep their dtype and are reduced in
    it, as the JAX step's are. ``opts.overlap`` picks the overlapped
    schedule's rings; ``OverlapConfig()`` is the blocking schedule."""
    axes = axes.with_overlap(opts.overlap)
    if opts.gradsync != "blocking":
        raise NotImplementedError(
            f"gradient sync {opts.gradsync!r} (ZeRO, ZeRO-3, streamed "
            f"buckets) is not ported to PyTorch yet: it waits for the "
            f"ROADMAP.md §1 item 'rest of the training stack'")
    loss_fn = _loss_fn(cfg, axes, opts)

    def step(model, opt_state, batch, plain: bool = False):
        with D.overlap_bound(model, axes.overlap):
            return _step(model, opt_state, batch, plain)

    def _step(model, opt_state, batch, plain):
        params = dict(model.named_parameters())
        dtypes = {p.dtype for p in params.values()}
        if dtypes != {opts.dtype}:
            raise TypeError(f"TrainOptions.dtype is {opts.dtype}, the model's "
                            f"parameters are {sorted(map(str, dtypes))}")
        n = opts.overdecompose
        mbs = split_batch({k: M.seq_shard(M.batch_shard(v, axes), axes)
                           for k, v in batch.items()}, n, axes=axes)
        acc = None
        if n > 1 and opts.dtype != torch.float32:
            acc = {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()}
        for p in params.values():
            p.grad = None
        loss = metrics = None
        for i in range(n):
            li, mi = loss_fn(model, {k: v[i] for k, v in mbs.items()},
                             plain=plain)
            li.backward()
            if acc is not None:
                for k, p in params.items():
                    acc[k] += p.grad.float()
                    p.grad = None
            li, mi = li.detach(), {k: v.detach() for k, v in mi.items()}
            loss = li if loss is None else loss + li
            metrics = mi if metrics is None else {
                k: metrics[k] + mi[k] for k in metrics}
        grads = {k: (p.grad if acc is None else acc[k])
                 for k, p in params.items()}
        if n > 1:
            loss = loss / n
            metrics = {k: v / n for k, v in metrics.items()}
            grads = {k: g.div_(n) for k, g in grads.items()}
        grads = sync_grads(grads, axes)
        om = OPT.apply_updates(params, grads, opt_state, opt_cfg,
                               no_decay=no_decay_names(model),
                               specs={k: param_spec(k) for k in params},
                               axes=axes)
        for p in params.values():
            p.grad = None
        return dict(metrics, loss=loss, **om)

    return step


def param_sha256(model) -> str:
    """SHA-256 of every parameter's bytes, in order: equal on two ranks
    only if their parameters are bitwise equal."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy())
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
