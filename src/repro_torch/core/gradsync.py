"""Bucketed data-parallel gradient sync and ZeRO-1 sharded AdamW state
(port of the ZeRO-1 half of ``repro.core.gradsync``).

The blocking schedule of ``launch/steps.sync_grads`` all-reduces every
gradient leaf over ``data`` after the microbatch loop, and keeps AdamW's
fp32 state replicated over data. This module packs the gradients into
size-bounded fp32 buckets instead:

  * **Bucketing** (:func:`make_plan`): the leaves of the JAX parameter
    tree, in its leaf order, grouped by reduction class ``(z_reduced,
    y_reduce, dtype)`` and packed greedily under ``bucket_mb`` (at least
    one leaf a bucket), each bucket padded to a multiple of g_data. The
    port keeps one module per layer where the JAX tree stacks the layers
    of a segment position (n_periods, ...): a stacked leaf here is its
    layers' tensors, raveled in period order (``convert.jax_path``). So
    the bucket boundaries, padding, group ids and each rank's shard
    contents are the reference's element for element, and
    :func:`plan_fingerprint` gives the reference's digest.
  * **Reduce-scatter** over the data ring (``mesh.ring_reduce_scatter``,
    or the blocking ``mesh.psum_scatter``): each rank keeps its 1/g_data
    fp32 shard of every bucket; the train step streams one per microbatch
    (``GradSyncConfig.stream``). The y/z reductions then run on whole
    buckets of shards (:func:`tensor_reduce_shards`).
  * **ZeRO-1** (``optim.adamw.apply_updates_sharded``): each data rank
    keeps m/v/master only for its shards; the updated masters are cast to
    the parameters' dtype, all-gathered over data and written into the
    model's parameters in place (:func:`rebuild_params`).

Per-element metadata (weight decay, the mesh axes a grad-norm term is
psum'd over) is a per-bucket int8 group id (:class:`GroupMeta`); a rank
reads the slice of its shard (:func:`gid_shard`).

One departure (ROADMAP.md §3, ``partition.LEAF_SPECS``): the port sums the
qk-norm gains' gradients over y (``y_heads``), which the reference does
not. Their leaves keep the reference's class (so the plan and its
fingerprint are the reference's); :func:`tensor_reduce_shards` psums their
elements over y within their bucket.

ZeRO-3 (``zero3``): the parameters themselves live as 1/G_data shards.
:func:`make_leaf_plan` makes one bucket a JAX leaf, a stacked leaf sharded
per layer (its state is ``(stack, padded/dp)``, row i layer i's); the
port keeps each parameter's shard as a 1-D tensor of ``padded/dp``
elements (:func:`shard_tensor`, row i of the reference's shard for layer
i). :func:`gather_param_leaf` assembles a working copy over data (an
autograd Function whose backward reduce-scatters the gradient over data,
the JAX transpose); :class:`ParamStreamer` is the policy the model's
forward follows: which leaves stream layer by layer, and with
``prefetch`` layer i+1's exchange posted before layer i computes
(``mesh.GatherAsync``) and the copy kept on the host for the backward.
The update writes the cast masters into the shards
(:func:`shards_to_tree`); no collective.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mesh as M

# this process's data-axis traffic of the bucketed sync, by kind
# ("reduce_scatter": the gradients' buckets, or under ZeRO-3 a leaf's
# gradient in the gather's backward; "all_gather": the gathered gradients,
# the rebuilt parameters, or under ZeRO-3 a leaf's working copy in the
# forward; "regather": under ZeRO-3 a streamed leaf gathered again by
# remat's recompute): {"calls": one a bucket or leaf, "bytes" and
# "seconds": the data axis's counts in mesh.COMM_AXES over those calls}
DP_SYNC: Dict[str, Dict[str, float]] = {}

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


def reset_dp_sync() -> None:
    DP_SYNC.clear()


class _Counted:
    """Adds the data axis's mesh counts over the block to ``DP_SYNC[kind]``
    (one call)."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        self.before = dict(M.COMM_AXES.get("data", {}))

    def __exit__(self, *exc):
        now = M.COMM_AXES.get("data", {})
        count = DP_SYNC.setdefault(self.kind, {"calls": 0, "bytes": 0,
                                               "seconds": 0.0})
        count["calls"] += 1
        for k in ("bytes", "seconds"):
            count[k] += now.get(k, 0) - self.before.get(k, 0)


# ---------------------------------------------------------------------- #
# config
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """Knobs for the data-parallel gradient synchronization subsystem.

    bucketed: replace the per-leaf blocking ``psum`` over ``data`` with
    bucketed ring reduce-scatter + all-gather of the *gradients* (AdamW
    state stays replicated). zero: additionally keep the gradients
    scattered and shard the AdamW state ZeRO-1-style over ``data``
    (implies the bucketed schedule; the all-gather moves updated *params*
    instead of gradients). zero3: additionally shard the *params* over
    ``data`` (one stack-aware bucket per leaf, :func:`make_leaf_plan`)
    and stream each layer's working copy just-in-time through the layer
    scan (:class:`ParamStreamer`) — param memory drops by ``G_data`` on
    top of the ZeRO-1 optimizer drop; the update's param rebroadcast
    disappears (new shards come straight from the master shards). All
    off (default) keeps the blocking path.

    prefetch (zero3 only): gather layer ``i+1``'s shards during layer
    ``i``'s compute via the scan carry and *retain* the gathered copy
    for the backward (no re-gather; per-rank peak param memory returns
    to ~full — the comm-vs-memory point of FSDP's
    reshard_after_forward=False). Off (default): the gather lives inside
    the rematerialized scan body, released after the layer and
    re-gathered for its backward — peak param memory is the shards plus
    one in-flight layer's working set.

    cross_step: comm-model knob only (``comm_model.dp_sync_time``):
    model the cross-step overlap window where the terminal collectives
    of step t — the ZeRO-1 param all-gather / ZeRO-3 first-layer gather
    and the last microbatch's reduce-scatter — hide under step t+1's
    first-microbatch forward and the optimizer math respectively. Off
    reproduces the fully-exposed terminal model exactly.

    bucket_mb: fp32 bucket size bound in MiB. Smaller buckets give the
    scheduler finer-grained ring/backward pairs to overlap but pay more
    α-latency (``comm_model.dp_sync_time`` prices exactly this).

    stream: issue each microbatch's bucket reduce-scatters *inside* the
    overdecompose loop (the overlap window — DP comm of microbatch i
    rides under microbatch i+1's backward). Off accumulates fp32 locally
    and reduce-scatters once after the loop (lower volume at high
    overdecompose, no overlap window).

    ring: decompose the data-axis collectives into ``ppermute`` ring hops
    (collective-permute chains in HLO). Off uses the blocking
    ``psum_scatter``/``all_gather`` (still no all-reduce over ``data``).
    """

    bucketed: bool = False
    zero: bool = False
    zero3: bool = False
    prefetch: bool = False
    cross_step: bool = False
    bucket_mb: float = 4.0
    stream: bool = True
    ring: bool = True

    def __post_init__(self):
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")
        if self.prefetch and not self.zero3:
            raise ValueError("prefetch is a zero3 knob (param-shard "
                             "streaming retention); set zero3=True")

    @property
    def enabled(self) -> bool:
        return self.bucketed or self.zero or self.zero3

    @property
    def state_sharded(self) -> bool:
        """AdamW state lives as 1/G_data shards (ZeRO-1 and up)."""
        return self.zero or self.zero3

    @property
    def bucket_bytes(self) -> int:
        return int(self.bucket_mb * 2 ** 20)


# ---------------------------------------------------------------------- #
# the JAX tree's leaves
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX parameter tree as the port holds it: ``names``
    are the port parameters it stacks, in period order (one name for an
    unstacked leaf); ``shape`` is the rank's local shape of the JAX leaf
    (``(n_periods, ...)`` for a stacked one); ``spec`` its PartitionSpec
    (a stacked leaf's starts with None) and the flags of
    ``partition.ParamSpec``."""

    path: str
    names: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: tuple
    z_reduced: bool = False
    y_reduce: bool = False
    y_heads: bool = False


def model_leaves(params: Dict[str, torch.Tensor], cfg) -> List[Leaf]:
    """The JAX tree's leaves, in its leaf order (``jax.tree_util`` sorts
    dict keys level by level), from the port's parameters (name ->
    this rank's block) of the model ``cfg``."""
    from repro_torch import convert
    from repro_torch.core.partition import leaf_spec
    by_path: Dict[str, List[Tuple[int, str]]] = {}
    for name in params:
        path = convert.jax_path(name, cfg)
        period = (convert._slot(name, cfg)[2] if name.startswith("layers.")
                  else -1)
        by_path.setdefault(path, []).append((period, name))
    out = []
    for path in sorted(by_path, key=lambda p: tuple(p.split("/"))):
        entries = sorted(by_path[path])
        names = tuple(n for _, n in entries)
        first = params[names[0]]
        ps = leaf_spec(names[0])
        stacked = entries[0][0] >= 0
        if stacked and [p for p, _ in entries] != list(range(len(names))):
            raise ValueError(f"{path}: periods {[p for p, _ in entries]}")
        out.append(Leaf(
            path=path, names=names,
            shape=((len(names),) if stacked else ()) + tuple(first.shape),
            dtype=first.dtype,
            spec=((None,) if stacked else ()) + tuple(ps.spec),
            z_reduced=ps.z_reduced, y_reduce=ps.y_reduce,
            y_heads=ps.y_heads))
    return out


# ---------------------------------------------------------------------- #
# bucket plan
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class GroupMeta:
    """One per-element metadata class inside a bucket: whether weight
    decay applies and which mesh axes the element's grad-norm
    contribution must be psum'd over (the leaf's sharded axes, exactly
    as ``optim.adamw.global_grad_norm`` reads them off the ParamSpec)."""

    decay: bool
    norm_names: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Segment:
    """One leaf's slice of a bucket (offsets/sizes in *local* elements)."""

    leaf: int                 # index into the flattened param/grad tree
    offset: int               # start inside the (unpadded) bucket
    size: int                 # local element count
    shape: Tuple[int, ...]    # local shape


@dataclasses.dataclass(eq=False)
class Bucket:
    """A flat ``(padded,)`` fp32 buffer of whole leaves (the gradient
    plan), or in ZeRO-3's leaf plan one leaf, ``(stack, padded)`` when it
    stacks ``stack`` layers (each row one layer's, padded on its own).
    ``group_of[k]`` is segment k's group in ``groups``; :attr:`gid` spells
    it out per element of a row."""

    segments: Tuple[Segment, ...]
    size: int                 # unpadded elements
    padded: int               # padded to a multiple of dp
    z_reduced: bool           # grads already reduce-scattered over z
    y_reduce: bool            # grads need a psum over y
    dtype: torch.dtype        # param dtype of every leaf in this bucket
    groups: Tuple[GroupMeta, ...]
    group_of: Tuple[int, ...]
    # (start, end) element ranges of the y_heads leaves (psum'd over y)
    y_heads: Tuple[Tuple[int, int], ...] = ()
    stack: int = 1

    @property
    def gid(self) -> np.ndarray:
        """(padded,) int8 group id per element (padding: group 0)."""
        gid = np.zeros((self.padded,), np.int8)
        for seg, g in zip(self.segments, self.group_of):
            gid[seg.offset:seg.offset + seg.size] = g
        return gid


@dataclasses.dataclass(eq=False)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    leaves: Tuple[Leaf, ...]  # the JAX tree's leaves (``Segment.leaf``)
    dp: int                   # flattened data-ring size
    n_leaves: int

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        """Per-rank fp32 elements per bucket, per stack slot."""
        return tuple(b.padded // self.dp for b in self.buckets)

    @property
    def shard_elements(self) -> int:
        """Per-rank fp32 elements of every bucket's shard, stacks
        included (the size of each of m, v and master)."""
        return sum(b.padded // self.dp * b.stack for b in self.buckets)

    @property
    def total_elements(self) -> int:
        return sum(b.size * b.stack for b in self.buckets)

    @property
    def padded_elements(self) -> int:
        return sum(b.padded * b.stack for b in self.buckets)


def plan_fingerprint(plan: BucketPlan) -> str:
    """Stable digest of a plan's *replicated* leaf layout.

    Covers everything that determines the replicated per-leaf state a
    checkpoint (or an in-memory elastic snapshot) carries — leaf count,
    per-slot sizes/segments, stacking, dtypes, reduction classes — but
    deliberately excludes ``dp`` and the dp-derived padding, so two
    plans built at different ``g_data`` over the same model/tensor
    factors fingerprint identically. ``launch.steps.restore_state``
    compares fingerprints across an elastic rebuild: a mismatch means
    the rebuild changed the tensor partitioning (not just the data
    axis) and the snapshot cannot be re-sharded onto it. Dtypes hash by
    their JAX names ("float32", "bfloat16"), so the digest is the
    reference's for the same model and mesh.
    """
    h = hashlib.sha256(f"{plan.n_leaves}".encode())
    for b in plan.buckets:
        h.update(f"|{b.size}:{b.stack}:{_DTYPE_NAMES[b.dtype]}"
                 f":{int(b.z_reduced)}:{int(b.y_reduce)}".encode())
        for s in b.segments:
            h.update(f";{s.leaf}:{s.offset}:{s.size}:{s.shape}".encode())
    return h.hexdigest()[:16]


def _norm_names(spec) -> Tuple[str, ...]:
    """Mesh axes a leaf's grad-norm contribution is psum'd over (same
    extraction as ``optim.adamw.global_grad_norm``, in the spec's own
    order)."""
    return tuple(n for entry in spec if entry is not None
                 for n in (entry if isinstance(entry, tuple) else (entry,)))


def make_plan(leaves: Sequence[Leaf], axes: M.MeshAxes, bucket_bytes: int,
              *, no_decay: Optional[Callable[[str], bool]] = None
              ) -> BucketPlan:
    """Pack the param/grad tree into size-bounded fp32 buckets.

    ``leaves`` are the JAX tree's leaves in its order (:func:`model_leaves`),
    at their local shapes. ``no_decay(path) -> bool`` marks leaves that
    skip weight decay (``optim.adamw._no_decay``); None = decay
    everywhere the config asks. Leaves are grouped by reduction class
    ``(z_reduced, y_reduce, dtype)`` — one bucket never mixes classes, so
    the post-scatter tensor-axis reductions apply to whole buckets — then
    packed greedily in tree order with at least one leaf per bucket, and
    padded to a multiple of the data-ring size.
    """
    dp = max(axes.dp, 1)
    cap = max(int(bucket_bytes) // 4, 1)  # buckets are fp32

    # one open bucket per reduction class: key -> [(Segment, GroupMeta,
    # y_heads)]
    open_buckets: dict = {}
    done: List[Bucket] = []

    def close(key):
        items = open_buckets.pop(key)
        segs = tuple(s for s, _, _ in items)
        size = sum(s.size for s in segs)
        padded = -(-size // dp) * dp
        groups: List[GroupMeta] = []
        gix: dict = {}
        group_of = []
        for seg, meta, _ in items:
            g = gix.setdefault(meta, len(groups))
            if g == len(groups):
                groups.append(meta)
            group_of.append(g)
        if len(groups) > 127:
            raise ValueError("too many metadata groups in one bucket")
        z_red, y_red, dtype = key
        done.append(Bucket(
            segments=segs, size=size, padded=padded, z_reduced=z_red,
            y_reduce=y_red, dtype=dtype, groups=tuple(groups),
            group_of=tuple(group_of),
            y_heads=tuple((s.offset, s.offset + s.size)
                          for s, _, yh in items if yh)))

    for i, lf in enumerate(leaves):
        size = math.prod(lf.shape)
        key = (bool(lf.z_reduced), bool(lf.y_reduce), lf.dtype)
        meta = GroupMeta(decay=(no_decay is None or not no_decay(lf.path)),
                         norm_names=_norm_names(lf.spec))
        items = open_buckets.get(key)
        if items is not None and sum(s.size for s, _, _ in items) \
                + size > cap:
            close(key)
            items = None
        if items is None:
            items = open_buckets[key] = []
        off = sum(s.size for s, _, _ in items)
        items.append((Segment(leaf=i, offset=off, size=size,
                              shape=tuple(lf.shape)), meta,
                      bool(lf.y_heads and not lf.y_reduce)))
    for key in list(open_buckets):
        close(key)
    return BucketPlan(buckets=tuple(done), leaves=tuple(leaves), dp=dp,
                      n_leaves=len(leaves))


def make_leaf_plan(leaves: Sequence[Leaf], axes: M.MeshAxes, *,
                   no_decay: Optional[Callable[[str], bool]] = None
                   ) -> BucketPlan:
    """The ZeRO-3 parameter-shard layout: one bucket a leaf, in the JAX
    tree's order (``plan.buckets[i]`` <-> ``plan.leaves[i]``). A leaf that
    stacks more than one layer (its path under ``segments/``) is sharded
    per stack slot: bucket ``stack`` is its layer count, ``size`` and
    ``padded`` one layer's, so each layer's shard is its own
    ``padded // dp`` elements. A segment of one period (``n_periods ==
    1``) plans as unstacked, its shape keeping the leading 1, as the
    reference's ``_stack_of`` does. The per-element metadata, the state's
    helpers and the checkpoint's gather and scatter work on this plan as
    on :func:`make_plan`'s."""
    dp = max(axes.dp, 1)
    done: List[Bucket] = []
    for i, lf in enumerate(leaves):
        stack = lf.shape[0] if _stacked(lf) and lf.shape[0] > 1 else 1
        slot = tuple(lf.shape[1:]) if stack > 1 else tuple(lf.shape)
        size = math.prod(slot)
        meta = GroupMeta(decay=(no_decay is None or not no_decay(lf.path)),
                         norm_names=_norm_names(lf.spec))
        done.append(Bucket(
            segments=(Segment(leaf=i, offset=0, size=size, shape=slot),),
            size=size, padded=-(-size // dp) * dp,
            z_reduced=bool(lf.z_reduced), y_reduce=bool(lf.y_reduce),
            dtype=lf.dtype, groups=(meta,), group_of=(0,),
            y_heads=(((0, size),) if lf.y_heads and not lf.y_reduce
                     else ()),
            stack=stack))
    return BucketPlan(buckets=tuple(done), leaves=tuple(leaves), dp=dp,
                      n_leaves=len(leaves))


# ---------------------------------------------------------------------- #
# flatten / unflatten (this rank's local blocks)
# ---------------------------------------------------------------------- #

@torch.no_grad()
def flatten_bucket(tensors: Dict[str, torch.Tensor], bucket: Bucket,
                   plan: BucketPlan, *, dtype=torch.float32) -> torch.Tensor:
    """Concat the bucket's leaves (raveled, a stacked leaf's layers in
    period order, cast) + zero padding: ``(padded,)``; a leaf-plan bucket
    of ``stack`` layers gives ``(stack, padded)``, a row a layer.
    ``tensors``: port parameter name -> tensor (parameters or their
    gradients)."""
    if bucket.stack > 1:
        names = plan.leaves[bucket.segments[0].leaf].names
        out = torch.zeros((bucket.stack, bucket.padded), dtype=dtype,
                          device=tensors[names[0]].device)
        for k, n in enumerate(names):
            out[k, :bucket.size] = tensors[n].reshape(-1)
        return out
    parts = [tensors[n].reshape(-1)
             for s in bucket.segments for n in plan.leaves[s.leaf].names]
    if bucket.padded > bucket.size:
        parts.append(parts[0].new_zeros((bucket.padded - bucket.size,)))
    out = torch.empty((bucket.padded,), dtype=dtype, device=parts[0].device)
    return torch.cat([p.to(dtype) for p in parts], out=out)


def unflatten_bucket(flat: torch.Tensor, bucket: Bucket, plan: BucketPlan
                     ) -> List[Tuple[str, torch.Tensor]]:
    """Full (padded) flat bucket -> [(port parameter name, view of its
    local shape)]; a stacked bucket's row k is its layer k's."""
    if bucket.stack > 1:
        lf = plan.leaves[bucket.segments[0].leaf]
        return [(n, flat[k, :bucket.size].view(_local_shape(lf)))
                for k, n in enumerate(lf.names)]
    out = []
    for s in bucket.segments:
        lf = plan.leaves[s.leaf]
        per = s.size // len(lf.names)
        for k, n in enumerate(lf.names):
            start = s.offset + k * per
            out.append((n, flat[start:start + per].view(_local_shape(lf))))
    return out


def _stacked(lf: Leaf) -> bool:
    """Whether the JAX leaf stacks layers (its path is under segments/)."""
    return lf.path.startswith("segments/")


def _local_shape(lf: Leaf) -> Tuple[int, ...]:
    """The port parameter's local shape: the leaf's, without the stack."""
    return lf.shape[1:] if _stacked(lf) else lf.shape


def _shard_index(axes: M.MeshAxes) -> int:
    """This rank's block index on the flattened data ring — the block
    ``ring_reduce_scatter`` leaves here and ``ring_all_gather`` reads
    from here (first-name-major, mesh.flat_ring_axis convention)."""
    return M.flat_ring_index(axes, "data")


def shard_slice(full, plan: BucketPlan, bucket: Bucket, axes: M.MeshAxes):
    """Carve this rank's shard out of a full (padded) bucket-length
    array (last dim); a view."""
    ln = bucket.padded // plan.dp
    return full.narrow(-1, _shard_index(axes) * ln, ln)


# ---------------------------------------------------------------------- #
# collectives over the data ring
# ---------------------------------------------------------------------- #

def reduce_scatter_grads(grads: Dict[str, torch.Tensor], plan: BucketPlan,
                         axes: M.MeshAxes, *, ring: bool = True
                         ) -> List[torch.Tensor]:
    """One microbatch's gradients (name -> tensor) -> per-bucket scattered
    fp32 shards (this rank's ``1/G_data`` block of each data-summed
    bucket)."""
    out = []
    for b in plan.buckets:
        with _Counted("reduce_scatter"):
            flat = flatten_bucket(grads, b, plan)
            if ring:
                s = M.ring_reduce_scatter(flat, axes, "data", dim=-1)
            else:
                s = M.psum_scatter(flat, axes, "data", dim=-1)
            out.append(s)
    return out


def tensor_reduce_shards(shards: Sequence[torch.Tensor], plan: BucketPlan,
                         axes: M.MeshAxes) -> List[torch.Tensor]:
    """The per-leaf y/z reductions of ``partition.z_reduce_grads``, as
    whole-bucket psums on the scattered shards (class-pure buckets; flat
    layouts align element-wise across y/z ranks). Shards are 1/G_data of
    the full buffers, so this moves less than the per-leaf form. The
    ``y_heads`` leaves' elements of a bucket that is not psum'd over y
    whole are psum'd over y in one call (the port's departure)."""
    out = []
    for b, s in zip(plan.buckets, shards):
        if b.y_reduce:
            s = M.psum(s, axes, "y")
        elif b.y_heads and axes.gy > 1:
            s = _psum_ranges(s, plan, b, axes)
        if not b.z_reduced:
            s = M.psum(s, axes, "z")
        out.append(s)
    return out


def _psum_ranges(shard, plan, bucket, axes):
    """``shard`` with its elements inside ``bucket.y_heads`` psum'd over
    y (one call for all of them)."""
    ln = bucket.padded // plan.dp
    lo = _shard_index(axes) * ln
    cuts = [(max(a, lo) - lo, min(b, lo + ln) - lo)
            for a, b in bucket.y_heads if a < lo + ln and b > lo]
    if not cuts:
        # the y ranks share this shard's index, so each skips alike
        return shard
    pieces = torch.cat([shard[..., a:b] for a, b in cuts], dim=-1)
    summed = M.psum(pieces, axes, "y")
    out, k = shard.clone(), 0
    for a, b in cuts:
        out[..., a:b] = summed[..., k:k + b - a]
        k += b - a
    return out


def _gather(flat_shard, axes: M.MeshAxes, ring: bool):
    if ring:
        return M.ring_all_gather(flat_shard, axes, "data", dim=-1)
    return M.all_gather(flat_shard, axes, "data", dim=-1)


def all_gather_grads(shards: Sequence[torch.Tensor], plan: BucketPlan,
                     axes: M.MeshAxes, *, ring: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """Scattered fp32 shards -> full per-parameter gradients (fp32, name
    -> local-shaped tensor)."""
    out: Dict[str, torch.Tensor] = {}
    for b, s in zip(plan.buckets, shards):
        with _Counted("all_gather"):
            full = _gather(s, axes, ring)
        for n, arr in unflatten_bucket(full, b, plan):
            out[n] = arr
    return out


@torch.no_grad()
def rebuild_params(master_shards: Sequence[torch.Tensor], plan: BucketPlan,
                   axes: M.MeshAxes, params: Dict[str, torch.Tensor], *,
                   ring: bool = True) -> None:
    """ZeRO-1 param rebroadcast: cast each updated fp32 master shard to
    the bucket's param dtype, all-gather it over ``data`` and write each
    leaf into the model's parameter ``params[name]`` in place. (Cast, then
    gather: half the wire bytes of gathering fp32 for bf16 parameters;
    the cast is element-wise, so the result is unchanged.)"""
    for b, s in zip(plan.buckets, master_shards):
        with _Counted("all_gather"):
            full = _gather(s.to(b.dtype), axes, ring)
        for n, arr in unflatten_bucket(full, b, plan):
            params[n].copy_(arr)


# ---------------------------------------------------------------------- #
# ZeRO-3 parameter-shard streaming (leaf plans, make_leaf_plan)
# ---------------------------------------------------------------------- #

def shard_tensor(t: torch.Tensor, axes: M.MeshAxes) -> torch.Tensor:
    """This rank's ZeRO-3 shard of one local parameter ``t``: its raveled
    elements zero-padded to a multiple of g_data, block
    ``flat_ring_index(data)`` of ``ceil(numel / g_data)`` elements, in
    t's dtype, on t's device (a new tensor; the padded whole is never
    built). For a layer of a stacked leaf this is row ``layer`` of the
    reference's ``(stack, padded/dp)`` shard."""
    flat = t.detach().reshape(-1)
    n = flat.numel()
    ln = -(-n // max(axes.dp, 1))
    lo = _shard_index(axes) * ln
    out = flat.new_zeros((ln,))
    if min(lo + ln, n) > lo:
        out[:min(lo + ln, n) - lo] = flat[lo:lo + ln]
    return out


def shard_params(params: Dict[str, torch.Tensor], axes: M.MeshAxes
                 ) -> Dict[str, torch.Tensor]:
    """Full local parameters (name -> tensor) -> this rank's shard of
    each (:func:`shard_tensor`)."""
    return {n: shard_tensor(p, axes) for n, p in params.items()}


def leaf_shapes(plan: BucketPlan) -> Dict[str, Tuple[int, ...]]:
    """Each port parameter's local shape, by name."""
    return {n: _local_shape(lf) for lf in plan.leaves for n in lf.names}


class _Fetch:
    """Where one leaf's working copy comes from each time the forward or
    remat's recompute asks for it (a call returns the ``(padded,)`` whole
    on the shard's device): a gather over data, counted "all_gather" the
    first time and "regather" after; or an exchange posted earlier
    (``pending``, a ``mesh.GatherAsync``), counted "all_gather" when it
    lands, whose host copy is kept and copied back for each later call
    with no collective."""

    def __init__(self, shard, axes: M.MeshAxes, ring: bool, pending=None):
        self.shard, self.axes, self.ring = shard.detach(), axes, ring
        self.pending, self.kept, self.calls = pending, None, 0

    def __call__(self) -> torch.Tensor:
        self.calls += 1
        if self.kept is not None:
            return self.kept.to(self.shard.device)
        if self.pending is not None:
            with _Counted("all_gather"):
                full = self.pending.wait()
            self.kept, self.pending = self.pending.host, None
            return full
        with _Counted("all_gather" if self.calls == 1 else "regather"):
            return _gather(self.shard, self.axes, self.ring)


class _GatherLeaf(torch.autograd.Function):
    """shard -> the leaf's working copy (``fetch``); backward: the
    gradient zero-padded and reduce-scattered over data in its own dtype
    (the JAX transpose of the gather), counted "reduce_scatter"."""

    @staticmethod
    def forward(ctx, shard, fetch, shape, axes, ring):
        n = math.prod(shape)
        full = fetch()
        ctx.meta = (n, full.shape[-1], axes, ring)
        out = full[:n].view(shape)
        return out.clone() if out.data_ptr() == shard.data_ptr() else out

    @staticmethod
    def backward(ctx, g):
        n, padded, axes, ring = ctx.meta
        if padded == n:
            flat = g.reshape(-1)
        else:
            flat = g.new_zeros((padded,))
            flat[:n] = g.reshape(-1)
        with _Counted("reduce_scatter"):
            if ring:
                out = M.ring_reduce_scatter(flat, axes, "data", dim=-1)
            else:
                out = M.psum_scatter(flat, axes, "data", dim=-1)
        return out, None, None, None, None


def gather_param_leaf(shard: torch.Tensor, shape, axes: M.MeshAxes, *,
                      ring: bool = True, fetch=None) -> torch.Tensor:
    """Assemble one leaf's working copy (its local ``shape``) from this
    rank's shard: gathered over data (a ring of ``ppermute`` hops, the z
    rings' send-right convention, or the blocking gather), trimmed and
    reshaped; ``fetch`` (a :class:`_Fetch`) says where the whole comes
    from instead. Differentiable: the backward reduce-scatters the
    gradient over data, so the data-parallel sync falls out of autograd
    and the shard's ``.grad`` is this rank's block of the data sum."""
    fetch = fetch or _Fetch(shard, axes, ring)
    return _GatherLeaf.apply(shard, fetch, tuple(shape), axes, ring)


@torch.no_grad()
def unshard_params(shards: Dict[str, torch.Tensor], plan: BucketPlan,
                   axes: M.MeshAxes, *, ring: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """Shards -> full local parameters (name -> tensor; the checkpoint
    path and the escape back to the replicated layout)."""
    shapes = leaf_shapes(plan)
    return {n: gather_param_leaf(s, shapes[n], axes, ring=ring)
            for n, s in shards.items()}


@torch.no_grad()
def shards_to_tree(masters: Sequence[torch.Tensor], plan: BucketPlan,
                   shards: Dict[str, torch.Tensor]) -> None:
    """Write the updated fp32 master shards (bucket order) into the
    parameter shards ``shards`` (name -> tensor), cast to each leaf's
    dtype, in place: ZeRO-3's replacement for :func:`rebuild_params`, with
    no collective (the new parameters are the shards)."""
    for b, m in zip(plan.buckets, masters):
        names = plan.leaves[b.segments[0].leaf].names
        for k, n in enumerate(names):
            shards[n].copy_(m[k] if b.stack > 1 else m)


@dataclasses.dataclass(eq=False)
class ParamStreamer:
    """The ZeRO-3 policy a train step hands to the model's forward
    (``decoder.lm_loss(..., pstream=...)``): which parameters stream
    layer by layer (those of a leaf that stacks layers, bucket ``stack >
    1``) and which are gathered once a microbatch, outside remat
    (:meth:`resident`: the embedding, the final norm, an untied head, the
    layers of a one-period segment), how the gathers run (``ring``), and
    ``prefetch``.

    Without prefetch the forward gathers each streamed layer inside its
    rematerialized block: released after the layer, gathered again by
    the recompute, then reduce-scattered by the backward (3 data passes a
    microbatch). With it, layer i+1's exchanges are posted before layer i
    computes (:meth:`post`) and the copy that lands is kept on the host
    for the recompute (2 passes); either way the device holds at most two
    streamed layers' weights."""

    plan: BucketPlan
    axes: M.MeshAxes
    ring: bool = True
    prefetch: bool = False

    def __post_init__(self):
        self.shapes = leaf_shapes(self.plan)
        self._stack = {n: b.stack for b in self.plan.buckets
                       for n in self.plan.leaves[b.segments[0].leaf].names}

    def streamed(self, name: str) -> bool:
        return self._stack[name] > 1

    def post(self, shards: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """Post the exchanges of ``shards`` (name -> shard) now; each
        lands when :meth:`gather` is given it."""
        return {n: M.GatherAsync(s, self.axes, "data", ring=self.ring)
                for n, s in shards.items()}

    def fetcher(self, shard, pending=None) -> _Fetch:
        """A leaf's source for one microbatch: :func:`gather_param_leaf`'s
        gather, or the posted exchange ``pending``."""
        return _Fetch(shard, self.axes, self.ring, pending)

    def gather(self, shard, name: str, fetch=None) -> torch.Tensor:
        return gather_param_leaf(shard, self.shapes[name], self.axes,
                                 ring=self.ring, fetch=fetch)

    def resident(self, shards: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Every parameter that does not stream, gathered (in the plan's
        order)."""
        return {n: self.gather(shards[n], n) for lf in self.plan.leaves
                for n in lf.names if not self.streamed(n)}


# ---------------------------------------------------------------------- #
# per-element metadata on shards (group ids)
# ---------------------------------------------------------------------- #

def gid_shard(plan: BucketPlan, bucket: Bucket, axes: M.MeshAxes,
              device=None) -> torch.Tensor:
    """This rank's slice of the bucket's int8 group ids, made from the
    segments that meet the shard (the full array is never built)."""
    ln = bucket.padded // plan.dp
    lo = _shard_index(axes) * ln
    out = torch.zeros((ln,), dtype=torch.int8, device=device)
    for seg, g in zip(bucket.segments, bucket.group_of):
        a, b = max(seg.offset, lo), min(seg.offset + seg.size, lo + ln)
        if g and a < b:
            out[a - lo:b - lo] = g
    return out


def decay_mask(bucket: Bucket, gid: torch.Tensor) -> torch.Tensor:
    """fp32 {0,1} mask of elements weight decay applies to. Padding
    carries group 0's flag, which is harmless: padded master stays 0, so
    its decay term is 0 either way."""
    table = torch.tensor([1.0 if g.decay else 0.0 for g in bucket.groups],
                         dtype=torch.float32, device=gid.device)
    return table[gid.long()]


def _mesh_order(names: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(a for a in M.AXES if a in names)


def sharded_grad_norm(shards: Sequence[torch.Tensor], plan: BucketPlan,
                      axes: M.MeshAxes) -> torch.Tensor:
    """L2 norm of the global gradient from the scattered shards.

    Per (bucket, metadata group): local sum of squares, accumulated
    locally per distinct axis set and psum'd ONCE per set over ``data``
    (the shards partition each bucket across data ranks) plus the set's
    own sharded axes — the exact axis sets
    ``optim.adamw.global_grad_norm`` uses per leaf, so the two paths
    agree (bitwise on exactly-summable values). One collective per
    distinct set, in the order the sets first appear."""
    by_axes: dict = {}  # psum axis names -> local scalar accumulator
    for b, s in zip(plan.buckets, shards):
        gid = gid_shard(plan, b, axes, device=s.device)
        sq = (s * s).to(torch.float32)
        for g, meta in enumerate(b.groups):
            loc = torch.sum(torch.where(gid == g, sq, 0.0))
            names = ("data",) + meta.norm_names
            by_axes[names] = by_axes.get(names, 0.0) + loc
    total = torch.zeros((), dtype=torch.float32,
                        device=shards[0].device if shards else None)
    for names, acc in by_axes.items():
        total = total + M.psum(acc, axes, _mesh_order(names))
    return torch.sqrt(total)


# ---------------------------------------------------------------------- #
# ZeRO-1 sharded optimizer state
# ---------------------------------------------------------------------- #

def init_sharded_state(params: Dict[str, torch.Tensor], plan: BucketPlan,
                       axes: M.MeshAxes):
    """m/v/master fp32 shards per bucket + step, from the full local
    parameters (name -> tensor)."""
    buckets = []
    with torch.no_grad():
        for b in plan.buckets:
            master = shard_slice(flatten_bucket(params, b, plan), plan, b,
                                 axes).clone()
            buckets.append({"m": torch.zeros_like(master),
                            "v": torch.zeros_like(master),
                            "master": master})
    return {"buckets": buckets, "step": 0}


def init_state_from_shards(shards: Dict[str, torch.Tensor],
                           plan: BucketPlan):
    """ZeRO-3's m/v/master per bucket + step from the parameter shards
    (name -> this rank's shard): the bits :func:`init_sharded_state`
    makes from the full parameters, with no parameter ever whole."""
    buckets = []
    for b in plan.buckets:
        names = plan.leaves[b.segments[0].leaf].names
        rows = [shards[n].detach().to(torch.float32, copy=True)
                for n in names]
        master = torch.stack(rows) if b.stack > 1 else rows[0]
        buckets.append({"m": torch.zeros_like(master),
                        "v": torch.zeros_like(master), "master": master})
    return {"buckets": buckets, "step": 0}


def iter_full_state(state, plan: BucketPlan, axes: M.MeshAxes):
    """(name, {"m", "v", "master"}) of every parameter in the replicated
    layout of ``optim.adamw.init_state``, one bucket gathered over data
    at a time (blocking gathers): the save path holds one bucket's state
    whole at once, never the model's. Views into that bucket's gathered
    buffers; every rank of the data axis iterates it to the end."""
    for b, st in zip(plan.buckets, state["buckets"]):
        fulls = {k: M.all_gather(st[k], axes, "data", dim=-1)
                 for k in ("m", "v", "master")}
        views = {k: dict(unflatten_bucket(fulls[k], b, plan))
                 for k in fulls}
        for n in views["m"]:
            yield n, {k: views[k][n] for k in ("m", "v", "master")}


def gather_sharded_state(state, plan: BucketPlan, axes: M.MeshAxes):
    """Sharded state -> the replicated-AdamW layout of
    ``optim.adamw.init_state`` (per-parameter fp32 m/v/master, data
    replicated), all of it at once (:func:`iter_full_state` a leaf at a
    time)."""
    per = {n: {k: t.clone() for k, t in st.items()}
           for n, st in iter_full_state(state, plan, axes)}
    names = [n for lf in plan.leaves for n in lf.names]
    return {"opt": {n: per[n] for n in names}, "step": state["step"]}


def scatter_full_state(full, plan: BucketPlan, axes: M.MeshAxes):
    """Inverse of :func:`gather_sharded_state`: replicated-layout state
    -> this rank's shards (the restore path)."""
    buckets = []
    for b in plan.buckets:
        out = {}
        for k in ("m", "v", "master"):
            tensors = {n: full["opt"][n][k] for s in b.segments
                       for n in plan.leaves[s.leaf].names}
            out[k] = shard_slice(flatten_bucket(tensors, b, plan), plan, b,
                                 axes).clone()
        buckets.append(out)
    return {"buckets": buckets, "step": int(full["step"])}
