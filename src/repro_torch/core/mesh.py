"""Mesh axes of the 4D hybrid algorithm (port of ``repro.core.mesh``).

The paper decomposes the devices as ``G_data x G_x x G_y x G_z``;
context parallelism adds a fifth factor ``G_seq``. Every factor may be
above 1. One process runs each rank of the mesh; rank r sits at the
row-major coordinates of r over (data, x, y, z, seq), the device order of
the JAX package's ``make_smoke_mesh``.

A collective over an axis of size 1 is the identity (rank 0 for
``axis_index``), exactly as the JAX helpers degrade on an unmapped axis.
Over a larger axis, or a tuple of axes, it runs over that axis's own
process group: the ranks that share every other coordinate.
:func:`init_groups` creates every such group on every rank in one fixed
order (``launch/mesh.init_mesh`` calls it). A group lists its ranks in
ascending order, which is first-name-major over a tuple whose names are in
mesh order (data, x, y, z, seq): ``axis_index`` over a tuple, the block
layout of ``all_gather`` and its inverse ``psum_scatter`` all follow it,
as in the JAX package.

The backend is gloo. A CUDA tensor is staged through pinned host memory
in one helper (:func:`_run`), which counts, for each kind of collective
and for each axis, the bytes it hands to gloo and takes back, the
host-clock seconds it spends and the calls (:data:`COMM`,
:data:`COMM_AXES`).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("data", "x", "y", "z", "seq")
Axis = Union[str, Tuple[str, ...], None]

# this process's communication by kind of collective ("all_reduce",
# "all_gather", "psum_scatter", "broadcast"), and by axis (its names
# joined by "+"):
# {"bytes": handed to and taken back from gloo, "seconds": host clock in
# the collective, staging and any wait for the other ranks included,
# "calls"}
COMM: Dict[str, Dict[str, float]] = {}
COMM_AXES: Dict[str, Dict[str, float]] = {}

# the process group of each set of axes above size 1 that this rank
# belongs to, keyed by those axes in mesh order (``init_groups``)
_GROUPS: Dict[Tuple[str, ...], object] = {}


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axes with their sizes (g_data, g_x, g_y, g_z[, g_seq]); a
    4-tuple means g_seq = 1."""

    sizes: Tuple[int, ...] = (1, 1, 1, 1)

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.sizes)
        if len(sizes) not in (4, 5) or min(sizes) < 1:
            raise ValueError(f"a mesh has 4 or 5 positive factors {AXES}, "
                             f"got {self.sizes}")
        sizes += (1,) * (len(AXES) - len(sizes))
        object.__setattr__(self, "sizes", sizes)

    def size(self, axis: Axis) -> int:
        return math.prod(self.sizes[AXES.index(a)] for a in _names(axis))

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    @property
    def dp(self) -> int:
        return self.size("data")

    @property
    def gx(self) -> int:
        return self.size("x")

    @property
    def gy(self) -> int:
        return self.size("y")

    @property
    def gz(self) -> int:
        return self.size("z")

    @property
    def gseq(self) -> int:
        return self.size("seq")

    @property
    def tensor(self) -> int:
        return self.gx * self.gy * self.gz

    @property
    def batch_shards(self) -> int:
        """How many ways the batch is split (data x z)."""
        return self.dp * self.gz

    @property
    def token_shards(self) -> int:
        """How many ways the token grid (batch x seq) is split."""
        return self.batch_shards * self.gseq

    @staticmethod
    def all_names() -> Tuple[str, ...]:
        return AXES

    @staticmethod
    def batch_axes() -> Tuple[str, ...]:
        """Axes the batch dim is sharded over, first-name-major."""
        return ("data", "z")

    @staticmethod
    def token_axes() -> Tuple[str, ...]:
        """Axes the token grid is sharded over (batch axes + seq): the
        reduction set of per-token sums like the LM loss."""
        return ("data", "z", "seq")

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Rank ``rank``'s coordinates over (data, x, y, z, seq),
        row-major."""
        out = []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))


def _names(axis) -> Tuple[str, ...]:
    """An axis name, a tuple of names or None (no axis) as a tuple, its
    names in mesh order."""
    if axis is None:
        return ()
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    bad = [n for n in names if n not in AXES]
    if bad:
        raise ValueError(f"axis {axis!r}: unknown names {bad} (the mesh's "
                         f"axes are {AXES})")
    pos = [AXES.index(n) for n in names]
    if pos != sorted(set(pos)):
        raise ValueError(f"tuple axis {names!r} must list its names once "
                         f"each, in mesh order {AXES}")
    return names


def _live(axes: MeshAxes, axis: Axis) -> Tuple[str, ...]:
    """The names of ``axis`` whose size is above 1."""
    return tuple(n for n in _names(axis) if axes.size(n) > 1)


def init_groups(axes: MeshAxes) -> None:
    """Create the process group of every set of axes above size 1, on
    every rank, in one fixed order (``dist.new_group`` must be called by
    every rank in the same order, member or not). Each group holds the
    ranks that share every coordinate outside its axes, in ascending order.
    Keeps this rank's groups; needs the default group."""
    _GROUPS.clear()
    live = [a for a in axes.all_names() if axes.size(a) > 1]
    me = dist.get_rank()
    ranks = range(axes.world)
    for k in range(1, len(live) + 1):
        for names in itertools.combinations(live, k):
            outside = [i for i, a in enumerate(AXES) if a not in names]
            members: Dict[Tuple[int, ...], list] = {}
            for r in ranks:
                c = axes.coords(r)
                members.setdefault(tuple(c[i] for i in outside), []).append(r)
            for group_ranks in members.values():
                group = dist.new_group(group_ranks)
                if me in group_ranks:
                    _GROUPS[names] = group


def clear_groups() -> None:
    _GROUPS.clear()


def _group(axes: MeshAxes, axis: Axis):
    """The process group of ``axis``, or None when it has one rank."""
    live = _live(axes, axis)
    if not live:
        return None
    group = _GROUPS.get(live)
    if group is None:
        raise RuntimeError(
            f"a collective over {axis!r} of size {axes.size(axis)} needs the "
            f"mesh's process groups: run under torch.distributed.run and "
            f"call launch.mesh.init_mesh first")
    return group


def process_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def from_rank0(value: float) -> float:
    """Rank 0's ``value`` on every rank of the world (``value`` itself
    without a process group): a host broadcast over the default group,
    counted in :data:`COMM` as "broadcast", over every axis."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value

    def broadcast(h):
        dist.broadcast(h, src=0)
        return h
    return float(_run(torch.tensor([value], dtype=torch.float64), broadcast,
                      "broadcast", AXES)[0])


def _run(v: torch.Tensor, op: Callable[[torch.Tensor], torch.Tensor],
         kind: str, axis: Axis):
    """``op`` (a gloo collective on a host tensor this helper owns, which
    returns the host result) applied to ``v``, counted in ``COMM[kind]``
    and ``COMM_AXES[axis]``. A CUDA tensor is staged: the device's queued
    work is waited for, then ``v`` is copied into a pinned host buffer,
    the collective runs there and the result is copied back to ``v``'s
    device."""
    x = v.detach()
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    if x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
    else:
        host = x.clone(memory_format=torch.contiguous_format)
    out = op(host)
    if x.is_cuda:
        out = out.to(x.device)
    nbytes = (host.numel() + out.numel()) * host.element_size()
    dt = time.perf_counter() - t0
    for table, key in ((COMM, kind), (COMM_AXES, "+".join(_names(axis)))):
        count = table.setdefault(key, {"bytes": 0, "seconds": 0.0,
                                       "calls": 0})
        count["bytes"] += nbytes
        count["seconds"] += dt
        count["calls"] += 1
    return out


def reset_comm() -> None:
    COMM.clear()
    COMM_AXES.clear()


def _all_reduce(v, axes: MeshAxes, axis: Axis, op):
    group = _group(axes, axis)
    if group is None:
        return v

    def reduce(h):
        dist.all_reduce(h, op=op, group=group)
        return h
    return _run(v, reduce, "all_reduce", axis)


def psum(v, axes: MeshAxes, axis: Axis):
    """Sum over ``axis`` (a name or a tuple of names); every rank gets
    the same bits: gloo's all-reduce hands every rank the one result, and
    no rank recomputes it."""
    return _all_reduce(v, axes, axis, dist.ReduceOp.SUM)


def pmax(v, axes: MeshAxes, axis: Axis):
    return _all_reduce(v, axes, axis, dist.ReduceOp.MAX)


def all_gather(v, axes: MeshAxes, axis: Axis, *, dim: int):
    """The ranks' ``v`` concatenated along ``dim`` in the order of
    :func:`axis_index`: over a tuple, first-name-major, the order in which
    a PartitionSpec tuple shards a global dim."""
    group = _group(axes, axis)
    if group is None:
        return v
    n = axes.size(axis)

    def gather(h):
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        out = torch.empty((*h.shape[:dim % h.dim()],
                           n * h.shape[dim], *h.shape[dim % h.dim() + 1:]),
                          dtype=h.dtype, pin_memory=h.is_pinned())
        return torch.cat(parts, dim, out=out)
    return _run(v, gather, "all_gather", axis)


def psum_scatter(v, axes: MeshAxes, axis: Axis, *, dim: int):
    """Sum over ``axis``, then this rank's contiguous 1/n of ``dim`` (block
    :func:`axis_index`): the transpose of :func:`all_gather`. It runs as an
    all-reduce followed by the rank's slice (gloo's reduce-scatter differs
    across versions), so every rank's block has the same bits as on the
    other ranks."""
    group = _group(axes, axis)
    if group is None:
        return v
    n, r = axes.size(axis), axis_index(axes, axis)
    if v.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of size {v.shape[dim]} "
                         f"not divisible by {n}")

    def reduce_scatter(h):
        dist.all_reduce(h, group=group)
        return h.chunk(n, dim)[r].contiguous()
    return _run(v, reduce_scatter, "psum_scatter", axis)


def axis_index(axes: MeshAxes, axis: Axis, rank: Optional[int] = None
               ) -> int:
    """The index of ``rank`` (default: this process) along ``axis``; over
    a tuple first-name-major, as the JAX ``axis_index``."""
    names = _names(axis)
    if axes.size(axis) == 1:
        return 0
    c = axes.coords(process_rank() if rank is None else rank)
    idx = 0
    for n in names:
        i = AXES.index(n)
        idx = idx * axes.sizes[i] + c[i]
    return idx


def shard(v: torch.Tensor, axes: MeshAxes, spec, rank: Optional[int] = None
          ) -> torch.Tensor:
    """The block of the global ``v`` that ``rank`` (default: this process)
    holds under ``spec`` (one axis, tuple of axes or None per dim, as a
    PartitionSpec): dim i split into ``size(spec[i])`` blocks, block
    ``axis_index(spec[i])``. A view."""
    if len(spec) != v.dim():
        raise ValueError(f"spec {spec} for a tensor of shape "
                         f"{tuple(v.shape)}")
    for i, axis in enumerate(spec):
        n = axes.size(axis)
        if n == 1:
            continue
        if v.shape[i] % n:
            raise ValueError(f"dim {i} of size {v.shape[i]} does not shard "
                             f"over {axis!r} of size {n}")
        v = v.chunk(n, i)[axis_index(axes, axis, rank)]
    return v


def local_shape(shape, axes: MeshAxes, spec) -> Tuple[int, ...]:
    """The shape of a rank's block of a global ``shape`` under ``spec``
    (as :func:`shard`)."""
    out = []
    for i, (s, axis) in enumerate(zip(shape, spec, strict=True)):
        n = axes.size(axis)
        if s % n:
            raise ValueError(f"dim {i} of size {s} does not shard over "
                             f"{axis!r} of size {n}")
        out.append(s // n)
    return tuple(out)


def batch_shard(v, axes: MeshAxes, *, dim: int = 0):
    """This rank's rows of a global batch: block ``axis_index((data,
    z))`` of ``dim``, first-name-major, as the JAX step's batch spec
    shards it. A view; the identity with one batch shard."""
    n = axes.batch_shards
    if n == 1:
        return v
    if v.shape[dim] % n:
        raise ValueError(f"a batch of {v.shape[dim]} rows does not split "
                         f"over {n} batch shards (data x z)")
    return v.chunk(n, dim)[axis_index(axes, axes.batch_axes())]


def stripe_seq(v: torch.Tensor, p: int, *, dim: int = 1) -> torch.Tensor:
    """Permute a global sequence dim into the striped context-parallel
    layout: contiguous shard r of the result holds global positions ``r,
    r + p, r + 2p, ...`` (``result[r*C + j] == v[j*p + r]``, ``C = T //
    p``), so each rank's causal work spans the whole sequence. Identity
    at p == 1."""
    if p <= 1:
        return v
    dim = dim % v.dim()
    t = v.shape[dim]
    if t % p:
        raise ValueError(f"stripe_seq: dim {dim} of size {t} not "
                         f"divisible by g_seq {p}")
    shape = v.shape[:dim] + (t // p, p) + v.shape[dim + 1:]
    return v.reshape(shape).transpose(dim, dim + 1).reshape(v.shape)


def unstripe_seq(v: torch.Tensor, p: int, *, dim: int = 1) -> torch.Tensor:
    """Inverse of :func:`stripe_seq` (``result[j*p + r] == v[r*C + j]``)."""
    if p <= 1:
        return v
    dim = dim % v.dim()
    t = v.shape[dim]
    if t % p:
        raise ValueError(f"unstripe_seq: dim {dim} of size {t} not "
                         f"divisible by g_seq {p}")
    shape = v.shape[:dim] + (p, t // p) + v.shape[dim + 1:]
    return v.reshape(shape).transpose(dim, dim + 1).reshape(v.shape)


def seq_shard(v: torch.Tensor, axes: MeshAxes, *, dim: int = 1):
    """This rank's contiguous 1/g_seq of ``dim`` (of a striped global
    tensor: the rank's stripe)."""
    p = axes.gseq
    if p == 1:
        return v
    return v.chunk(p, dim)[axis_index(axes, "seq")]
