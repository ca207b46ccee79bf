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

The ring helpers of the overlapped schedule (:func:`ppermute_ring`,
:func:`ring_all_gather`, :func:`ring_reduce_scatter`,
:func:`ring_all_reduce`, :func:`ring_all_to_all`) move blocks one hop at
a time with :class:`Hop`, which does not go through :func:`_run`: it
stages a CUDA block on a side stream after an event, so the compute stream
runs on while the block crosses gloo (kind "ppermute"; its seconds are the
host's time blocked in the hop, the exposed part). :func:`all_to_all` is
the blocking form of the MoE dispatch's exchange (kind "all_to_all").
:class:`GatherAsync` posts a whole all-gather at once and completes it
later (ZeRO-3's prefetch).

With tracing on (``core/trace.py``) the ring helpers open the reference's
scopes: ``ring_ag[axis]/hop{s}``, ``ring_rs[axis]/hop{s}`` and
``ring_rs[axis]/local``, ``ring_ar[axis]/exchange`` (p == 2) and
``ring_ar[axis]``, ``a2a[axis]`` and ``ring_a2a[axis]/shift{s}``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import trace
from repro_torch.core.overlap import OverlapConfig

AXES = ("data", "x", "y", "z", "seq")
Axis = Union[str, Tuple[str, ...], None]

# this process's communication by kind of collective ("all_reduce",
# "all_gather", "psum_scatter", "all_to_all", "broadcast", and "ppermute"
# for a ring hop), and by axis (its names joined by "+"):
# {"bytes": handed to and taken back from gloo, "seconds": host clock in
# the collective, staging and any wait for the other ranks included,
# "calls"}
COMM: Dict[str, Dict[str, float]] = {}
COMM_AXES: Dict[str, Dict[str, float]] = {}
# the ring hops alone ("ppermute"), by axis: COMM_AXES less HOPS is the
# blocking collectives by axis
HOPS: Dict[str, Dict[str, float]] = {}

# the process group of each set of axes above size 1 that this rank
# belongs to, keyed by those axes in mesh order (``init_groups``)
_GROUPS: Dict[Tuple[str, ...], object] = {}
# the global ranks of each of those groups, ascending: ring position i is
# the rank at index i (first-name-major over a tuple, as ``axis_index``)
_RANKS: Dict[Tuple[str, ...], List[int]] = {}
# the tag of each group's next hop: every rank of a group posts its hops
# in one order, so a hop's send and receive meet by tag
_HOP_TAGS: Dict[Tuple[str, ...], int] = {}
# the kind of collective that :func:`_run` is counting on this thread
# while its gloo call runs (``_TALLY.kind``; :func:`counting`)
_TALLY = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axes with their sizes (g_data, g_x, g_y, g_z[, g_seq]); a
    4-tuple means g_seq = 1. ``overlap`` holds the overlapped schedule's
    switches (``core/overlap.py``), read by the tp primitives and
    ``seq_attn``; the steps bind it with :meth:`with_overlap`."""

    sizes: Tuple[int, ...] = (1, 1, 1, 1)
    overlap: OverlapConfig = OverlapConfig()

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

    def with_overlap(self, overlap: OverlapConfig) -> "MeshAxes":
        return dataclasses.replace(self, overlap=overlap)

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
    clear_groups()
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
                    _RANKS[names] = group_ranks


def clear_groups() -> None:
    _GROUPS.clear()
    _RANKS.clear()
    _HOP_TAGS.clear()


def save_groups() -> tuple:
    """This rank's group tables (the groups :func:`init_groups` made, their
    ranks and their hop tags) as they stand, for :func:`restore_groups`: a
    caller that runs several meshes in one world makes each mesh's groups
    once and switches between them."""
    return dict(_GROUPS), dict(_RANKS), dict(_HOP_TAGS)


def restore_groups(saved: tuple) -> None:
    """Make ``saved`` (:func:`save_groups`) this rank's group tables."""
    clear_groups()
    for table, entries in zip((_GROUPS, _RANKS, _HOP_TAGS), saved):
        table.update(entries)


def group_axis(group) -> Optional[str]:
    """The axes of the process group ``group`` as :data:`COMM_AXES` keys
    them (names joined by "+"; every axis for the default group), or None
    for a group the mesh did not make."""
    for names, g in _GROUPS.items():
        if g is group:
            return "+".join(names)
    if dist.is_initialized() and group is dist.group.WORLD:
        return "+".join(AXES)
    return None


def counting() -> Optional[str]:
    """The kind of collective under which :func:`_run` counts the gloo
    call running on this thread (None outside :func:`_run`: a ring hop or
    a posted gather, which count themselves)."""
    return getattr(_TALLY, "kind", None)


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
    _TALLY.kind = kind
    try:
        out = op(host)
    finally:
        _TALLY.kind = None
    if x.is_cuda:
        out = out.to(x.device)
    _count(kind, axis, (host.numel() + out.numel()) * host.element_size(),
           time.perf_counter() - t0)
    return out


def _count(kind: str, axis: Axis, nbytes: int, seconds: float) -> None:
    key = "+".join(_names(axis))
    tables = [(COMM, kind), (COMM_AXES, key)]
    if kind == "ppermute":
        tables.append((HOPS, key))
    for table, key in tables:
        count = table.setdefault(key, {"bytes": 0, "seconds": 0.0,
                                       "calls": 0})
        count["bytes"] += nbytes
        count["seconds"] += seconds
        count["calls"] += 1


def reset_comm() -> None:
    COMM.clear()
    COMM_AXES.clear()
    HOPS.clear()


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


def all_to_all(v, axes: MeshAxes, axis: Axis, *, dim: int = 0):
    """Blocking all-to-all over ``axis``: ``dim`` (p equal blocks, block k
    destined for ring position k) is exchanged so that the result's block
    k holds what position k sent here, the MoE dispatch/combine primitive
    (gloo's ``all_to_all_single`` over ``dim`` moved to the front). The
    identity on an axis of one rank."""
    group = _group(axes, axis)
    if group is None:
        return v
    n = axes.size(axis)
    dim %= v.dim()
    if v.shape[dim] % n:
        raise ValueError(f"all_to_all: dim {dim} of size {v.shape[dim]} "
                         f"not divisible by {n}")

    def exchange(h):
        front = h.movedim(dim, 0).contiguous()
        out = torch.empty_like(front)
        dist.all_to_all_single(out, front, group=group)
        return out.movedim(0, dim).contiguous()
    with trace.scope("a2a", axis):
        return _run(v, exchange, "all_to_all", axis)


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


# ---------------------------------------------------------------------- #
# ring hops: the overlapped schedule's collectives
# ---------------------------------------------------------------------- #

_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream on which hops copy their blocks to and from ``device``."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _SIDE_STREAMS[index]


class Hop:
    """One ring hop in flight over ``axis``: this rank's ``v`` goes to ring
    position (i + shift) mod p, and a block of its shape and dtype comes
    from position (i - shift) mod p (ring positions in the order of
    :func:`axis_index`, the group's ascending ranks). :meth:`wait` returns
    the block received, on v's device.

    A CUDA ``v`` is copied into pinned host memory on a side stream that
    waits for the work queued so far, so the caller can queue its next
    kernel (the hop's GEMM) before :meth:`wait`; the send and receive are
    posted (gloo's ``isend``/``irecv``, which run on gloo's threads) once
    the copy is done, and the received block is copied back on the side
    stream, which the compute stream then waits for. ``host``: a host copy
    of ``v`` already made (the block a previous hop received), sent as it
    is and posted at once. A CPU ``v`` is posted at once.

    Counted in :data:`COMM` as "ppermute" and in :data:`COMM_AXES` by
    axis: one call, the bytes sent and received, and the seconds the host
    was blocked in the hop (waiting for the staging copy and for gloo),
    the part of the hop that no compute hid. With tracing on, the send and
    receive are posted under the trace scopes open where the hop was made
    (``trace.restored``), also when :meth:`wait` posts them inside a later
    hop's scope."""

    def __init__(self, v: torch.Tensor, axes: MeshAxes, axis: Axis,
                 shift: int = 1, *, host: Optional[torch.Tensor] = None):
        group = _group(axes, axis)
        if group is None:
            raise ValueError(f"a hop over {axis!r} of one rank")
        names = _live(axes, axis)
        ranks = _RANKS[names]
        p, i = len(ranks), axis_index(axes, axis)
        self.group, self.axis, self.device = group, axis, v.device
        self.dst = ranks[ring_perm(p, shift)[i][1]]
        self.src = ranks[ring_perm(p, -shift)[i][1]]
        self.tag = _HOP_TAGS.get(names, 0)
        _HOP_TAGS[names] = (self.tag + 1) % (1 << 30)
        self.seconds, self.works, self.staged = 0.0, None, None
        self.scopes = trace.snapshot() if trace.enabled() else None
        cuda = v.is_cuda
        if host is not None:
            self.send = host
        elif cuda:
            side = _side_stream(v.device)
            side.wait_stream(torch.cuda.current_stream(v.device))
            self.send = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            with torch.cuda.stream(side):
                self.send.copy_(v.detach(), non_blocking=True)
                self.staged = torch.cuda.Event()
                self.staged.record(side)
            v.record_stream(side)
        else:
            self.send = v.detach().contiguous()
        self.recv = torch.empty(self.send.shape, dtype=self.send.dtype,
                                pin_memory=cuda)
        if self.staged is None:
            self._post()

    def _post(self) -> None:
        t0 = time.perf_counter()
        if self.staged is not None:
            self.staged.synchronize()
        if self.scopes is None:
            self.works = self._isend_irecv()
        else:
            with trace.restored(self.scopes):
                self.works = self._isend_irecv()
        self.seconds += time.perf_counter() - t0

    def _isend_irecv(self):
        return [
            dist.isend(self.send, self.dst, group=self.group, tag=self.tag),
            dist.irecv(self.recv, self.src, group=self.group, tag=self.tag)]

    def wait(self) -> torch.Tensor:
        if self.works is None:
            self._post()
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.seconds += time.perf_counter() - t0
        _count("ppermute", self.axis,
               2 * self.send.numel() * self.send.element_size(), self.seconds)
        if self.device.type != "cuda":
            return self.recv
        side = _side_stream(self.device)
        with torch.cuda.stream(side):
            out = self.recv.to(self.device, non_blocking=True)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(side)
        out.record_stream(compute)
        return out


class GatherAsync:
    """:func:`all_gather` of ``v`` over ``axis`` along its last dim,
    posted now and completed by :meth:`wait`, so the caller computes while
    gloo's threads move the blocks (ZeRO-3's prefetch). ``ring``: each rank
    sends its block to, and receives a block from, every other rank of
    the axis, all posted at once (``isend``/``irecv`` under one tag of
    the group's hop counter): the bytes of :func:`ring_all_gather`'s p - 1
    hops, counted as p - 1 "ppermute" calls. Otherwise one gloo
    ``all_gather`` work handle, counted as "all_gather" as :func:`_run`
    counts it. A CUDA ``v`` is copied to the host first, after the work
    queued on its stream. After :meth:`wait`, :attr:`host` holds the
    gathered tensor on the host (``wait(device=False)`` returns it there);
    the seconds counted are the host's time posting and blocked in
    :meth:`wait`."""

    def __init__(self, v: torch.Tensor, axes: MeshAxes, axis: Axis, *,
                 ring: bool = True):
        t0 = time.perf_counter()
        self.axis, self.device, self.ring = axis, v.device, ring
        self.p, self.host = axes.size(axis), None
        self.send = (v.detach().to("cpu") if v.is_cuda
                     else v.detach().contiguous())
        group, self.works = _group(axes, axis), []
        if group is None:
            self.parts = [self.send]
        elif ring:
            names = _live(axes, axis)
            ranks, i = _RANKS[names], axis_index(axes, axis)
            tag = _HOP_TAGS.get(names, 0)
            _HOP_TAGS[names] = (tag + 1) % (1 << 30)
            self.parts = [self.send if j == i else torch.empty_like(self.send)
                          for j in range(self.p)]
            peers = [j for j in range(self.p) if j != i]
            self.works = (
                [dist.isend(self.send, ranks[j], group=group, tag=tag)
                 for j in peers]
                + [dist.irecv(self.parts[j], ranks[j], group=group, tag=tag)
                   for j in peers])
        else:
            self.parts = [torch.empty_like(self.send) for _ in range(self.p)]
            self.works = [dist.all_gather(self.parts, self.send, group=group,
                                          async_op=True)]
        self.seconds = time.perf_counter() - t0

    def wait(self, device: bool = True) -> torch.Tensor:
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.host = torch.cat(self.parts, dim=-1)
        self.seconds += time.perf_counter() - t0
        nbytes = self.send.numel() * self.send.element_size()
        if self.p > 1 and self.ring:
            for k in range(self.p - 1):
                _count("ppermute", self.axis, 2 * nbytes,
                       self.seconds if k == 0 else 0.0)
        elif self.p > 1:
            _count("all_gather", self.axis, (1 + self.p) * nbytes,
                   self.seconds)
        return self.host.to(self.device) if device else self.host


def ring_perm(p: int, shift: int = 1):
    """The send-right ring permutation (rank i -> i + shift mod p): after
    ``s`` hops rank ``i`` holds the block that rank ``(i - s) mod p``
    started with."""
    return [(i, (i + shift) % p) for i in range(p)]


def flat_ring_axis(axes: MeshAxes, axis: Axis):
    """(p, names) of the ring over ``axis``: a tuple of names forms one
    ring over the first-name-major flattening, the layout of
    :func:`all_gather` and :func:`psum_scatter`."""
    return axes.size(axis), _names(axis)


def flat_ring_index(axes: MeshAxes, axis: Axis) -> int:
    """This rank's position on the flattened ring."""
    return axis_index(axes, axis)


def ppermute_ring(v, axes: MeshAxes, axis: Axis, shift: int = 1):
    """One ring hop: ``v`` sent to position (i + shift) mod p, the block
    of (i - shift) mod p returned. The identity on an axis of one rank."""
    if axes.size(axis) == 1:
        return v
    return Hop(v, axes, axis, shift).wait()


def _posted(under: Optional[Callable[[], object]]) -> None:
    """Run ``under`` (work independent of the ring, queued once the ring's
    first hop is posted, so that its staging copy is not queued behind
    it), if given."""
    if under is not None:
        under()


def ring_all_gather(v, axes: MeshAxes, axis: Axis, *, dim: int,
                    under: Optional[Callable[[], object]] = None):
    """:func:`all_gather` as p - 1 ring hops, the same blocks in the same
    places (bitwise). Each hop is posted before the block it forwards is
    placed, and a received block is forwarded from host memory. ``under``
    is called once, after the first hop is posted (the calibration's
    overlap probes queue their GEMM there)."""
    p = axes.size(axis)
    if p == 1:
        _posted(under)
        return v
    dim %= v.dim()
    idx, chunk = axis_index(axes, axis), v.shape[dim]
    out = v.new_empty((*v.shape[:dim], p * chunk, *v.shape[dim + 1:]))
    cur, host = v, None
    for s in range(p):
        with trace.scope("ring_ag", axis, f"hop{s}"):
            hop = Hop(cur, axes, axis, host=host) if s < p - 1 else None
            if s == 0:
                _posted(under)
            out.narrow(dim, ((idx - s) % p) * chunk, chunk).copy_(cur)
            if hop is not None:
                cur, host = hop.wait(), hop.recv
    return out


def ring_reduce_scatter(v, axes: MeshAxes, axis: Axis, *, dim: int,
                        under: Optional[Callable[[], object]] = None):
    """:func:`psum_scatter` as p - 1 ring hops: the partial sum for block
    j passes through every rank, which adds its slice (``recv + g``), and
    ends at rank j. Raises where ``dim`` does not split over p. ``under``
    as in :func:`ring_all_gather`."""
    p = axes.size(axis)
    if p == 1:
        _posted(under)
        return v
    dim %= v.dim()
    if v.shape[dim] % p:
        raise ValueError(f"ring_reduce_scatter: dim {dim} of size "
                         f"{v.shape[dim]} not divisible by {p}")
    idx, chunk = axis_index(axes, axis), v.shape[dim] // p

    def block(s):      # the slice that leaves this rank at step s
        return v.narrow(dim, ((idx - s) % p) * chunk, chunk)
    part = block(1)
    for s in range(1, p):
        with trace.scope("ring_rs", axis, f"hop{s - 1}"):
            hop = Hop(part, axes, axis)
            if s == 1:
                _posted(under)
            recv = hop.wait()
            if s < p - 1:
                part = recv + block(s + 1)
    with trace.scope("ring_rs", axis, "local"):
        return recv + block(0)


def ring_all_reduce(v, axes: MeshAxes, axis: Axis, *, dim: int = -1,
                    under: Optional[Callable[[], object]] = None):
    """:func:`psum` as a reduce-scatter ring and an all-gather ring over
    ``dim``, 2 (p - 1) hops. p == 2 is one exchange, ``v + recv``,
    bitwise the psum (two addends commute). Falls back to the blocking
    psum where ``dim`` does not split over p; the identity on an axis of
    one rank. ``under`` as in :func:`ring_all_gather`."""
    p = axes.size(axis)
    if p == 1:
        _posted(under)
        return v
    if p == 2:
        with trace.scope("ring_ar", axis, "exchange"):
            hop = Hop(v, axes, axis)
            _posted(under)
            return v + hop.wait()
    dim %= v.dim()
    if v.shape[dim] % p:
        out = psum(v, axes, axis)
        _posted(under)
        return out
    with trace.scope("ring_ar", axis):
        return ring_all_gather(ring_reduce_scatter(v, axes, axis, dim=dim,
                                                   under=under), axes,
                               axis, dim=dim)


def ring_all_to_all(v, axes: MeshAxes, axis: Axis, *, dim: int = 0):
    """:func:`all_to_all` as p - 1 pairwise hops: shift s sends this rank's
    block destined s positions ahead straight there (``Hop(..., shift=s)``)
    and places the block from s positions behind, the same blocks in the
    same places as the blocking exchange (bitwise: each block travels once
    either way). Every hop is posted before the first is waited for (each
    group posts its hops in one order, so their tags meet). Falls back to
    the blocking :func:`all_to_all` where ``dim`` does not split over p;
    the identity on an axis of one rank."""
    p = axes.size(axis)
    if p == 1:
        return v
    dim %= v.dim()
    if v.shape[dim] % p:
        return all_to_all(v, axes, axis, dim=dim)
    idx, chunk = axis_index(axes, axis), v.shape[dim] // p

    def block(j):
        return v.narrow(dim, j * chunk, chunk)
    hops = []
    for s in range(1, p):
        with trace.scope("ring_a2a", axis, f"shift{s}"):
            hops.append(Hop(block((idx + s) % p), axes, axis, shift=s))
    out = torch.empty_like(v)
    out.narrow(dim, idx * chunk, chunk).copy_(block(idx))
    for s, hop in enumerate(hops, start=1):
        with trace.scope("ring_a2a", axis, f"shift{s}"):
            out.narrow(dim, ((idx - s) % p) * chunk, chunk).copy_(hop.wait())
    return out


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
