"""Mesh axes of the 4D hybrid algorithm (port of ``repro.core.mesh``).

The paper decomposes the devices as ``G_data x G_x x G_y x G_z``;
context parallelism adds a fifth factor ``G_seq``. The port admits a
factor above 1 on the seq axis only. A factor above 1 on data, x, y or z
raises ``NotImplementedError``: it is the ROADMAP.md §1 item "multi-rank
mesh".

A collective over an axis of size 1 is the identity (rank 0 for
``axis_index``), exactly as the JAX helpers degrade on an unmapped axis.
Over a seq axis of size above 1 it runs over ``torch.distributed``'s
default group, which is then the seq group: with every other factor 1 the
world is the seq axis (``launch/mesh.py`` checks that the world size is
the mesh's product). The backend is gloo. A CUDA tensor is staged
through pinned host memory in one helper (:func:`_run`), which counts,
for each kind of collective, the bytes it hands to gloo and takes back
and the host-clock seconds it spends (:data:`COMM`).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("data", "x", "y", "z", "seq")
Axis = Union[str, Tuple[str, ...], None]

# seq-axis communication of this process by kind of collective
# ("all_reduce", "all_gather", "psum_scatter"): {"bytes": handed to and
# taken back from gloo, "seconds": host clock in the collective, staging
# and any wait for the other ranks included}
COMM: Dict[str, Dict[str, float]] = {}


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
        if any(s != 1 for s in sizes[:4]):
            raise NotImplementedError(
                f"mesh {sizes}: the PyTorch port runs a factor above 1 on "
                f"the seq axis only; data, x, y and z above 1 wait for the "
                f"ROADMAP.md §1 item 'multi-rank mesh'")

    def size(self, axis: Axis) -> int:
        return math.prod(self.sizes[AXES.index(a)] for a in _names(axis))

    @property
    def gy(self) -> int:
        return self.size("y")

    @property
    def gseq(self) -> int:
        return self.size("seq")

    @property
    def batch_shards(self) -> int:
        """How many ways the batch is split (data x z)."""
        return self.size(("data", "z"))

    @property
    def token_shards(self) -> int:
        """How many ways the token grid (batch x seq) is split."""
        return self.batch_shards * self.gseq

    @staticmethod
    def token_axes() -> Tuple[str, ...]:
        """Axes the token grid is sharded over (batch axes + seq): the
        reduction set of per-token sums like the LM loss."""
        return ("data", "z", "seq")


def _names(axis) -> Tuple[str, ...]:
    """An axis name, a tuple of names or None (no axis) as a tuple."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(axes: MeshAxes, axis: Axis):
    """The process group of ``axis``, or None when it has one rank."""
    n = axes.size(axis)
    if n == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"a collective over {axis!r} of size {n} needs the mesh's "
            f"process group: run under torch.distributed.run and call "
            f"launch.mesh.init_mesh first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"axis {axis!r} has {n} ranks, the process "
                           f"group {dist.get_world_size()}")
    return dist.group.WORLD


def _run(v: torch.Tensor, op: Callable[[torch.Tensor], torch.Tensor],
         kind: str):
    """``op`` (a gloo collective on a host tensor this helper owns, which
    returns the host result) applied to ``v``, counted in ``COMM[kind]``.
    A CUDA tensor is staged: the device's queued work is waited for, then
    ``v`` is copied into a pinned host buffer, the collective runs there
    and the result is copied back to ``v``'s device."""
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
    count = COMM.setdefault(kind, {"bytes": 0, "seconds": 0.0})
    count["bytes"] += (host.numel() + out.numel()) * host.element_size()
    count["seconds"] += time.perf_counter() - t0
    return out


def reset_comm() -> None:
    COMM.clear()


def _all_reduce(v, axes: MeshAxes, axis: Axis, op):
    group = _group(axes, axis)
    if group is None:
        return v

    def reduce(h):
        dist.all_reduce(h, op=op, group=group)
        return h
    return _run(v, reduce, "all_reduce")


def psum(v, axes: MeshAxes, axis: Axis):
    """Sum over ``axis`` (a name or a tuple of names); every rank gets
    the same bits."""
    return _all_reduce(v, axes, axis, dist.ReduceOp.SUM)


def pmax(v, axes: MeshAxes, axis: Axis):
    return _all_reduce(v, axes, axis, dist.ReduceOp.MAX)


def all_gather(v, axes: MeshAxes, axis: Axis, *, dim: int):
    """The ranks' ``v`` concatenated along ``dim`` in rank order."""
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
    return _run(v, gather, "all_gather")


def psum_scatter(v, axes: MeshAxes, axis: Axis, *, dim: int):
    """Sum over ``axis``, then this rank's contiguous 1/n of ``dim``: the
    transpose of :func:`all_gather`. It runs as an all-reduce followed by
    the rank's slice (gloo's reduce-scatter differs across versions), so
    every rank's block has the same bits as on the other ranks."""
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
    return _run(v, reduce_scatter, "psum_scatter")


def axis_index(axes: MeshAxes, axis: Axis) -> int:
    group = _group(axes, axis)
    return 0 if group is None else dist.get_rank(group)


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
