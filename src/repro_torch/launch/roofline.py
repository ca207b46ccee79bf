"""Collective accounting of the port (counterpart of the HLO-free half of
``repro.launch.roofline``).

The reference reads its collectives from a compiled program's optimized
HLO (``parse_collective_ops``). The port has no compiled program: it
issues each collective when it runs. :func:`record_collectives` takes the
HLO's place. It is a ``TorchDispatchMode`` that sees every ``c10d`` op
that this thread (and autograd's threads, which inherit the mode) sends
to the process groups, records it as a :class:`CollectiveOp` and passes
every op through untouched:

    allreduce_                         -> all-reduce
    allgather_, _allgather_base_       -> all-gather
    reduce_scatter_, _reduce_scatter_base_ -> reduce-scatter
    alltoall_base_                     -> all-to-all
    send (a ring hop; its recv_ is not counted again)
                                       -> collective-permute
    broadcast_, barrier                -> their own names (no HLO has them)

Each op keeps its process group's size (ops of one rank are dropped, as
the reference drops them), its raw bytes (the reference's: an
all-gather's result, a reduce-scatter's shard, a hop's block), its wire
bytes by the reference's bandwidth-optimal factors, the trace scope in
force (``core/trace.current()``; a hop's is the scope it was made in,
``mesh.Hop``), its mesh axes (``mesh.group_axis``) and the kind under
which ``core/mesh.py``'s own tally counts it, where that tally says
(``mesh.counting``: ``psum_scatter`` runs gloo's all-reduce).
:func:`collective_stats` is the counterpart of ``parse_collectives``,
:func:`by_scope` splits calls and bytes by scope class, and
:func:`mesh_totals` restates the ops in ``mesh.COMM``'s terms, so that
the two tallies are held to each other.

The hook puts Python on every aten op, so it is on only where asked:
``train.py --profile-steps``'s window, or a test.

:func:`step_time_estimate` and :func:`model_flops_per_device` are the
reference's, except that the hardware constants are required: the port
states no TPU rate as its own, so ``hw`` comes from a calibration profile
(``core/calibrate.py``'s ``hardware_params()``) or from the caller.
``analyze`` and ``memory_summary``, which read an XLA executable, have no
counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import comm_model as CM
from repro_torch.core import mesh as M
from repro_torch.core import trace

# what the step-time estimate treats as overlappable: the ring-decomposed
# collectives (the z weight rings, the x/y activation all-reduce rings and
# the data-parallel bucket rings), which run as chains of hops beside
# compute; everything else blocks
OVERLAPPABLE_COLLECTIVES = ("collective-permute",)

# c10d op -> the HLO kind the reference's parser names it (recv_: the
# other half of a hop, counted with its send)
C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "broadcast",
    "barrier": "barrier",
}
NOT_COUNTED = ("recv_",)
# an HLO kind -> the kind mesh.COMM counts it under
MESH_KINDS = {"all-reduce": "all_reduce", "all-gather": "all_gather",
              "collective-permute": "ppermute", "all-to-all": "all_to_all",
              "broadcast": "broadcast"}
# the argument of each op whose bytes are the op's raw bytes
_RAW_ARG = {"allreduce_": "tensors", "allgather_": "output_tensors",
            "_allgather_base_": "output_tensor",
            "reduce_scatter_": "output_tensors",
            "_reduce_scatter_base_": "output_tensor",
            "alltoall_base_": "input", "send": "tensors",
            "broadcast_": "tensors"}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]   # effective per-device wire bytes

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective the port issued: op kind, process group size, raw
    bytes and the bandwidth-optimal effective per-device wire bytes (the
    reference's fields); then the trace scope in force (None outside
    every scope), the group's mesh axes (names joined by "+") and the kind
    ``core/mesh.py``'s tally counts it under where that tally said so."""

    kind: str
    group_size: int
    raw_bytes: int
    wire_bytes: float
    scope: Optional[str] = None
    axis: Optional[str] = None
    tally: Optional[str] = None


def wire_bytes(kind: str, p: int, nbytes: int) -> float:
    """The reference's effective per-device wire bytes of one op of
    ``kind`` over ``p`` ranks moving ``nbytes`` raw bytes; a broadcast
    its bytes, a barrier none."""
    if kind == "all-reduce":
        return 2.0 * (p - 1) / p * nbytes
    if kind == "all-gather":
        return (p - 1) / p * nbytes          # result-shaped
    if kind == "reduce-scatter":
        return (p - 1) * nbytes              # result is the 1/p shard
    if kind == "all-to-all":
        return (p - 1) / p * nbytes
    if kind == "barrier":
        return 0.0
    return float(nbytes)                     # collective-permute


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _record(func, args, kwargs) -> Optional[CollectiveOp]:
    """The :class:`CollectiveOp` of one c10d call, None for one not
    counted (a hop's receive; a group of one rank)."""
    name = func._opname
    if name in NOT_COUNTED:
        return None
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    group = bound.get("process_group")
    group = dist.ProcessGroup.unbox(group) if group is not None else None
    p = group.size() if group is not None else 1
    if p <= 1:
        return None
    kind = C10D_KINDS.get(name, name)
    raw = _nbytes(bound.get(_RAW_ARG.get(name), [
        v for v in bound.values() if isinstance(v, (torch.Tensor, list))]))
    if kind == "barrier":
        raw = 0
    return CollectiveOp(kind, p, raw, wire_bytes(kind, p, raw),
                        trace.current(), M.group_axis(group), M.counting())


class _Recorder(TorchDispatchMode):
    def __init__(self, ops: List[CollectiveOp]):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            op = _record(func, args, kwargs)
            if op is not None:
                self.ops.append(op)
        return func(*args, **kwargs)


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued inside the block: yields the list
    that each :class:`CollectiveOp` is appended to, in issue order."""
    ops: List[CollectiveOp] = []
    with _Recorder(ops):
        yield ops


def collective_stats(ops: Iterable[CollectiveOp]) -> CollectiveStats:
    """Counts and wire bytes by kind (``parse_collectives``' result)."""
    counts: Dict[str, int] = {}
    vol: Dict[str, float] = {}
    for op in ops:
        counts[op.kind] = counts.get(op.kind, 0) + 1
        vol[op.kind] = vol.get(op.kind, 0.0) + op.wire_bytes
    return CollectiveStats(counts, vol)


def scope_class(name: Optional[str]) -> Optional[str]:
    """A scope label without its ``/detail``: ``ring_ag[z]/hop2`` ->
    ``ring_ag[z]``."""
    return None if name is None else name.split("/", 1)[0]


def by_scope(ops: Iterable[CollectiveOp], *, axis: bool = False
             ) -> Dict[Tuple, Dict[str, float]]:
    """Calls, raw and wire bytes by (scope class, kind, group size), and
    the mesh axes after them with ``axis``; ops outside every scope under
    the class None."""
    out: Dict[Tuple, Dict[str, float]] = {}
    for op in ops:
        key = (scope_class(op.scope), op.kind, op.group_size)
        if axis:
            key += (op.axis,)
        row = out.setdefault(key, {"calls": 0, "raw_bytes": 0,
                                   "wire_bytes": 0.0})
        row["calls"] += 1
        row["raw_bytes"] += op.raw_bytes
        row["wire_bytes"] += op.wire_bytes
    return out


def scope_rows(ops: Iterable[CollectiveOp]) -> List[dict]:
    """:func:`by_scope` with the axes, as JSON rows ({"scope", "kind",
    "group_size", "axis", "calls", "raw_bytes", "wire_bytes"}), sorted."""
    rows = by_scope(ops, axis=True)
    return [dict(scope=s, kind=k, group_size=p, axis=a, **v)
            for (s, k, p, a), v in sorted(
                rows.items(), key=lambda kv: tuple(str(x) for x in kv[0]))]


def mesh_bytes(op: CollectiveOp) -> float:
    """The bytes ``core/mesh.py``'s tally counts for ``op``: what it hands
    to gloo and takes back. A hop's block goes out and one comes in (2x
    raw), an all-reduce, all-to-all or broadcast returns its input (2x),
    an all-gather takes a 1/p block in for its result, and a
    ``psum_scatter`` (gloo's all-reduce, then the rank's 1/p) keeps the
    1/p."""
    p = op.group_size
    if op.kind == "all-gather" or op.tally == "psum_scatter":
        return op.raw_bytes * (p + 1) / p
    return 2.0 * op.raw_bytes


def mesh_totals(ops: Iterable[CollectiveOp]) -> Dict[str, Dict[str, float]]:
    """The ops in ``mesh.COMM``'s terms: {mesh kind: {"calls", "bytes"}}
    (:func:`mesh_bytes`); a kind the tally does not name keeps the
    op's."""
    out: Dict[str, Dict[str, float]] = {}
    for op in ops:
        kind = op.tally or MESH_KINDS.get(op.kind, op.kind)
        row = out.setdefault(kind, {"calls": 0, "bytes": 0.0})
        row["calls"] += 1
        row["bytes"] += mesh_bytes(op)
    return out


def step_time_estimate(flops: float, bytes_by_kind: Dict[str, float], *,
                       hw: CM.HardwareParams,
                       cross_step: bool = False) -> CM.StepTime:
    """Overlap-aware step-time estimate from recorded roofline terms.

    The analytic twin is ``comm_model.predict_step_time`` (closed-form
    shapes); this one prices the *measured* per-device collective bytes:
    collective-permute traffic (the ring-decomposed z weight collectives,
    x/y activation all-reduces and DP gradient/param-shard rings) hides
    under up to ``overlap_efficiency`` of the compute time, blocking
    collectives are fully exposed. ``cross_step`` additionally treats
    all-gather/reduce-scatter traffic as hideable — the cross-step
    window of ``comm_model.dp_sync_time`` where a step's terminal
    gathers ride under the next step's forward and the last
    reduce-scatter under the optimizer math."""
    compute_t = flops / hw.flops
    kinds = OVERLAPPABLE_COLLECTIVES
    if cross_step:
        kinds = kinds + ("all-gather", "reduce-scatter")
    hid_b = sum(v for k, v in bytes_by_kind.items() if k in kinds)
    exp_b = sum(v for k, v in bytes_by_kind.items() if k not in kinds)
    hid_t = hid_b / hw.link_bw
    hidden = min(hid_t, hw.overlap_efficiency * compute_t)
    exposed = exp_b / hw.link_bw + (hid_t - hidden)
    return CM.StepTime(compute_t, exposed, hidden)


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    """6*N_active*D for training, 2*N_active*D for prefill/decode,
    divided by device count (to compare with per-device HLO flops).
    The per-token factor is ``comm_model.model_flops_per_token`` — the
    same constant the telemetry MFU divides by."""
    per_tok = CM.model_flops_per_token(
        cfg, "train" if shape.kind == "train" else "serve")
    if shape.kind in ("train", "prefill"):
        total = per_tok * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = per_tok * shape.global_batch
    return total / n_devices
