"""Hardware calibration of the port: measured γ/α/β, GEMM rate and
overlap fits for the paper's analytical model (``core/comm_model.py``).

``comm_model.HardwareParams`` prices every collective as ``γ + steps · α
+ wire_bytes / link_bw`` and every GEMM as ``flops_needed / flops``; its
defaults are guessed TPU v5e constants. This module times the port's own
primitives on its own ranks, least-squares-fits the constants and saves
them as a :class:`CalibrationProfile`, which ``--calib <path|auto>`` on
``launch/train.py`` loads back into ``HardwareParams``
(``launch/calibrate.py`` is the command line).

The fitting half (:func:`collective_geometry`, :func:`fit_constants`, the
profile and its drift records, :func:`_hidden_fraction`,
:func:`spearman`) is a copy of the JAX package's ``core/calibrate.py``:
only its import of the comm model and :func:`default_path`'s backend (the
card's ``"cuda"`` or ``"cpu"``, from torch) differ, so profiles move
between the packages unchanged. The measuring half is the port's:

  * **Ranks are processes** (``torch.distributed`` over gloo, one process
    a rank; ``core/mesh.py``'s groups). Each timed repetition starts after
    a barrier of the world and ends after the card has synchronized; a
    sample is the max over ranks (a collective ends when its last rank
    does), then the min over repetitions, reduced over the world before
    the fit, so every rank fits the same constants.
  * **The harness floor** subtracted from every collective is the time of
    an empty timed region (synchronize and clock after the barrier).
  * **γ/α/β per axis** over six kinds: the ring all-gather,
    reduce-scatter and all-reduce of ``core/mesh.py``, the blocking
    ``psum`` (gloo's all-reduce, staged through pinned host memory on the
    card), ring attention's KV circulation (``ring_exchange``: p - 1 hops
    of a rank's block, each consumed) and ``ring_all_to_all``, over every
    mapped axis and the flattened ring of the first two, at each size of
    a sweep. Each sample is priced with the reference's geometry
    (:func:`collective_geometry`); :func:`ring_hops` is the hop count the
    port's code makes, which the timed calls count in ``mesh.HOPS``. They
    differ in two places: at p = 2 ``ring_all_reduce`` is one exchange of
    the whole buffer (the geometry: 2 hops of half of it, the same wire
    bytes), and ``psum`` is one blocking gloo call (no hop).
  * **GEMM rate**: kernel K1 (``kernels/ops.matmul``, fp32) at the
    reference's sizes, run on every rank at once as a step's ranks run.
    Where ranks share a card, the rate is one rank's share of it.
  * **Overlap and cross-step probes**: a ring and an independent K1 GEMM,
    apart and together. A hop's staging copy waits for the work already
    queued on the compute stream (``mesh.Hop``), so the ring's first hop
    is posted before the GEMM is queued (``under=`` of the ring helpers,
    the order ``core/collective_matmul.py`` uses); queued the other way
    round, no hop could hide.

Units: α in seconds per ring hop, γ in seconds per collective call, β in
seconds per wire byte (``link_bw = 1/β`` bytes/s), ``flops`` in FLOP/s,
efficiencies in [0, 1]. Where β fits to 0, ``link_bw`` is the bandwidth
the largest message reached (no TPU constant), and ``probes`` says so.
Profiles persist to ``runs/calib/<backend>.json``; ``resolve("auto")``
finds the live backend's file.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import comm_model as CM

DEFAULT_DIR = os.path.join("runs", "calib")

#: (kind -> (hop count, wire-byte factor)) as functions of ring size p and
#: the *full* buffer bytes, matching comm_model.collective_time's
#: conventions: all_reduce takes the reduced buffer, AG/RS the full one.
_KINDS = ("all_gather", "reduce_scatter", "all_reduce", "psum",
          "ring_exchange", "all_to_all")


def collective_geometry(kind: str, p: int, buf_bytes: float
                        ) -> Tuple[int, float]:
    """(ring hops, wire bytes) of one bandwidth-optimal collective —
    the regressor row of the α/β fit. ``psum`` is priced as the
    all-reduce it is (same wire bytes; the blocking lowering still pays
    per-hop latency on a ring topology). ``ring_exchange`` is the
    seq-axis KV circulation of ring attention (p-1 ppermute hops each
    forwarding the rank's 1/p block of ``buf_bytes``; note
    ``comm_model.collective_time`` takes the per-rank *block* for this
    kind while the harness here times the full buffer)."""
    if p <= 1:
        return 0, 0.0
    if kind in ("all_reduce", "psum"):
        return 2 * (p - 1), 2.0 * (p - 1) / p * buf_bytes
    if kind in ("all_gather", "reduce_scatter", "ring_exchange"):
        return p - 1, (p - 1) / p * buf_bytes
    if kind == "all_to_all":
        # MoE dispatch: every rank keeps its 1/p block and sends the
        # other (p-1)/p of the buffer, one pairwise exchange per hop
        return p - 1, (p - 1) / p * buf_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class Sample:
    """One timed collective: the fit's (steps, wire_bytes) -> seconds row."""

    kind: str
    axis: str
    p: int
    elems: int          # buffer elements (comm_model conventions)
    steps: int
    wire_bytes: float
    seconds: float

    def as_dict(self):
        return dataclasses.asdict(self)


def fit_constants(samples: Sequence[Sample]
                  ) -> Tuple[float, float, float, float]:
    """Least-squares (γ, α, β, R²) over
    ``t = γ + steps·α + wire_bytes·β`` (one call per sample).

    γ is the per-collective launch overhead (LogGP's ``o`` — hop-count
    independent), α the per-ring-hop latency, β seconds per wire byte.
    Identifiable when the samples span at least two distinct hop counts
    (AG/RS vs AR at one ring size already do; mixing ring sizes — the
    tuple-axis sweep of :func:`run_calibration` — sharpens it). Exact on
    noiseless synthetic data; negative solutions are clamped to 0 by
    coordinate re-solve — a fit cannot claim negative latency or
    bandwidth time."""
    rows = [s for s in samples if s.steps > 0]
    if len(rows) < 3:
        raise ValueError("need >= 3 samples with p > 1 to fit "
                         "gamma/alpha/beta")
    A = np.array([[1.0, s.steps, s.wire_bytes] for s in rows],
                 dtype=np.float64)
    t = np.array([s.seconds for s in rows], dtype=np.float64)
    sol, *_ = np.linalg.lstsq(A, t, rcond=None)
    if np.any(sol < 0.0):
        # re-solve with the negative coordinates pinned to zero
        keep = [i for i in range(3) if sol[i] > 0.0] or [2]
        sub, *_ = np.linalg.lstsq(A[:, keep], t, rcond=None)
        sol = np.zeros(3)
        for i, v in zip(keep, sub):
            sol[i] = max(float(v), 0.0)
    gamma, alpha, beta = (float(sol[0]), float(sol[1]), float(sol[2]))
    pred = A @ np.array([gamma, alpha, beta])
    ss_res = float(np.sum((t - pred) ** 2))
    ss_tot = float(np.sum((t - np.mean(t)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return gamma, alpha, beta, r2


@dataclasses.dataclass(frozen=True)
class AxisFit:
    """Fitted γ/α/β for one mesh-axis class (or a flattened tuple)."""

    axis: str
    p: int
    alpha: float        # seconds per ring hop
    beta: float         # seconds per wire byte (1/bandwidth)
    r2: float
    n_samples: int
    gamma: float = 0.0  # seconds per collective call

    @property
    def link_bw(self) -> float:
        return 1.0 / self.beta if self.beta > 0 else float("inf")

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Measured hardware constants, persistable and loadable into
    :class:`~repro.core.comm_model.HardwareParams`.

    ``alpha``/``link_bw``/``flops``/``overlap_efficiency`` are the
    aggregate fits the analytic model consumes; ``axis_fits`` keeps the
    per-axis-class α/β so per-axis pricing stays available to readers of
    the JSON (EXPERIMENTS.md §Calibration tabulates them)."""

    backend: str
    n_devices: int
    mesh_shape: Tuple[int, ...]
    alpha: float
    link_bw: float
    flops: float
    overlap_efficiency: float
    gamma: float = 0.0
    z_claims_first: bool = True
    cross_step_efficiency: float = 1.0
    bytes_per_elem: float = 2.0
    fit_r2: float = 0.0
    axis_fits: Tuple[AxisFit, ...] = ()
    probes: Dict[str, float] = dataclasses.field(default_factory=dict)
    samples: Tuple[Sample, ...] = ()
    created: str = ""

    # ------------------------------------------------------------------ #
    def hardware_params(self) -> CM.HardwareParams:
        """The fitted constants in the analytic model's terms."""
        return CM.HardwareParams(
            alpha=self.alpha, gamma=self.gamma, link_bw=self.link_bw,
            flops=self.flops, bytes_per_elem=self.bytes_per_elem,
            overlap_efficiency=self.overlap_efficiency,
            z_claims_first=self.z_claims_first,
            cross_step_efficiency=self.cross_step_efficiency)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape)
        d["axis_fits"] = [f.as_dict() for f in self.axis_fits]
        d["samples"] = [s.as_dict() for s in self.samples]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationProfile":
        kw = dict(d)
        kw["mesh_shape"] = tuple(kw.get("mesh_shape", ()))
        kw["axis_fits"] = tuple(AxisFit(**f) for f in kw.get("axis_fits", ()))
        kw["samples"] = tuple(Sample(**s) for s in kw.get("samples", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in known})

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def default_path(backend: Optional[str] = None) -> str:
    if backend is None:
        import torch
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    return os.path.join(DEFAULT_DIR, f"{backend}.json")


def resolve(spec: Optional[str]) -> Optional[CalibrationProfile]:
    """``--calib`` semantics: None -> None, 'auto' -> the live backend's
    ``runs/calib/<backend>.json`` if present (None otherwise — an
    uncalibrated run must keep working), else a profile path (must
    exist)."""
    if not spec:
        return None
    if spec == "auto":
        p = default_path()
        return CalibrationProfile.load(p) if os.path.exists(p) else None
    return CalibrationProfile.load(spec)


def resolve_hw(spec: Optional[str]) -> CM.HardwareParams:
    """HardwareParams for a ``--calib`` value; the TPU_V5E guesses when
    uncalibrated (the bitwise-unchanged degenerate point)."""
    prof = resolve(spec)
    return prof.hardware_params() if prof is not None else CM.TPU_V5E


def merge_drift(profile: CalibrationProfile, record: Dict
                ) -> CalibrationProfile:
    """Fold a telemetry drift record (``launch.telemetry.DriftMonitor
    .record()``) into the profile's ``probes``.

    Keyed per workload (``drift:<workload>``) so each (arch, mesh) run
    overwrites its own entry while ``drift_ratio`` tracks the latest
    aggregate. The fitted α/β/γ constants are deliberately NOT rescaled
    here — a drifting end-to-end ratio says the model is wrong for this
    workload, not which constant is wrong; the recorded ratio is the
    evidence a recalibration (benchmarks.calibrate) acts on, and readers
    of the JSON (dryrun/hillclimb) can surface it next to predictions."""
    for field in ("ratio", "predicted_s", "n"):
        if field not in record:
            raise ValueError(f"drift record missing {field!r}: {record}")
    probes = dict(profile.probes)
    key = str(record.get("workload") or "step")
    probes[f"drift:{key}"] = float(record["ratio"])
    probes["drift_ratio"] = float(record["ratio"])
    probes["drift_n"] = float(record["n"])
    return dataclasses.replace(profile, probes=probes)


def merge_probes(profile: CalibrationProfile, records: Sequence[Dict]
                 ) -> CalibrationProfile:
    """Fold a batch of drift records into ``profile.probes`` — the
    per-collective-class verdicts of ``launch.probes.CollectiveProbes``
    (workloads ``collective:<class>``) land as ``drift:collective:<class>``
    keys next to the whole-step ``drift:<workload>`` entries."""
    for rec in records:
        profile = merge_drift(profile, rec)
    return profile


# ---------------------------------------------------------------------- #
# Microbenchmark harness (the port's: its process groups and kernel K1)
# ---------------------------------------------------------------------- #

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core import mesh as M  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def ring_hops(kind: str, p: int) -> int:
    """Ring hops (``mesh.HOPS`` calls) one collective of ``kind`` makes in
    the port's code over a ring of ``p`` ranks. :func:`collective_geometry`
    keeps the reference's count: it differs for ``all_reduce`` at p = 2
    (one exchange of the whole buffer, priced as 2 hops of half of it)
    and for ``psum`` (one blocking call, priced as the all-reduce)."""
    if p <= 1 or kind == "psum":
        return 0
    if kind == "all_reduce":
        return 1 if p == 2 else 2 * (p - 1)
    if kind in ("all_gather", "reduce_scatter", "ring_exchange",
                "all_to_all"):
        return p - 1
    raise ValueError(f"unknown collective kind {kind!r}")


def _multi() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _sync() -> None:
    """Wait for the card's queued work (nothing off the card)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _device(device) -> torch.device:
    """``device``, or by default this rank's card, else the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _timeit(fn, *args, reps: int = 5, warmup: int = 2) -> float:
    """Seconds of one call of ``fn(*args)``: each repetition starts after a
    barrier of the world and ends once the card has synchronized; the max
    over ranks of each repetition (a collective ends when its last rank
    does), then the min over repetitions (min rejects scheduler noise).
    Every rank returns the same value. Every rank of the world calls it
    (the barrier and the reduction are the world's)."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(reps):
        if _multi():
            dist.barrier()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    t = torch.tensor(times, dtype=torch.float64)
    if _multi():
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.min())


def _axis_label(axis) -> str:
    return "+".join(axis) if isinstance(axis, tuple) else axis


def _collective_fns(axes, axis):
    """Each timed collective over ``axis`` (a mesh axis name or a tuple of
    names, the flattened ring), as a function of its argument.

    Arguments follow comm_model's buffer conventions: ``all_gather`` and
    ``ring_exchange`` take the rank's 1/p block of the full buffer
    (:func:`_shard_arg`), the others the rank's full-size buffer."""
    p = axes.size(axis)

    def ring_exchange(v):
        # the ring-attention KV schedule: each rank's block circulates the
        # whole ring, one hop at a time, every hop consumed (the sum
        # stands in for the hop's partial-attention read)
        cur, acc = v, v
        for _ in range(p - 1):
            cur = M.ppermute_ring(cur, axes, axis)
            acc = acc + cur
        return acc

    return {
        "all_gather": lambda v: M.ring_all_gather(v, axes, axis, dim=0),
        "reduce_scatter": lambda v: M.ring_reduce_scatter(v, axes, axis,
                                                          dim=0),
        "all_reduce": lambda v: M.ring_all_reduce(v, axes, axis, dim=0),
        "psum": lambda v: M.psum(v, axes, axis),
        "ring_exchange": ring_exchange,
        # all_to_all: each rank holds the full buffer and sends the
        # (p-1)/p of it destined elsewhere (pairwise hops)
        "all_to_all": lambda v: M.ring_all_to_all(v, axes, axis, dim=0),
    }


_SHARDED = ("all_gather", "ring_exchange")


def _shard_arg(full: torch.Tensor, axes, axis) -> torch.Tensor:
    """The rank's 1/p block of ``full`` over ``axis``."""
    p = axes.size(axis)
    return full.reshape(p, -1)[M.axis_index(axes, axis)].contiguous()


def _hop_calls() -> int:
    return sum(int(c["calls"]) for c in M.HOPS.values())


def measure_axis(axes, axis, sizes: Sequence[int], *,
                 dtype=None, reps: int = 5, device=None,
                 hops: Optional[Dict[str, float]] = None) -> List[Sample]:
    """Time every collective kind over ``axis`` (name or tuple of names)
    across ``sizes`` (buffer elements, comm_model conventions: full
    buffer for AG/RS, reduced buffer for AR/psum), on ``device`` (default:
    this rank's card, else the CPU). Every rank of the world calls it,
    those off the axis's groups too (each runs its own group's ring).
    ``hops``, when given, gets ``"<kind>@<axis>"``: the ring hops one call
    made, counted in ``mesh.HOPS`` over every call (compare
    :func:`ring_hops`)."""
    dtype = dtype or torch.float32
    device = _device(device)
    p = axes.size(axis)
    if p <= 1:
        return []
    fns = _collective_fns(axes, axis)
    itemsize = torch.empty((), dtype=dtype).element_size()
    warmup = 2
    out: List[Sample] = []
    counted: Dict[str, List[int]] = {k: [0, 0] for k in _KINDS}
    for n in sizes:
        n = int(math.ceil(n / p) * p)  # AG/RS need p | elems
        full = torch.arange(n, dtype=dtype, device=device)
        shard = _shard_arg(full, axes, axis)
        # harness floor: an empty timed region pays the barrier's exit,
        # the synchronize and the clock that every timing below pays too
        t0 = _timeit(lambda: None, reps=reps)
        for kind in _KINDS:
            arg = shard if kind in _SHARDED else full
            before = _hop_calls()
            t = max(_timeit(fns[kind], arg, reps=reps, warmup=warmup) - t0,
                    0.0)
            counted[kind][0] += _hop_calls() - before
            counted[kind][1] += reps + warmup
            steps, wire = collective_geometry(kind, p, n * itemsize)
            out.append(Sample(kind=kind, axis=_axis_label(axis), p=p,
                              elems=n, steps=steps, wire_bytes=wire,
                              seconds=t))
    if hops is not None:
        for kind, (calls, timed) in counted.items():
            hops[f"{kind}@{_axis_label(axis)}"] = calls / timed
    return out


def measure_gemm(sizes: Sequence[int] = (256, 512, 1024), *,
                 reps: int = 5, device=None) -> float:
    """Achieved FLOP/s of kernel K1 (``kernels/ops.matmul``; its plain
    version on the CPU), fp32 with TF32 off, best over the size sweep.
    Every rank of the world runs it at once, as a step's ranks run, so on
    a card that ranks share it is one rank's share of the card."""
    device = _device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    best = 0.0
    for n in sizes:
        a = torch.ones((n, n), dtype=torch.float32, device=device)
        b = torch.ones((n, n), dtype=torch.float32, device=device)
        t = _timeit(ops.matmul, a, b, reps=reps)
        best = max(best, 2.0 * n ** 3 / t)
    return best


def _hidden_fraction(t_comm: float, t_mm: float, t_both: float) -> float:
    """Fraction of the shorter leg the fused program hid: 1.0 means the
    rings rode entirely under the matmul, 0.0 means fully serialized."""
    denom = min(t_comm, t_mm)
    if denom <= 0:
        return 0.0
    return max(0.0, min(1.0, (t_comm + t_mm - t_both) / denom))


def _probe_inputs(axes, axis, elems: int, mm_n: int, device):
    p = axes.size(axis)
    elems = int(math.ceil(elems / p) * p)
    v = torch.arange(elems, dtype=torch.float32, device=device)
    a = torch.ones((mm_n, mm_n), dtype=torch.float32, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return v, _shard_arg(v, axes, axis), (lambda: ops.matmul(a, a))


def overlap_probe(axes, axis: str, *, elems: int = 1 << 16,
                  mm_n: int = 512, reps: int = 5,
                  device=None) -> Dict[str, float]:
    """Measured comm/compute overlap: a ring issued alongside an
    *independent* K1 GEMM vs each alone.

    Probes the z-weight pattern (all-gather ring of the rank's block under
    a GEMM) and the x/y-activation pattern (all-reduce ring under a GEMM)
    separately: their hidden fractions decide ``overlap_efficiency`` (the
    max) and ``z_claims_first``. Together, the ring's first hop is posted
    before the GEMM is queued (``under=``): a hop's staging copy waits for
    the work queued before it."""
    device = _device(device)
    p = axes.size(axis)
    if p <= 1:
        return {}
    v, blk, mm = _probe_inputs(axes, axis, elems, mm_n, device)

    def probe(ring):
        t_ring = _timeit(ring, None, reps=reps)
        t_mm = _timeit(mm, reps=reps)
        t_both = _timeit(ring, mm, reps=reps)
        return t_ring, t_mm, t_both, _hidden_fraction(t_ring, t_mm, t_both)

    zr, zm, zb, z_hidden = probe(
        lambda under: M.ring_all_gather(blk, axes, axis, dim=0, under=under))
    ar, am, ab, ar_hidden = probe(
        lambda under: M.ring_all_reduce(v, axes, axis, dim=0, under=under))
    return {"axis": p, "z_ring_s": zr, "z_mm_s": zm, "z_both_s": zb,
            "z_hidden": z_hidden, "ar_ring_s": ar, "ar_mm_s": am,
            "ar_both_s": ab, "ar_hidden": ar_hidden}


def cross_step_probe(axes, axis: str, *, elems: int = 1 << 16,
                     mm_n: int = 512, reps: int = 5,
                     device=None) -> Dict[str, float]:
    """Measured cross-step window: a step's *terminal* all-gather ring
    with the (independent) next step's first K1 GEMM, together (the
    ring's first hop posted, then the GEMM queued) vs each alone. The
    hidden fraction calibrates ``cross_step_efficiency``."""
    device = _device(device)
    p = axes.size(axis)
    if p <= 1:
        return {}
    _, blk, mm = _probe_inputs(axes, axis, elems, mm_n, device)

    def ag(under):
        return M.ring_all_gather(blk, axes, axis, dim=0, under=under)
    t_ag = _timeit(ag, None, reps=reps)
    t_mm = _timeit(mm, reps=reps)
    t_fused = _timeit(ag, mm, reps=reps)
    return {"ag_s": t_ag, "next_mm_s": t_mm, "fused_s": t_fused,
            "hidden": _hidden_fraction(t_ag, t_mm, t_fused)}


def _largest_message_bw(samples: Sequence[Sample]) -> float:
    """The bandwidth (wire bytes / seconds) the largest message reached:
    ``link_bw`` where β fits to 0."""
    timed = [s for s in samples if s.steps > 0 and s.seconds > 0]
    if not timed:
        raise ValueError("no timed collective to take a bandwidth from")
    top = max(s.wire_bytes for s in timed)
    return max(s.wire_bytes / s.seconds for s in timed
               if s.wire_bytes == top)


def run_calibration(axes=None, *, sizes: Sequence[int] = (1 << 12, 1 << 14,
                                                          1 << 16, 1 << 18),
                    reps: int = 5, quick: bool = False, device=None
                    ) -> CalibrationProfile:
    """Time the primitives on this world's ranks and fit a profile.

    ``axes`` (a ``core.mesh.MeshAxes`` whose groups ``launch.mesh.
    init_mesh`` made) defaults to the reference's smoke mesh for the
    world's size, (1,2,2,2) for 8 ranks, (1,1,2,2) for 4, (2,1,1,1) for
    2, whose groups are made here. ``quick`` shrinks the sweep. Every rank
    of the world calls it and gets the same profile."""
    if quick:
        sizes, reps = tuple(sizes[:3]), max(2, reps - 3)
    device = _device(device)
    if axes is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        if n < 2:
            raise RuntimeError(
                "calibration needs >= 2 ranks: run it under python -m "
                "torch.distributed.run --nproc-per-node 8")
        shape = {8: (1, 2, 2, 2), 4: (1, 1, 2, 2), 2: (2, 1, 1, 1)}.get(
            n, (n // 2, 1, 2, 1))
        axes = M.MeshAxes(shape)
        M.init_groups(axes)

    mapped = [ax for ax in M.AXES if axes.size(ax) > 1]
    sweep_axes: List = list(mapped)
    if len(mapped) >= 2:
        # the flattened tuple ring (p = product) adds a second hop count
        # to the sample set, separating γ (per call) from α (per hop)
        sweep_axes.append(tuple(mapped[:2]))
    samples: List[Sample] = []
    fits: List[AxisFit] = []
    hops: Dict[str, float] = {}
    for axis in sweep_axes:
        ax_samples = measure_axis(axes, axis, sizes, reps=reps,
                                  device=device, hops=hops)
        samples.extend(ax_samples)
        g, a, b, r2 = fit_constants(ax_samples)
        fits.append(AxisFit(axis=_axis_label(axis), p=axes.size(axis),
                            alpha=a, beta=b, r2=r2,
                            n_samples=len(ax_samples), gamma=g))
    gamma, alpha, beta, r2 = fit_constants(samples)
    flops = measure_gemm(reps=reps, device=device)

    # probe the widest mapped axis (most ring hops = clearest signal)
    probe_axis = max(mapped, key=lambda ax: axes.size(ax))
    ov = overlap_probe(axes, probe_axis, reps=reps, device=device)
    cs = cross_step_probe(axes, probe_axis, reps=reps, device=device)
    overlap_eff = max(ov.get("z_hidden", 0.0), ov.get("ar_hidden", 0.0))
    # keep the z-first prior unless the AR ring hides strictly better by
    # a >10% (absolute) margin — noise ties must not flip the order
    z_first = ov.get("ar_hidden", 0.0) <= ov.get("z_hidden", 0.0) + 0.10

    probes = {f"overlap_{k}": float(x) for k, x in ov.items()}
    probes.update({f"cross_step_{k}": float(x) for k, x in cs.items()})
    probes.update({f"hops:{k}": float(x) for k, x in hops.items()})
    cuda = device.type == "cuda"
    if cuda:
        probes["ranks_per_card"] = float(
            -(-axes.world // torch.cuda.device_count()))
    if beta > 0:
        link_bw = 1.0 / beta
    else:
        link_bw = _largest_message_bw(samples)
        probes["link_bw_of_largest_message"] = link_bw
    return CalibrationProfile(
        backend="cuda" if cuda else "cpu",
        n_devices=int(axes.world),
        mesh_shape=tuple(axes.sizes[:4] if axes.gseq == 1 else axes.sizes),
        alpha=alpha, gamma=gamma, link_bw=link_bw,
        flops=flops, overlap_efficiency=overlap_eff,
        z_claims_first=z_first,
        cross_step_efficiency=cs.get("hidden", 1.0),
        fit_r2=r2, axis_fits=tuple(fits), probes=probes,
        samples=tuple(samples),
        created=time.strftime("%Y-%m-%dT%H:%M:%S"))


# ---------------------------------------------------------------------- #
# Model validation: predicted vs measured rank correlation
# ---------------------------------------------------------------------- #

def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation (Pearson on average ranks; no scipy)."""
    def ranks(v):
        order = np.argsort(np.asarray(v, dtype=np.float64))
        r = np.empty(len(v), dtype=np.float64)
        r[order] = np.arange(len(v), dtype=np.float64)
        # average ties so equal times share a rank
        vv = np.asarray(v, dtype=np.float64)
        for u in np.unique(vv):
            m = vv == u
            r[m] = r[m].mean()
        return r
    rx, ry = ranks(xs), ranks(ys)
    sx, sy = rx.std(), ry.std()
    if sx == 0 or sy == 0:
        return 0.0
    return float(np.mean((rx - rx.mean()) * (ry - ry.mean())) / (sx * sy))
