"""Runtime telemetry of the port: per-step metrics, MFU, and
predicted-vs-measured drift (the counterpart of the JAX package's
``launch/telemetry.py``).

One :class:`Telemetry` recorder per run, on rank 0, shared by
``train.py`` and ``serve.py --mode continuous``. It appends schema'd
JSONL records to ``runs/telemetry/<run>.jsonl`` (``--log-file``
overrides the path) and prints a summary table at exit. The record kinds,
:data:`SCHEMA`, :data:`NULLABLE`, :func:`validate_record`,
:func:`validate_file` and :class:`DriftMonitor` are copies of the
reference's, so its ``validate_file`` reads the port's files:

  * ``meta``        — run header (arch, mesh, ranks, the MFU denominator,
                      the predicted step time);
  * ``train_step``  — wall time (the first step excluded), EMA,
                      tokens/s, MFU, loss/grad-norm, peak device bytes,
                      drift ratio;
  * ``serve_step``  — one engine iteration: step kind (mixed/decode), new
                      tokens, queue depth, active slots, page-pool
                      utilization, cumulative preemptions;
  * ``drift``       — the rolling predicted-vs-measured verdict
                      (:meth:`DriftMonitor.record`), which
                      ``core.calibrate.merge_drift`` folds into the
                      profile;
  * ``summary``     — aggregates (p50/p99 step time, tokens/s, MFU, peak
                      bytes) written once at :meth:`Telemetry.close`.

**MFU** is ``model_flops_per_token(cfg) * tokens/s`` over the aggregate
peak FLOP/s: with ``--calib``, the profile's measured K1 rate times the
ranks (a rank's share of its card when ranks share one); without it, the
card's own peak for the run's dtype (:data:`CARD_PEAK_FLOPS`) times the
cards. Off the card, or on a card the table does not know, MFU is null.
Step timing synchronizes the card (:meth:`Telemetry.clock`), which
``train.py`` does every step anyway; serving's step ends when its sampled
ids reach the host. The peak device bytes are
``torch.cuda.max_memory_allocated`` of the rank's card (null on the CPU).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

SCHEMA_VERSION = 1
DEFAULT_DIR = os.path.join("runs", "telemetry")

#: required numeric fields per record kind (beyond the envelope
#: ``v``/``run``/``kind`` every record carries). Nullable fields —
#: present but possibly None — are listed separately.
SCHEMA: Dict[str, tuple] = {
    "meta": (),
    "train_step": ("step", "step_s", "ema_s", "tok_s"),
    "serve_step": ("step", "step_s", "new_tokens", "queue_depth",
                   "active", "page_util", "preemptions"),
    "drift": ("predicted_s", "measured_p50_s", "ratio", "n"),
    "probe": ("step", "measured_s", "predicted_s", "ratio", "jump"),
    "event": ("step",),
    "summary": ("steps", "wall_s"),
}
NULLABLE: Dict[str, tuple] = {
    "train_step": ("mfu", "loss", "grad_norm", "peak_bytes", "drift"),
    "probe": ("injected_s",),
}


def validate_record(rec: dict) -> None:
    """Raise ValueError unless ``rec`` is a valid telemetry record."""
    for key in ("v", "run", "kind"):
        if key not in rec:
            raise ValueError(f"record missing envelope field {key!r}: {rec}")
    if rec["v"] != SCHEMA_VERSION:
        raise ValueError(f"unknown schema version {rec['v']!r}")
    kind = rec["kind"]
    if kind not in SCHEMA:
        raise ValueError(f"unknown record kind {kind!r}")
    for field in SCHEMA[kind]:
        if field not in rec:
            raise ValueError(f"{kind} record missing {field!r}: {rec}")
        if not isinstance(rec[field], (int, float)):
            raise ValueError(
                f"{kind}.{field} must be numeric, got {rec[field]!r}")
    for field in NULLABLE.get(kind, ()):
        if field in rec and rec[field] is not None \
                and not isinstance(rec[field], (int, float)):
            raise ValueError(
                f"{kind}.{field} must be numeric or null, got "
                f"{rec[field]!r}")


def validate_file(path: str) -> int:
    """Validate every line of a telemetry JSONL file; returns the record
    count (CI asserts on this)."""
    n = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            validate_record(json.loads(line))
            n += 1
    if n == 0:
        raise ValueError(f"{path}: no telemetry records")
    return n


#: each card's peak FLOP/s by dtype, the MFU denominator without
#: ``--calib`` (the H100 SXM: 67 TFLOP/s fp32 on its CUDA cores, 989 dense
#: bf16 on its tensor cores)
CARD_PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12},
}


def card_peak_flops(device, dtype: str) -> float:
    """Peak FLOP/s of ``device``'s card for ``dtype`` ("float32" or
    "bfloat16"), 0.0 (MFU off) off the card or for a card or dtype
    :data:`CARD_PEAK_FLOPS` does not hold."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    return CARD_PEAK_FLOPS.get(name, {}).get(dtype, 0.0)


def peak_memory_bytes(device=None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of ``device``'s card, or None
    off the card (the CPU keeps no such count)."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


class DriftMonitor:
    """Rolling measured/predicted step-time ratio with an out-of-band
    warning (docs/telemetry.md §Drift).

    ``ratio`` is the rolling median over the last ``window`` steps —
    median, not mean, so one GC pause or checkpoint write cannot trip
    the alarm. Out of band means outside ``[1/(1+band), 1+band]`` after
    ``min_steps`` samples; :meth:`check` returns the warning message
    exactly once per excursion."""

    def __init__(self, predicted_s: float, *, window: int = 32,
                 band: float = 0.5, min_steps: int = 5):
        if predicted_s <= 0:
            raise ValueError(f"predicted_s must be > 0, got {predicted_s}")
        self.predicted_s = float(predicted_s)
        self.band = float(band)
        self.min_steps = int(min_steps)
        self.ratios: collections.deque = collections.deque(maxlen=window)
        self.n = 0
        self.warned = False

    def update(self, measured_s: float) -> float:
        """Record one measured step; returns the rolling ratio."""
        self.ratios.append(float(measured_s) / self.predicted_s)
        self.n += 1
        return self.ratio

    @property
    def ratio(self) -> float:
        if not self.ratios:
            return float("nan")
        return float(np.median(list(self.ratios)))

    @property
    def out_of_band(self) -> bool:
        if self.n < self.min_steps:
            return False
        r = self.ratio
        return r > 1.0 + self.band or r < 1.0 / (1.0 + self.band)

    def check(self) -> Optional[str]:
        """Warning message when newly out of band, else None."""
        if not self.out_of_band:
            self.warned = False
            return None
        if self.warned:
            return None
        self.warned = True
        return (f"drift: measured/predicted step time "
                f"{self.ratio:.2f}x is outside the "
                f"[{1.0 / (1.0 + self.band):.2f}, "
                f"{1.0 + self.band:.2f}] band "
                f"(predicted {self.predicted_s * 1e3:.2f} ms) — "
                f"recalibrate (python -m benchmarks.calibrate) or merge "
                f"this run's drift record (core.calibrate.merge_drift)")

    def record(self, *, workload: str = "step") -> dict:
        """The drift payload ``core.calibrate.merge_drift`` consumes."""
        return {
            "workload": workload,
            "predicted_s": self.predicted_s,
            "measured_p50_s": self.ratio * self.predicted_s,
            "ratio": self.ratio,
            "n": self.n,
            "band": self.band,
            "out_of_band": self.out_of_band,
        }


@dataclasses.dataclass
class _StepStats:
    """Warmup-excluded accumulators over one run."""
    times: List[float] = dataclasses.field(default_factory=list)
    ema_s: Optional[float] = None
    tokens: int = 0

    def push(self, step_s: float, tokens: int, alpha: float) -> float:
        self.times.append(step_s)
        self.tokens += tokens
        self.ema_s = (step_s if self.ema_s is None
                      else alpha * step_s + (1.0 - alpha) * self.ema_s)
        return self.ema_s

    def percentile(self, q: float) -> float:
        if not self.times:
            return float("nan")
        return float(np.percentile(self.times, q))


class Telemetry:
    """JSONL telemetry sink + aggregator (one instance per run).

    ``flops_per_token`` / ``peak_flops_per_device`` / ``n_devices``
    parameterize MFU (any of them 0 disables it); ``tokens_per_step``
    is the training global batch in tokens; ``drift`` is an optional
    :class:`DriftMonitor` priced from the ``--calib`` profile; ``device``
    is the rank's device, whose card :meth:`clock` synchronizes and whose
    peak memory the records carry."""

    def __init__(self, run: str, *, path: Optional[str] = None,
                 out_dir: str = DEFAULT_DIR, tokens_per_step: int = 0,
                 flops_per_token: float = 0.0,
                 peak_flops_per_device: float = 0.0, n_devices: int = 1,
                 drift: Optional[DriftMonitor] = None, ema: float = 0.1,
                 meta: Optional[dict] = None, verbose: bool = True,
                 device=None):
        self.run = run
        self.device = torch.device(device) if device is not None else None
        self.path = path or os.path.join(out_dir, f"{run}.jsonl")
        self.tokens_per_step = int(tokens_per_step)
        self.flops_per_token = float(flops_per_token)
        self.peak_flops = float(peak_flops_per_device) * int(n_devices)
        self.drift = drift
        self.ema_alpha = float(ema)
        self.verbose = verbose
        self.stats = _StepStats()
        self.serve_tokens = 0
        self.serve_steps = 0
        self._t0 = time.time()
        self._closed = False
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._f = open(self.path, "w")
        head = {"tokens_per_step": self.tokens_per_step,
                "flops_per_token": self.flops_per_token,
                "peak_flops": self.peak_flops,
                "predicted_step_s": (drift.predicted_s if drift else None),
                "t0_unix": self._t0}
        head.update(meta or {})
        self._emit("meta", head)

    # ------------------------------------------------------------------ #
    def clock(self) -> float:
        """The step clock (``time.time``) once the card's queued work is
        done: a step's wall time is the card's time too."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def _emit(self, kind: str, fields: dict) -> dict:
        rec = {"v": SCHEMA_VERSION, "run": self.run, "kind": kind}
        rec.update(fields)
        validate_record(rec)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def mfu(self, tok_s: float) -> Optional[float]:
        if self.flops_per_token <= 0 or self.peak_flops <= 0:
            return None
        return self.flops_per_token * tok_s / self.peak_flops

    # ------------------------------------------------------------------ #
    def train_step(self, step: int, step_s: float, *,
                   loss: Optional[float] = None,
                   grad_norm: Optional[float] = None) -> dict:
        """Record one warm optimizer step (callers exclude step 0: its
        wall time is compile, not steady state)."""
        ema = self.stats.push(step_s, self.tokens_per_step, self.ema_alpha)
        tok_s = self.tokens_per_step / max(step_s, 1e-12)
        ratio = None
        if self.drift is not None:
            self.drift.update(step_s)
            ratio = self.drift.ratio
            msg = self.drift.check()
            if msg and self.verbose:
                print(f"WARNING [{self.run}] {msg}", flush=True)
        return self._emit("train_step", {
            "step": step, "step_s": step_s, "ema_s": ema, "tok_s": tok_s,
            "mfu": self.mfu(tok_s), "loss": loss, "grad_norm": grad_norm,
            "peak_bytes": peak_memory_bytes(self.device), "drift": ratio})

    def probe(self, step: int, result) -> dict:
        """Record one collective-probe firing (``launch.probes
        .ProbeResult``)."""
        return self._emit("probe", {
            "step": int(step), "cls": result.cls,
            "collective": result.kind,
            "p": int(result.p), "elems": int(result.elems),
            "measured_s": float(result.measured_s),
            "predicted_s": float(result.predicted_s),
            "ratio": float(result.ratio), "jump": float(result.jump),
            "injected_s": (float(result.injected_s)
                           if result.injected_s else None)})

    def event(self, step: int, event: str, **fields) -> dict:
        """Record a lifecycle/chaos event (free-form string/number
        fields beyond the required ``step``) — the recovery audit
        trail chaos tests and operators read back."""
        return self._emit("event", dict({"step": int(step),
                                         "event": str(event)}, **fields))

    def serve_step(self, step: int, step_s: float, *, new_tokens: int,
                   queue_depth: int, active: int, page_util: float,
                   preemptions: int, step_kind: str = "decode") -> dict:
        """Record one engine iteration (``preemptions`` cumulative)."""
        self.stats.push(step_s, new_tokens, self.ema_alpha)
        self.serve_tokens += int(new_tokens)
        self.serve_steps += 1
        return self._emit("serve_step", {
            "step": step, "step_s": step_s, "step_kind": step_kind,
            "new_tokens": int(new_tokens), "queue_depth": int(queue_depth),
            "active": int(active), "page_util": float(page_util),
            "preemptions": int(preemptions)})

    # ------------------------------------------------------------------ #
    def close(self, extra: Optional[dict] = None) -> dict:
        """Write the drift + summary records, print the human table, and
        close the file. ``extra`` fields override the computed summary
        (the serving callers pass the engine's own tokens/s so the JSONL
        and runs/perf/serving.csv agree by construction)."""
        if self._closed:
            return {}
        self._closed = True
        wall = time.time() - self._t0
        n = len(self.stats.times)
        p50, p99 = self.stats.percentile(50), self.stats.percentile(99)
        tok_s = (self.stats.tokens / sum(self.stats.times)
                 if self.stats.times and sum(self.stats.times) > 0 else None)
        summary = {
            "steps": n, "wall_s": wall, "step_p50_s": p50,
            "step_p99_s": p99, "ema_s": self.stats.ema_s,
            "tok_s": tok_s, "mfu": self.mfu(tok_s) if tok_s else None,
            "peak_bytes": peak_memory_bytes(self.device),
        }
        drift_rec = None
        if self.drift is not None and self.drift.n:
            drift_rec = self.drift.record()
            self._emit("drift", drift_rec)
            summary["drift"] = drift_rec["ratio"]
        summary.update(extra or {})
        rec = self._emit("summary", summary)
        self._f.close()
        if self.verbose:
            self._print_table(summary)
        return rec

    def _print_table(self, s: dict) -> None:
        def fmt(k, v):
            if v is None:
                return "-"
            if k == "tok_s":
                return f"{v:,.0f}"
            if k.endswith("_s") and k != "steps":
                return f"{v * 1e3:,.2f} ms"
            if k == "mfu":
                return f"{v * 100:.2f}%"
            if k == "peak_bytes":
                return f"{v / 2**20:,.1f} MiB"
            if isinstance(v, float):
                return f"{v:,.3f}"
            return str(v)
        print(f"telemetry [{self.run}] -> {self.path}")
        for k in ("steps", "step_p50_s", "step_p99_s", "ema_s", "tok_s",
                  "mfu", "peak_bytes", "drift"):
            if k in s:
                print(f"  {k:<12} {fmt(k, s[k])}")
