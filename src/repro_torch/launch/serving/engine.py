"""Serving engine: the paged step + the scheduler loop (port of
``repro.launch.serving.engine``).

The engine owns the KV page pools on the model's device and runs the
paged step at two row widths: T = chunk for iterations that carry prefill
work (decode slots ride along with q_len = 1) and T = 1 for pure decode.
Admission, chunking, paging and preemption are host-side bookkeeping
between steps. Each step sends its plan to the device in one copy and
brings the sampled ids back in one: that copy back is the step's only
wait for the device.

On a mesh every rank runs the same scheduler on the same global plan.
Slots shard over the batch axes (data x z) in contiguous blocks, as the
scheduler's per-shard page pools do: each rank sends the device the
global plan (the table holds shard-local page ids), runs its batch
shard's rows of it (``steps.make_paged_step``), and gathers the logits
over y (vocab) and the batch axes (rows) before the argmax, so every rank
samples the same ids from the same bits. The scheduler admits by the
clock, so every rank takes rank 0's reading of it (``mesh.from_rank0``)
each iteration.

Sampling is greedy argmax over the full (padded-vocab) logits, as in the
JAX engine.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import List

import numpy as np
import torch

from repro_torch.core import mesh as M
from repro_torch.core.overlap import OverlapConfig
from repro_torch.launch import steps as ST
from repro_torch.launch.serving.pages import PageAllocator
from repro_torch.launch.serving.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (docs/serving.md has the sizing guidance)."""
    slots: int = 8             # R: concurrent requests (multiple of shards)
    page_size: int = 16        # tokens per KV page
    pages_per_shard: int = 64  # physical pages per batch shard (incl. null)
    chunk: int = 32            # prefill chunk rows (T of the mixed step)

    @property
    def max_pages(self) -> int:
        """Page-table width = whole per-shard pool (a single request may
        legitimately hold every allocatable page)."""
        return self.pages_per_shard - 1


@dataclasses.dataclass
class ServeStats:
    """Aggregates over one :meth:`PagedEngine.run`."""
    n_requests: int
    total_new_tokens: int
    wall_s: float
    latency_p50_ms: float
    latency_p99_ms: float
    ttft_p50_ms: float
    ttft_p99_ms: float
    n_steps: int
    n_preemptions: int

    @property
    def tokens_per_s(self) -> float:
        return self.total_new_tokens / max(self.wall_s, 1e-9)


def percentiles(xs: List[float]) -> tuple:
    if not xs:
        return (float("nan"), float("nan"))
    return (float(np.percentile(xs, 50)), float(np.percentile(xs, 99)))


class PagedEngine:
    def __init__(self, cfg, axes: M.MeshAxes, model,
                 scfg: ServeConfig = ServeConfig(), *,
                 dtype=torch.float32,
                 overlap: OverlapConfig = OverlapConfig()):
        shards = axes.batch_shards
        if scfg.slots % shards:
            raise ValueError(
                f"slots={scfg.slots} must be a multiple of the batch "
                f"shards g_data*g_z={shards} (slots shard over data x z)")
        self.model, self.scfg, self.axes = model, scfg, axes
        self.device = model.embed.device
        build = ST.make_paged_step(cfg, axes, dtype=dtype, overlap=overlap)
        self.step_fn, ct = build(shards * scfg.pages_per_shard,
                                 scfg.page_size)
        self.pools = ST.zeros_caches(ct, self.device)
        self.sched = Scheduler(
            n_slots=scfg.slots, page_size=scfg.page_size,
            max_pages=scfg.max_pages,
            allocators=[PageAllocator(scfg.pages_per_shard)
                        for _ in range(shards)])
        self.last_logits = None    # (R, 1, V) of the latest step
        self.plan_hash = hashlib.sha256()   # of the plans :meth:`run` ran

    # ------------------------------------------------------------------ #

    def _run_plan(self, plan):
        R, T = plan.tokens.shape
        n = R * T
        # only the table columns this step's rows reach: the plan's table
        # is as wide as the pool, and K5's grid and workspace grow with
        # the width of the table it is given
        cols = max(len(req.pages) for _, req, _ in plan.steps)
        host = np.concatenate([plan.tokens.ravel(), plan.positions.ravel(),
                               plan.q_len, plan.table[:, :cols].ravel()]
                              ).astype(np.int32)
        buf = torch.from_numpy(host).to(self.device)
        tokens = buf[:n].view(R, T)
        positions = buf[n:2 * n].view(R, T)
        q_len = buf[2 * n:2 * n + R]
        table = buf[2 * n + R:].view(R, -1)
        logits, self.pools = self.step_fn(self.model, tokens, self.pools,
                                          positions, q_len, table)
        logits = ST.gather_logits(logits, self.axes)
        self.last_logits = logits
        return torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32
                                                         ).cpu().numpy()

    def warmup(self) -> None:
        """Run both step widths on a throwaway request, so that timed runs
        pay no first-call cost (kernel build and load, library handles).
        The request's pages are freed; their stale data is masked by
        q_len and the page table for every later request."""
        s = self.sched
        L = min(2 * self.scfg.chunk, s.max_pages * s.page_size - 2)
        req = Request(rid=-1, prompt=np.ones((L,), np.int32), max_new=2)
        s.submit(req)
        s.admit(now=0.0)
        while not s.all_done():
            plan = s.plan(self.scfg.chunk)
            s.commit(plan, self._run_plan(plan), now=0.0)

    def run(self, requests: List[Request], *,
            time_fn=time.time, telemetry=None) -> ServeStats:
        """Serve ``requests`` (``arrival`` in seconds relative to start) to
        completion; open loop: the clock keeps running whether or not the
        engine keeps up.

        ``telemetry`` (a ``launch.telemetry.Telemetry``) receives one
        ``serve_step`` record per executed plan: step kind, new tokens,
        queue depth, active slots, page-pool utilization and the
        cumulative preemption count, timed on its clock (the card
        synchronized)."""
        s = self.sched
        for r in sorted(requests, key=lambda r: r.arrival):
            s.submit(r)
        t0 = time_fn()
        n_steps = 0
        total_new = 0
        page_cap = sum(a.n_pages - 1 for a in s.allocators)
        self.plan_hash = hashlib.sha256()
        while not s.all_done():
            # every rank admits by rank 0's clock, so the plans agree
            now = M.from_rank0(time_fn() - t0)
            s.admit(now)
            plan = s.plan(self.scfg.chunk)
            if plan is None:
                # queue is non-empty but nothing has arrived yet
                next_t = s.queue[0].arrival
                time.sleep(min(max(next_t - now, 0.0), 0.01))
                continue
            for a in (plan.tokens, plan.positions, plan.q_len, plan.table):
                self.plan_hash.update(np.ascontiguousarray(a).tobytes())
            t_plan = telemetry.clock() if telemetry is not None else None
            sampled = self._run_plan(plan)
            n_steps += 1
            new = s.commit(plan, sampled, now=time_fn() - t0)
            total_new += new
            if telemetry is not None:
                telemetry.serve_step(
                    n_steps - 1, telemetry.clock() - t_plan, new_tokens=new,
                    queue_depth=len(s.queue), active=plan.n_active,
                    page_util=(sum(a.n_used for a in s.allocators)
                               / max(page_cap, 1)),
                    preemptions=s.n_preemptions, step_kind=plan.kind)
        wall = time_fn() - t0
        lat = [r.t_done - r.arrival for r in requests]
        ttft = [r.t_first - r.arrival for r in requests]
        l50, l99 = percentiles([x * 1e3 for x in lat])
        f50, f99 = percentiles([x * 1e3 for x in ttft])
        return ServeStats(
            n_requests=len(requests), total_new_tokens=total_new,
            wall_s=wall, latency_p50_ms=l50, latency_p99_ms=l99,
            ttft_p50_ms=f50, ttft_p99_ms=f99, n_steps=n_steps,
            n_preemptions=s.n_preemptions)
