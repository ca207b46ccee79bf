"""Continuous-batching request scheduler.

State machine per request (docs/serving.md):

    queued --admit--> prefill --chunks--> decode --max_new--> done
       ^                                    |
       +---------- preempted (pages exhausted; recompute) ----+

Every iteration the scheduler emits a :class:`Plan` — the dense (R, T)
row block the paged step consumes: slot r's rows ``0..q_len[r]-1`` carry
its next prefill chunk (or its single decode token) at its own global
positions. Admission and eviction happen BETWEEN steps, never inside
them, so one compiled program serves an arbitrarily churning request
mix: that is the whole point of continuous batching.

Preemption is by *recompute* (vLLM's default): when a shard's page pool
is exhausted, the youngest-admitted victim releases all its pages and
goes back to the queue with its generated tokens folded into the prompt
— re-prefilling is cheap exactly because chunked prefill rides the same
step as decode.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.launch.serving.pages import PageAllocator


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (L,) int32 prompt tokens
    max_new: int                    # tokens to generate
    arrival: float = 0.0            # seconds since bench start (open loop)
    # -- runtime state, owned by the scheduler --
    state: str = "queued"           # queued | prefill | decode | done
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                    # tokens already written to the KV pool
    generated: List[int] = dataclasses.field(default_factory=list)
    admit_seq: int = -1             # admission order (preemption victims)
    preemptions: int = 0
    t_first: float = -1.0           # first generated token (TTFT end)
    t_done: float = -1.0

    @property
    def target(self) -> int:
        """Tokens the KV pool must hold before decoding can continue —
        prompt plus anything generated before a preemption."""
        return len(self.prompt) + len(self.generated)

    def full_seq(self) -> np.ndarray:
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])


@dataclasses.dataclass
class Plan:
    """One iteration's device inputs (host arrays; shard_map splits them)."""
    kind: str                       # 'mixed' (T=chunk) | 'decode' (T=1)
    tokens: np.ndarray              # (R, T) int32
    positions: np.ndarray           # (R, T) int32
    q_len: np.ndarray               # (R,) int32, 0 = idle slot
    table: np.ndarray               # (R, max_pages) int32 local page ids
    steps: List[tuple] = dataclasses.field(default_factory=list)
    # steps: (slot, Request, n_rows) for every slot that ran this iteration

    @property
    def n_active(self) -> int:
        return len(self.steps)


class Scheduler:
    def __init__(self, *, n_slots: int, page_size: int, max_pages: int,
                 allocators: List[PageAllocator]):
        if n_slots % len(allocators):
            raise ValueError(f"n_slots={n_slots} must divide evenly over "
                             f"{len(allocators)} batch shards")
        self.n_slots = n_slots
        self.page_size = page_size
        self.max_pages = max_pages
        self.allocators = allocators
        self.slots_per_shard = n_slots // len(allocators)
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.table = np.zeros((n_slots, max_pages), np.int32)
        self._admit_seq = 0
        self.n_preemptions = 0

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #

    def submit(self, req: Request) -> None:
        cap = self.max_pages * self.page_size
        if len(req.prompt) + req.max_new > cap:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds per-request capacity {cap} "
                f"(= max_pages {self.max_pages} x page {self.page_size})")
        self.queue.append(req)

    def shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def admit(self, now: float) -> int:
        """Move arrived queued requests into free slots. Returns count."""
        n = 0
        while self.queue and self.queue[0].arrival <= now:
            slot = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if slot is None:
                break
            req = self.queue.popleft()
            req.state, req.slot, req.pos = "prefill", slot, 0
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slots[slot] = req
            n += 1
        return n

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def all_done(self) -> bool:
        return not self.queue and not self.active

    # ------------------------------------------------------------------ #
    # paging
    # ------------------------------------------------------------------ #

    def _ensure_pages(self, req: Request, upto: int) -> bool:
        """Grow req's page list to cover positions [0, upto); False when
        the shard pool is dry (caller preempts and retries)."""
        alloc = self.allocators[self.shard_of(req.slot)]
        need = -(-upto // self.page_size)
        while len(req.pages) < need:
            p = alloc.alloc()
            if p is None:
                return False
            req.pages.append(p)
            self.table[req.slot, len(req.pages) - 1] = p
        return True

    def _release(self, req: Request) -> None:
        if req.pages:
            self.allocators[self.shard_of(req.slot)].free(req.pages)
        self.table[req.slot, :] = 0
        req.pages = []

    def preempt(self, req: Request) -> None:
        """Recompute-style preemption: drop the KV pages, fold generated
        tokens into the work to re-prefill, rejoin the queue at the
        front (it was here first)."""
        self._release(req)
        self.slots[req.slot] = None
        req.state, req.slot, req.pos = "queued", -1, 0
        req.preemptions += 1
        # arrival stays put (it already passed — the request was admitted
        # once), so re-admission is immediate and latency stays honest
        self.queue.appendleft(req)
        self.n_preemptions += 1

    def _pages_or_preempt(self, req: Request, upto: int) -> bool:
        """Allocate, preempting youngest-admitted victims on the same
        shard until it fits or nobody is left to evict."""
        while not self._ensure_pages(req, upto):
            shard = self.shard_of(req.slot)
            victims = [r for r in self.active
                       if r is not req and self.shard_of(r.slot) == shard]
            if not victims:
                return False
            self.preempt(max(victims, key=lambda r: r.admit_seq))
        return True

    # ------------------------------------------------------------------ #
    # per-iteration planning
    # ------------------------------------------------------------------ #

    def plan(self, chunk: int) -> Optional[Plan]:
        """Build the next iteration's row block, or None when idle."""
        active = self.active
        if not active:
            return None
        prefilling = any(r.state == "prefill" for r in active)
        T = chunk if prefilling else 1
        R = self.n_slots
        tokens = np.zeros((R, T), np.int32)
        positions = np.zeros((R, T), np.int32)
        q_len = np.zeros((R,), np.int32)
        steps: List[tuple] = []
        for req in list(self.active):      # preemption mutates self.slots
            if req.slot < 0:
                continue                   # preempted by an earlier slot
            if req.state == "prefill":
                cl = min(T, req.target - req.pos)
            else:
                cl = 1
            if not self._pages_or_preempt(req, req.pos + cl):
                continue                   # pool dry even after evictions
            if req.slot < 0:
                continue                   # lost its own pages — requeued
            seq = req.full_seq()
            rows = seq[req.pos:req.pos + cl]
            tokens[req.slot, :cl] = rows
            positions[req.slot] = np.minimum(
                req.pos + np.arange(T), self.max_pages * self.page_size - 1)
            q_len[req.slot] = cl
            steps.append((req.slot, req, cl))
        # a victim preempted by a LATER slot's allocation may already be
        # planned: its pages are gone, so drop it from this iteration
        # (it re-prefills from the queue — nothing is lost but the rows)
        steps = [(s, r, c) for (s, r, c) in steps
                 if r.slot == s and self.slots[s] is r]
        live = {s for s, _, _ in steps}
        for s in range(R):
            if s not in live:
                q_len[s] = 0
        if not steps:
            return None
        return Plan(kind="mixed" if prefilling else "decode",
                    tokens=tokens, positions=positions, q_len=q_len,
                    table=self.table.copy(), steps=steps)

    def commit(self, plan: Plan, sampled: np.ndarray, now: float) -> int:
        """Apply one executed plan: advance positions, collect each
        completed slot's sampled token, retire finished requests.
        Returns the number of new tokens generated this iteration."""
        new_tokens = 0
        for slot, req, cl in plan.steps:
            req.pos += cl
            emitted = False
            if req.state == "prefill":
                if req.pos >= req.target:
                    req.state = "decode"
                    emitted = True       # last prompt row predicts token 1
            else:
                emitted = True
            if emitted:
                req.generated.append(int(sampled[slot]))
                new_tokens += 1
                if req.t_first < 0:
                    req.t_first = now
                if len(req.generated) >= req.max_new:
                    req.state, req.t_done = "done", now
                    self._release(req)
                    self.slots[slot] = None
                    req.slot = -1
        return new_tokens
