"""Continuous-batching serving over the paged KV cache (port of
``repro.launch.serving``).

  * :mod:`pages` — the physical page allocator (free list, reserved null
    page 0), copied from the JAX package;
  * :mod:`scheduler` — request lifecycle and per-iteration plans, copied
    from the JAX package;
  * :mod:`engine` — owns the device pools and drives the scheduler loop
    through the paged step, measuring p50/p99 latency and tokens/s.
"""
from repro_torch.launch.serving.pages import PageAllocator
from repro_torch.launch.serving.scheduler import Plan, Request, Scheduler
from repro_torch.launch.serving.engine import (PagedEngine, ServeConfig,
                                               ServeStats)

__all__ = [
    "PageAllocator", "PagedEngine", "Plan", "Request", "Scheduler",
    "ServeConfig", "ServeStats",
]
