"""Serving driver of the port: continuous batching over the paged KV cache.

Requests admit and evict at every step, prompts prefill in chunks that
ride the same step as decode, and the KV cache is a paged pool
(docs/serving.md describes the JAX package's engine, which this mirrors).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --preset full --requests 16 --slots 8 --pages 128 --gen 32

runs on the CUDA card; ``--device cpu`` runs on the CPU. Not ported yet
(each raises ``NotImplementedError``; ROADMAP.md lists them): ``--mode
fixed``, ``--overlap``, ``--telemetry`` and any mesh other than 1,1,1,1.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.launch import steps as ST


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Continuous-batching serving over a paged KV cache, "
                    "on the CUDA card (or --device cpu).")
    ap.add_argument("--arch", required=True,
                    help="architecture name (repro_torch.configs)")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"],
                    help="model-size preset")
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "fixed"],
                    help="continuous: paged-KV continuous batching; "
                         "fixed: not ported yet")
    ap.add_argument("--mesh", default="1,1,1,1",
                    help="g_data,g_x,g_y,g_z (the port runs 1,1,1,1)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length in tokens (uniform)")
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic requests to serve")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in requests/s "
                         "(0 = all requests arrive at t=0)")
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent request slots R")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=64,
                    help="physical KV pages (incl. the reserved null page)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk rows per mixed step")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload RNG seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--overlap", action="store_true",
                    help="ring-decomposed collective matmuls: not ported")
    ap.add_argument("--telemetry", action="store_true",
                    help="per-step JSONL telemetry: not ported")
    return ap


def make_requests(args, vocab_size: int):
    """The synthetic workload of the JAX driver: uniform prompts drawn
    from ``--seed``, all at t=0 or with Poisson arrivals at ``--rate``."""
    from repro_torch.launch.serving import Request
    rng = np.random.RandomState(args.seed)
    t = 0.0
    reqs = []
    for i in range(args.requests):
        if args.rate > 0:
            t += float(rng.exponential(1.0 / args.rate))
        reqs.append(Request(
            rid=i,
            prompt=rng.randint(1, vocab_size,
                               size=(args.prompt_len,)).astype(np.int32),
            max_new=args.gen, arrival=t))
    return reqs


def run_continuous(args):
    """Serve ``args.requests`` requests; returns the engine."""
    from repro_torch.launch.serving import PagedEngine, ServeConfig

    for flag, item in (("overlap", "overlapped schedule"),
                       ("telemetry", "runtime tooling")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported to PyTorch yet: it waits for the "
                f"ROADMAP.md §1 item '{item}'")
    axes = M.MeshAxes(tuple(int(x) for x in args.mesh.split(",")))
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    model = ST.init_model(cfg, axes, seed=0, device=args.device)
    scfg = ServeConfig(slots=args.slots, page_size=args.page_size,
                       pages_per_shard=args.pages, chunk=args.chunk)
    engine = PagedEngine(cfg, axes, model, scfg)
    t0 = time.time()
    engine.warmup()
    print(f"warmup in {time.time() - t0:.2f}s")
    reqs = make_requests(args, cfg.vocab_size)
    stats = engine.run(reqs)
    for r in reqs[: min(4, len(reqs))]:
        print(f"req {r.rid}: {np.asarray(r.generated, np.int32)}")
    print(f"served {stats.n_requests} requests / "
          f"{stats.total_new_tokens} tokens in {stats.wall_s:.2f}s "
          f"({stats.n_steps} steps, {stats.n_preemptions} preemptions)")
    print(f"tokens/s {stats.tokens_per_s:,.1f}  "
          f"latency p50/p99 {stats.latency_p50_ms:.1f}/"
          f"{stats.latency_p99_ms:.1f} ms  "
          f"ttft p50/p99 {stats.ttft_p50_ms:.1f}/"
          f"{stats.ttft_p99_ms:.1f} ms")
    return engine


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "fixed":
        raise NotImplementedError(
            "--mode fixed is not ported to PyTorch yet: it waits for the "
            "ROADMAP.md §1 item '--mode fixed serving'")
    engine = run_continuous(args)
    if not torch.isfinite(engine.last_logits).all():
        raise RuntimeError("non-finite logits")
    print("SERVE OK")


if __name__ == "__main__":
    main()
