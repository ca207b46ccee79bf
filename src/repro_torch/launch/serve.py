"""Serving driver of the port, in the two modes of the JAX driver.

``--mode continuous`` (the default): continuous batching over the paged KV
cache. Requests admit and evict at every step, prompts prefill in chunks
that ride the same step as decode, and the KV cache is a paged pool
(docs/serving.md describes the JAX package's engine, which this mirrors).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --preset full --requests 16 --slots 8 --pages 128 --gen 32

``--mode fixed``: one prefill of a uniform batch of prompts into dense
caches, then lockstep greedy decode. It serves every ported architecture,
Jamba's hybrid Mamba/attention decoder among them:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode fixed \\
      --arch jamba-v0.1-52b-dense-ffn --preset full --batch 4 \\
      --prompt-len 512 --gen 32

Both run on the CUDA card; ``--device cpu`` runs on the CPU. Not ported yet
(each raises ``NotImplementedError``; ROADMAP.md lists them): ``--overlap``,
``--telemetry`` and any mesh other than 1,1,1,1.
"""
from __future__ import annotations

import argparse
import dataclasses
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
                         "fixed: one prefill of a uniform batch, then "
                         "lockstep greedy decode")
    ap.add_argument("--mesh", default="1,1,1,1",
                    help="g_data,g_x,g_y,g_z (the port runs 1,1,1,1)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length in tokens (uniform)")
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--batch", type=int, default=4,
                    help="concurrent sequences (--mode fixed)")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic requests to serve (--mode continuous)")
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


def _refuse_unported(args) -> M.MeshAxes:
    """The mesh of ``--mesh``; raises on the flags and meshes not ported."""
    for flag, item in (("overlap", "overlapped schedule"),
                       ("telemetry", "runtime tooling")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported to PyTorch yet: it waits for the "
                f"ROADMAP.md §1 item '{item}'")
    return M.MeshAxes(tuple(int(x) for x in args.mesh.split(",")))


def _setup(args):
    """(cfg, axes, model): float32 weights from seed 0 on ``--device``."""
    axes = _refuse_unported(args)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    return cfg, axes, ST.init_model(cfg, axes, seed=0, device=args.device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class FixedResult:
    ids: np.ndarray          # (batch, gen) greedy ids
    logits: torch.Tensor     # the last decode step's logits (batch, 1, V)
    prefill_s: float         # the timed prefill, host clock
    decode_s: float          # the gen - 1 timed decode steps, host clock

    @property
    def decode_tokens_per_s(self) -> float:
        n = self.ids.shape[0] * (self.ids.shape[1] - 1)
        return n / self.decode_s if self.decode_s > 0 else float("nan")


def run_fixed(args, model=None) -> FixedResult:
    """The JAX ``run_fixed``: a warm-up prefill and one decode step on
    throwaway caches, then a timed prefill of ``--batch`` prompts of
    ``--prompt-len`` tokens and ``--gen`` - 1 greedy decode steps. A caller
    may pass the model instead of building it; the flags are checked
    either way."""
    _refuse_unported(args)
    if model is None:
        _, _, model = _setup(args)
    cfg, axes = model.cfg, model.axes
    dev = next(model.parameters()).device
    S_max = args.prompt_len + args.gen
    pre_fn, ct = ST.make_prefill_step(cfg, axes)(args.batch, args.prompt_len,
                                                 S_max)
    dec_fn, _ = ST.make_decode_step(cfg, axes)(args.batch, S_max)
    rng = np.random.RandomState(args.seed)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)

    def greedy(logits):
        return logits[:, -1].argmax(-1)[:, None].to(torch.int32)

    t0 = time.time()
    warm = ST.zeros_caches(ct, dev)
    wl, warm = pre_fn(model, warm, tokens)
    wl, warm = dec_fn(model, warm, greedy(wl), args.prompt_len)
    _sync(dev)
    print(f"warmup in {time.time() - t0:.2f}s")
    del warm, wl

    caches = ST.zeros_caches(ct, dev)
    t0 = time.time()
    logits, caches = pre_fn(model, caches, tokens)
    tok = greedy(logits)
    _sync(dev)
    prefill_s = time.time() - t0
    print(f"prefill {args.batch}x{args.prompt_len} in {prefill_s:.3f}s")
    out = [tok.cpu().numpy()]
    t0 = time.time()
    for i in range(args.gen - 1):
        logits, caches = dec_fn(model, caches, tok, args.prompt_len + i)
        tok = greedy(logits)
        out.append(tok.cpu().numpy())
    _sync(dev)
    res = FixedResult(np.concatenate(out, axis=1), logits, prefill_s,
                      time.time() - t0)
    print("generated ids:\n", res.ids)
    print(f"decode: {args.gen - 1} steps x batch {args.batch} = "
          f"{res.decode_tokens_per_s:,.1f} tok/s")
    return res


def run_continuous(args):
    """Serve ``args.requests`` requests; returns the engine."""
    from repro_torch.launch.serving import PagedEngine, ServeConfig

    cfg, axes, model = _setup(args)
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
        logits = run_fixed(args).logits
    else:
        logits = run_continuous(args).last_logits
    if not torch.isfinite(logits).all():
        raise RuntimeError("non-finite logits")
    print("SERVE OK")


if __name__ == "__main__":
    main()
