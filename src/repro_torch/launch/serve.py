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

Both run on the CUDA card; ``--device cpu`` runs on the CPU. On a mesh of
more than one rank (``--mesh g_data,g_x,g_y,g_z``), one process per rank
under ``torch.distributed.run``, each rank holding its shard of every
weight, its collectives over gloo:

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-1.7b \
      --preset full --mesh 1,2,2,1 --backend gloo

``--overlap`` runs both modes' steps with the overlapped schedule
(``OverlapConfig.all_on``: the z weight gathers and the x/y activation
all-reduces as rings of hops whose GEMMs run as the blocks arrive),
``--z-chunks`` and ``--ar-chunks`` sub-rings per block; on a mesh of one
rank every ring is the plain GEMM.

``--telemetry`` (``--mode continuous``) writes rank 0's per-iteration
JSONL (``launch/telemetry.py``: step kind, new tokens, queue depth,
active slots, page-pool use, preemptions, and a summary whose tokens/s,
TTFT and latency are the engine's own) to ``runs/telemetry/<run>.jsonl``
or ``--log-file``.

Only rank 0 prints; on a mesh its last line before ``SERVE OK`` is one
JSON object ``{"serve": {...}}``: the served ids, tokens/s, TTFT and
latency, one hash of the sequence of plans, and each rank's collective
seconds and bytes, peak memory, kernel launches and parameter hash, all of
the timed run. Not ported yet (each raises ``NotImplementedError``;
ROADMAP.md lists them): ``--telemetry`` in ``--mode fixed`` and
``--backend nccl``.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.core.overlap import OverlapConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import close_mesh, init_mesh, mesh_axes


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
                    help="g_data,g_x,g_y,g_z: more than one rank runs one "
                         "process per rank under torch.distributed.run")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="torch.distributed backend of a mesh with more "
                         "than one rank (gloo; nccl is not ported)")
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
                    help="ring-decomposed collective matmuls in the "
                         "prefill/decode steps (core/overlap.py: "
                         "overlapped z weight gathers + x/y activation "
                         "all-reduce rings)")
    ap.add_argument("--z-chunks", type=int, default=1,
                    help="sub-rings per z weight block (with --overlap)")
    ap.add_argument("--ar-chunks", type=int, default=1,
                    help="sub-rings per activation all-reduce block "
                         "(with --overlap)")
    ap.add_argument("--telemetry", action="store_true",
                    help="per-step scheduler counters (queue depth, page "
                         "utilization, preemptions) + tokens/s as "
                         "schema'd JSONL under runs/telemetry/ "
                         "(--mode continuous; launch/telemetry.py)")
    ap.add_argument("--log-file", default=None,
                    help="telemetry JSONL path (implies --telemetry; "
                         "default runs/telemetry/<run>.jsonl)")
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
    """The mesh of ``--mesh``; raises on the flags not ported."""
    if (args.telemetry or args.log_file) and args.mode != "continuous":
        raise NotImplementedError(
            "--telemetry and --log-file record the continuous engine's "
            "iterations; --mode fixed's are not ported to PyTorch yet: they "
            "wait for the ROADMAP.md §1 item 'runtime tooling'")
    return mesh_axes(args.mesh)


def overlap_config(args) -> OverlapConfig:
    """``--overlap``'s schedule, as the JAX driver maps it."""
    return (OverlapConfig.all_on(z_chunks=args.z_chunks,
                                 ar_chunks=args.ar_chunks)
            if args.overlap else OverlapConfig())


def _setup(args, device=None, cfg=None):
    """(cfg, axes, model): float32 weights from seed 0 on ``device``
    (default ``--device``), this rank's shards of them; the model of
    ``--arch`` and ``--preset``, or ``cfg``."""
    axes = _refuse_unported(args)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.preset == "smoke":
            cfg = cfg.reduced()
    return cfg, axes, ST.init_model(cfg, axes, seed=0,
                                    device=device or args.device)


def _say(*a) -> None:
    """Print on rank 0 only."""
    if M.process_rank() == 0:
        print(*a, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _delta(after: dict, before: dict) -> dict:
    """Counters ``after`` less ``before``, nested dicts of numbers."""
    return {k: _delta(v, before.get(k, {})) if isinstance(v, dict)
            else v - before.get(k, 0) for k, v in after.items()}


def _counters():
    """This process's kernel launches and collective counters."""
    return ops.launches(), copy.deepcopy(M.COMM), copy.deepcopy(M.COMM_AXES)


@dataclasses.dataclass
class FixedResult:
    ids: np.ndarray          # (batch, gen) greedy ids
    logits: torch.Tensor     # the last decode step's logits (batch, 1, V)
    prefill_s: float         # the timed prefill, host clock
    decode_s: float          # the gen - 1 timed decode steps, host clock
    # the timed prefill and decode steps' kernel launches and collectives
    # (by kind, by axis), and the hash of the token batches they were fed
    launches: dict = dataclasses.field(default_factory=dict)
    comm: dict = dataclasses.field(default_factory=dict)
    comm_axes: dict = dataclasses.field(default_factory=dict)
    plan_sha256: str = ""
    prompts: np.ndarray = None   # (batch, prompt_len) the prompts served

    @property
    def decode_tokens_per_s(self) -> float:
        n = self.ids.shape[0] * (self.ids.shape[1] - 1)
        return n / self.decode_s if self.decode_s > 0 else float("nan")


def run_fixed(args, model=None) -> FixedResult:
    """The JAX ``run_fixed``: a warm-up prefill and one decode step on
    throwaway caches, then a timed prefill of ``--batch`` prompts of
    ``--prompt-len`` tokens and ``--gen`` - 1 greedy decode steps. A caller
    may pass the model instead of building it; the flags are checked
    either way. On a mesh each rank runs its batch shard, and the greedy
    ids come from the logits gathered over y and the batch axes, the same
    on every rank."""
    _refuse_unported(args)
    if model is None:
        _, _, model = _setup(args)
    cfg, axes = model.cfg, model.axes
    dev = next(model.parameters()).device
    S_max = args.prompt_len + args.gen
    ov = overlap_config(args)
    pre_fn, ct = ST.make_prefill_step(cfg, axes, overlap=ov)(
        args.batch, args.prompt_len, S_max)
    dec_fn, _ = ST.make_decode_step(cfg, axes, overlap=ov)(args.batch, S_max)
    rng = np.random.RandomState(args.seed)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(dev)

    def greedy(logits):
        logits = ST.gather_logits(logits, axes)
        return logits, logits[:, -1].argmax(-1)[:, None].to(torch.int32)

    t0 = time.time()
    warm = ST.zeros_caches(ct, dev)
    wl, warm = pre_fn(model, warm, tokens)
    wl, warm = dec_fn(model, warm, greedy(wl)[1], args.prompt_len)
    _sync(dev)
    _say(f"warmup in {time.time() - t0:.2f}s")
    del warm, wl

    before = _counters()
    plan = hashlib.sha256(tokens.cpu().numpy().tobytes())
    caches = ST.zeros_caches(ct, dev)
    t0 = time.time()
    logits, caches = pre_fn(model, caches, tokens)
    logits, tok = greedy(logits)
    _sync(dev)
    prefill_s = time.time() - t0
    _say(f"prefill {args.batch}x{args.prompt_len} in {prefill_s:.3f}s")
    out = [tok.cpu().numpy()]
    t0 = time.time()
    for i in range(args.gen - 1):
        plan.update(out[-1].tobytes())
        logits, caches = dec_fn(model, caches, tok, args.prompt_len + i)
        logits, tok = greedy(logits)
        out.append(tok.cpu().numpy())
    _sync(dev)
    decode_s = time.time() - t0
    launches, comm, comm_axes = (_delta(a, b) for a, b in
                                 zip(_counters(), before))
    res = FixedResult(np.concatenate(out, axis=1), logits, prefill_s,
                      decode_s, launches, comm, comm_axes, plan.hexdigest(),
                      tokens.cpu().numpy())
    _say("generated ids:\n", res.ids)
    _say(f"decode: {args.gen - 1} steps x batch {args.batch} = "
         f"{res.decode_tokens_per_s:,.1f} tok/s")
    return res


def run_continuous(args, model=None):
    """Serve ``args.requests`` requests (with ``model``, or one built from
    the flags); returns (engine, stats, requests). The launch counts and
    collective counters are set to 0 just before the timed run."""
    from repro_torch.launch.serving import PagedEngine, ServeConfig

    if model is None:
        _, _, model = _setup(args)
    cfg, axes = model.cfg, model.axes
    scfg = ServeConfig(slots=args.slots, page_size=args.page_size,
                       pages_per_shard=args.pages, chunk=args.chunk)
    engine = PagedEngine(cfg, axes, model, scfg,
                         overlap=overlap_config(args))
    t0 = time.time()
    engine.warmup()
    _say(f"warmup in {time.time() - t0:.2f}s")
    reqs = make_requests(args, cfg.vocab_size)
    telem = None
    if (args.telemetry or args.log_file) and M.process_rank() == 0:
        from repro_torch.core import comm_model as CM
        from repro_torch.launch import telemetry as TL
        dev = engine.device
        telem = TL.Telemetry(
            f"serve-{cfg.name}-{time.strftime('%Y%m%d-%H%M%S')}",
            path=args.log_file,
            tokens_per_step=0,  # serve steps carry their own new_tokens
            flops_per_token=CM.model_flops_per_token(cfg, "serve"),
            peak_flops_per_device=TL.card_peak_flops(dev, "float32"),
            n_devices=(min(axes.world, torch.cuda.device_count())
                       if dev.type == "cuda" else 1),
            meta={"arch": cfg.name, "mesh": args.mesh, "mode": "continuous",
                  "slots": args.slots, "pages": args.pages,
                  "requests": args.requests, "rate": args.rate},
            device=dev)
    ops.reset_launches()
    M.reset_comm()
    stats = engine.run(reqs, telemetry=telem)
    if telem is not None:
        # the summary's tokens/s is the engine's open-loop figure, so the
        # JSONL agrees with the printed stats
        telem.close(extra={
            "tok_s": stats.tokens_per_s, "wall_s": stats.wall_s,
            "steps": stats.n_steps, "tokens": stats.total_new_tokens,
            "preemptions": stats.n_preemptions,
            "ttft_p50_ms": stats.ttft_p50_ms,
            "ttft_p99_ms": stats.ttft_p99_ms,
            "latency_p50_ms": stats.latency_p50_ms,
            "latency_p99_ms": stats.latency_p99_ms})
    for r in reqs[: min(4, len(reqs))]:
        _say(f"req {r.rid}: {np.asarray(r.generated, np.int32)}")
    _say(f"served {stats.n_requests} requests / "
         f"{stats.total_new_tokens} tokens in {stats.wall_s:.2f}s "
         f"({stats.n_steps} steps, {stats.n_preemptions} preemptions)")
    _say(f"tokens/s {stats.tokens_per_s:,.1f}  "
         f"latency p50/p99 {stats.latency_p50_ms:.1f}/"
         f"{stats.latency_p99_ms:.1f} ms  "
         f"ttft p50/p99 {stats.ttft_p50_ms:.1f}/"
         f"{stats.ttft_p99_ms:.1f} ms")
    return engine, stats, reqs


def _report(args, run, model, serve: dict, mine: dict) -> None:
    """Rank 0 prints ``{"serve": serve + every rank's report}``; ``mine``
    gains this rank's peak memory and parameter hash first."""
    dev = next(model.parameters()).device
    mine = dict(mine, rank=run["rank"], device=str(dev),
                max_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
                param_sha256=ST.param_sha256(model))
    ranks = [None] * run["world"]
    dist.all_gather_object(ranks, mine)
    _say(json.dumps({"serve": dict(
        serve, arch=model.cfg.name, mode=args.mode, mesh=args.mesh,
        backend=args.backend, overlap=args.overlap, ranks=ranks)}))


def main(argv=None, cfg=None):
    """Serve as the flags ``argv`` say; ``cfg``: the model's config in
    place of ``--arch`` and ``--preset``'s (a caller cutting its depth)."""
    args = build_parser().parse_args(argv)
    axes = _refuse_unported(args)
    run = init_mesh(axes, backend=args.backend, device=args.device)
    try:
        _serve(args, run, cfg)
    finally:
        close_mesh()


def _serve(args, run, cfg=None) -> None:
    _, _, model = _setup(args, run["device"], cfg)
    if args.mode == "fixed":
        res = run_fixed(args, model)
        logits = res.logits
        lat = (res.prefill_s + res.decode_s) * 1e3
        serve = dict(ids=res.ids.tolist(),
                     tokens_per_s=res.decode_tokens_per_s,
                     ttft_p50_ms=res.prefill_s * 1e3,
                     ttft_p99_ms=res.prefill_s * 1e3, latency_p50_ms=lat,
                     latency_p99_ms=lat, prefill_s=res.prefill_s,
                     decode_s=res.decode_s)
        mine = dict(n_steps=args.gen, launches=res.launches, comm=res.comm,
                    comm_axes=res.comm_axes, plan_sha256=res.plan_sha256)
    else:
        engine, stats, reqs = run_continuous(args, model)
        logits = engine.last_logits
        serve = dict(ids=[r.generated for r in reqs],
                     tokens_per_s=stats.tokens_per_s,
                     ttft_p50_ms=stats.ttft_p50_ms,
                     ttft_p99_ms=stats.ttft_p99_ms,
                     latency_p50_ms=stats.latency_p50_ms,
                     latency_p99_ms=stats.latency_p99_ms,
                     wall_s=stats.wall_s,
                     n_preemptions=stats.n_preemptions)
        mine = dict(n_steps=stats.n_steps, launches=ops.launches(),
                    comm=copy.deepcopy(M.COMM),
                    comm_axes=copy.deepcopy(M.COMM_AXES),
                    plan_sha256=engine.plan_hash.hexdigest())
    if not torch.isfinite(logits).all():
        raise RuntimeError("non-finite logits")
    if run["world"] > 1:
        _report(args, run, model, serve, mine)
    _say("SERVE OK")


if __name__ == "__main__":
    main()
