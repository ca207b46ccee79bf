"""Training entry point of the port: the 4D-hybrid train step on one
device, or on a mesh of ranks (data, x, y, z and seq above 1).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --preset full --steps 3 --batch 4 --seq 512 --overdecompose 2

runs on the CUDA card; ``--device cpu --preset smoke`` runs on the CPU.
Each step splits the batch into ``--overdecompose`` microbatches, runs
their forward and backward (blocks rematerialized), accumulates the
gradients in fp32 and applies AdamW, as the JAX package's
``make_train_step`` does in its plain mode. The data is the JAX package's
synthetic Markov text (``data/synthetic.py``).

``--mesh d,x,y,z[,seq]`` runs one process per rank of the mesh under
``torch.distributed.run``, with the blocking collective schedule of the
JAX step's plain mode: each rank draws its block of every weight from the
seed (by its PartitionSpec), the batch splits over data and z, the
features and heads over x, y and z, a fifth factor splits each sequence
over a seq axis (context parallelism, attention through kernel K4):

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.launch.train --arch qwen3-1.7b \\
      --preset full --mesh 1,2,2,2 --steps 3 --batch 4 --seq 512 \\
      --backend gloo

Every rank builds the same global batch, stripes it and trains on its
shard; ranks beyond the card count share cards, and their collectives go
through host memory (gloo). Only rank 0 prints; its last line is one JSON
object with the losses, step times and each rank's communication by kind
and by axis (and the ring hops of the overlapped schedule by axis), peak
memory, kernel launches and parameter hash.

``--zero`` runs the bucketed data-parallel sync with ZeRO-1 sharded AdamW
state (``core/gradsync.py``, buckets of ``--dp-bucket-mb`` MiB);
``--zero3`` also shards the parameters over data (each part sharded as
it is drawn; each layer's weights gathered just in time in the forward
and again in remat's recompute, the gradient reduce-scattered by the
gather's backward), and ``--zero3-prefetch`` posts layer i+1's gathers
before layer i computes and keeps the copy on the host for the backward;
``--ckpt PATH`` saves a checkpoint in the reference's ``.npz`` format at
the end (and every ``--ckpt-every`` steps); ``--resume`` restores it first
and continues from the saved step + 1, on any mesh (the state re-shards
through the replicated checkpoint layout):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --preset smoke --device cpu --steps 4 --zero --ckpt run.npz

``--calib <path|auto>`` prices this run with the analytical model
(``core/comm_model.predict_step_time``) on a profile that
``launch/calibrate.py`` fitted, before the first step, and prints the
predicted step against the measured one at the end (``calib[...]:``);
``--telemetry`` writes rank 0's per-step JSONL (``launch/telemetry.py``:
step time, tokens/s, MFU, loss, grad norm, peak memory and, with
``--calib``, the drift of measured over predicted, which is merged into
the profile's ``probes`` at the end) to ``runs/telemetry/<run>.jsonl`` or
``--log-file``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --preset smoke --device cpu --steps 4 --calib runs/calib/cpu.json \
      --telemetry --log-file run.jsonl

``--profile-steps A:B`` captures a ``torch.profiler`` trace of steps A
to B (inclusive) with the trace scopes of ``core/trace.py`` enabled, so
the ring hops, buckets and gathers are named ranges in it: each rank
writes ``runs/profiles/<run>/rank<r>.json`` (a chrome trace), and the
window's collectives are recorded by ``launch/roofline.record_collectives``
into each rank's ``comm_by_scope`` (calls and bytes by scope class, kind,
group size and axis) and ``collectives`` (counts and wire bytes by kind)
in the ``{"train"}`` line:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --preset smoke --device cpu --steps 3 --profile-steps 1:1

Not ported yet (each raises ``NotImplementedError`` naming the ROADMAP.md
§1 item it waits for): the elastic half of the runtime tooling
(``--chaos``, ``--probe-every``) and ``--backend nccl``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import resource
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import calibrate as CB
from repro_torch.core import comm_model as CM
from repro_torch.core import gradsync as GS
from repro_torch.core import mesh as M
from repro_torch.core import trace
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import param_spec, spec_names
from repro_torch.data.synthetic import DataConfig, SyntheticText, make_batch
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch import roofline as RL
from repro_torch.launch import telemetry as TL
from repro_torch.launch.mesh import close_mesh, init_mesh, mesh_axes
from repro_torch.launch.steps import param_sha256
from repro_torch.optim.adamw import AdamWConfig, init_state

# flag -> the ROADMAP.md §1 item it waits for
REFUSED = {
    "chaos": "runtime tooling",
    "probe_every": "runtime tooling",
}


def preset_config(cfg, preset: str):
    """Model-size presets, as in ``repro.launch.train``."""
    if preset == "full":
        return cfg
    if preset == "smoke":
        return cfg.reduced()
    if preset == "100m":
        # ~100M-param member of the same family (a dense decoder: at least
        # 4 layers)
        return dataclasses.replace(
            cfg.reduced(), name=cfg.name + "-100m", d_model=512,
            n_heads=8, n_kv_heads=min(8, cfg.n_kv_heads), head_dim=64,
            d_ff=2048, vocab_size=32000,
            n_layers=max(cfg.reduced().n_layers, 4))
    raise ValueError(preset)


def profile_window(args) -> Optional[tuple]:
    """``--profile-steps A:B`` as (A, B), or None without the flag; exits
    with the reference's message unless 0 <= A <= B."""
    if not args.profile_steps:
        return None
    a, _, b = args.profile_steps.partition(":")
    window = (int(a), int(b))
    if not (0 <= window[0] <= window[1]):
        raise SystemExit(f"--profile-steps {args.profile_steps}: "
                         f"need 0 <= A <= B")
    return window


def grad_sync_config(args) -> GS.GradSyncConfig:
    """The data-parallel sync of ``--zero``, ``--zero3`` and their
    options."""
    if args.zero3:
        return GS.GradSyncConfig(zero3=True, prefetch=args.zero3_prefetch,
                                 bucket_mb=args.dp_bucket_mb)
    if args.zero:
        return GS.GradSyncConfig(zero=True, bucket_mb=args.dp_bucket_mb)
    return GS.GradSyncConfig()


def predict_step(prof: CB.CalibrationProfile, args, cfg,
                 overlap: OverlapConfig = OverlapConfig()) -> CM.StepTime:
    """The analytical model's step time of the run that the flags ``args``
    make of ``cfg`` under the schedule ``overlap``, priced with the
    calibration profile ``prof`` at the run's dtype: the reference
    trainer's ``predict_step_time`` of ``comm_layers()``, the global batch
    in tokens, the mesh, the data-parallel sync and the microbatches."""
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    hw = dataclasses.replace(
        prof.hardware_params(),
        bytes_per_elem=float(torch.empty((), dtype=dtype).element_size()))
    return CM.predict_step_time(
        list(cfg.comm_layers()), args.batch * args.seq,
        CM.Decomposition(*mesh_axes(args.mesh).sizes), hw,
        gradsync=grad_sync_config(args), microbatches=args.overdecompose,
        overlap=overlap if overlap.any_enabled else None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="4D-hybrid training steps on the CUDA card (or "
                    "--device cpu).")
    ap.add_argument("--arch", required=True,
                    help="architecture name (repro_torch.configs)")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"],
                    help="model-size preset")
    ap.add_argument("--steps", type=int, default=100,
                    help="optimizer steps")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (sequences)")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length (tokens)")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="peak AdamW learning rate")
    ap.add_argument("--mesh", default="1,1,1,1",
                    help="g_data,g_x,g_y,g_z[,g_seq] (a mesh of more than "
                         "one rank runs one process per rank under "
                         "torch.distributed.run)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="torch.distributed backend of a mesh with more "
                         "than one rank (gloo; nccl is not ported)")
    ap.add_argument("--overdecompose", type=int, default=2,
                    help="microbatch count of the overdecompose loop")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="parameter and activation dtype")
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between metric log lines")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-sharded DP sync: bucketed gradient "
                         "reduce-scatter rings streamed through the "
                         "overdecompose loop, AdamW state sharded over "
                         "the data axis (core/gradsync.py)")
    ap.add_argument("--zero3", action="store_true",
                    help="ZeRO-3 param-shard streaming: params live as "
                         "1/G_data shards, each layer's working copy "
                         "ring-all-gathered just-in-time in the forward "
                         "(core/gradsync.py); implies the --zero state "
                         "sharding")
    ap.add_argument("--zero3-prefetch", action="store_true",
                    help="with --zero3: post layer i+1's gathers before "
                         "layer i computes; the copy is kept (on the host) "
                         "for the backward, no re-gather")
    ap.add_argument("--dp-bucket-mb", type=float, default=4.0,
                    help="fp32 gradient bucket bound in MiB "
                         "(with --zero/--zero3)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint path (.npz) to save at the end "
                         "(atomic write + per-leaf checksums; see also "
                         "--ckpt-every / --resume)")
    ap.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                    help="also checkpoint every N steps (0 = off); the "
                         "write is atomic, so a crash mid-save keeps "
                         "the previous checkpoint")
    ap.add_argument("--resume", action="store_true",
                    help="restore from --ckpt before training (verifies "
                         "checksums first) and continue from the saved "
                         "step; the mesh may differ from the saving "
                         "run's — the state re-shards through the "
                         "replicated checkpoint layout")
    ap.add_argument("--calib", default="", metavar="PATH|auto",
                    help="price this run with the analytical model on a "
                         "calibration profile (launch/calibrate.py; 'auto' "
                         "= runs/calib/<backend>.json if present): the "
                         "predicted step time, printed against the measured "
                         "one at the end, and the drift with --telemetry")
    ap.add_argument("--telemetry", action="store_true",
                    help="per-step JSONL telemetry to runs/telemetry/"
                         "<run>.jsonl (launch/telemetry.py, rank 0): step "
                         "time EMA + p50/p99, tokens/s, MFU, loss/grad-norm, "
                         "peak device bytes, and, with --calib, the "
                         "predicted-vs-measured drift ratio")
    ap.add_argument("--log-file", default="",
                    help="telemetry JSONL path (implies --telemetry; "
                         "default runs/telemetry/<run>.jsonl)")
    ap.add_argument("--profile-steps", default="", metavar="A:B",
                    help="capture a torch.profiler trace of steps A..B "
                         "(inclusive) to runs/profiles/<run>/rank<r>.json, "
                         "with named-scope attribution (core/trace.py) "
                         "enabled so ring hops/buckets/gathers are labeled "
                         "in the trace, and the window's collectives "
                         "counted by scope (launch/roofline.py)")
    # flags of repro.launch.train that the port refuses (REFUSED)
    ap.add_argument("--chaos", default="", help="not ported")
    ap.add_argument("--probe-every", type=int, default=0, help="not ported")
    return ap


@dataclasses.dataclass
class TrainResult:
    """What a run of :func:`main` measured, step by step, on this rank."""
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]          # wall time of each step, synchronized
    tokens_per_step: int
    n_params: int
    max_memory_bytes: Optional[int]   # CUDA only
    # this process's peak resident host memory (getrusage), at the end
    max_rss_bytes: Optional[int] = None
    # collectives of each step: host-clock seconds and bytes, in all, by
    # kind of collective and by axis ({kind or axis: {"seconds", "bytes",
    # "calls"}})
    comm_s: List[float] = dataclasses.field(default_factory=list)
    comm_bytes: List[int] = dataclasses.field(default_factory=list)
    comm_by_kind: List[dict] = dataclasses.field(default_factory=list)
    comm_by_axis: List[dict] = dataclasses.field(default_factory=list)
    # the ring hops of each step by axis, counted in comm_by_axis too
    hops_by_axis: List[dict] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the bucketed sync's data-axis traffic of each step
    # (gradsync.DP_SYNC: {"reduce_scatter" | "all_gather": {"calls",
    # "bytes", "seconds"}})
    dp_sync: List[dict] = dataclasses.field(default_factory=list)
    # this rank's persistent state in bytes (steps.state_layouts)
    state_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the checkpoint: {"bytes", "save_s": [...], "restore_s"} (--ckpt)
    ckpt: Dict[str, object] = dataclasses.field(default_factory=dict)
    first_step: int = 0          # the step this run started at
    # the analytical model's step time for this run under --calib
    # ({"total", "compute", "exposed_comm", "hidden_comm"} in seconds)
    predicted: Optional[Dict[str, float]] = None
    # --profile-steps: the window (A, B), the directory of the rank traces,
    # and the window's collectives as the dispatch hook recorded them: by
    # scope (roofline.scope_rows), their CollectiveStats ({"counts",
    # "bytes_by_kind"}) and the same ops in mesh.COMM's terms
    # (roofline.mesh_totals)
    profile: Optional[Dict[str, object]] = None
    comm_by_scope: List[dict] = dataclasses.field(default_factory=list)
    collectives: Optional[Dict[str, dict]] = None
    collectives_mesh: Optional[Dict[str, dict]] = None
    # every rank's report (the "ranks" list of the JSON line)
    ranks: List[dict] = dataclasses.field(default_factory=list)


def _ckpt_snapshot(path: str, model) -> dict:
    """Load a checkpoint into the host replicated-layout snapshot form of
    ``launch.steps.snapshot_state`` — verifying every leaf's checksum
    first, so a corrupt file is rejected with the offending leaf named
    instead of scattering garbage onto the mesh."""
    ckpt.verify(path)
    params, step = ckpt.restore(path, convert.jax_structs(model))
    state, _ = ckpt.restore(path, convert.jax_opt_structs(model),
                            root="opt_state")
    return {"params": params, "opt_state": state, "step": int(step),
            "fingerprint": None}


def main(argv=None, cfg=None, overlap: OverlapConfig = OverlapConfig(), *,
         stop_after: Optional[int] = None) -> TrainResult:
    """Train as the flags ``argv`` say; ``cfg``, when given, is the model's
    configuration in place of ``--arch`` and ``--preset``'s (a cut of a
    supported model's depth, say). ``overlap`` is the step's overlapped
    schedule (``TrainOptions.overlap``; the JAX driver has no flag for it,
    nor has this one). ``stop_after``: end this run after that many steps,
    as a run stopped early (the reference's shutdown on a signal) does:
    the final checkpoint holds the last step run, and ``--resume`` with
    the same flags continues the schedule of ``--steps``."""
    args = build_parser().parse_args(argv)
    for flag, item in REFUSED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to PyTorch yet: "
                f"it waits for the ROADMAP.md §1 item '{item}'")
    profile_window(args)
    if args.resume and not args.ckpt:
        raise SystemExit("--resume needs --ckpt")
    axes = mesh_axes(args.mesh)
    cfg = cfg or preset_config(get_config(args.arch), args.preset)
    run = init_mesh(axes, backend=args.backend, device=args.device)
    try:
        return train_on(args, axes, cfg, run, overlap, stop_after)
    finally:
        close_mesh()


def train_on(args, axes, cfg, run, overlap: OverlapConfig = OverlapConfig(),
             stop_after: Optional[int] = None) -> TrainResult:
    """Train on the mesh ``axes`` that ``launch.mesh.init_mesh`` set up
    (its ``run``) as the parsed flags ``args`` say: :func:`main`, after it
    checks the flags and sets up the mesh. A caller that trains several
    runs on one mesh calls it once a run."""
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    rank0, multi = run["rank"] == 0, run["world"] > 1
    window = profile_window(args)

    def say(*a, **kw):
        if rank0:
            print(*a, **kw, flush=True)
    # the calibration profile first: a bad --calib path fails before the
    # model is built; 'auto' with no profile saved runs uncalibrated
    prof = CB.resolve(args.calib) if args.calib else None
    if args.calib and prof is None:
        say(f"calib[{args.calib}]: no profile at {CB.default_path()}; "
            f"no prediction")
    gs = grad_sync_config(args)
    model = ST.init_model(cfg, axes, seed=0, device=run["device"],
                          dtype=dtype, zero3=gs.zero3)
    dev = model.device
    params = dict(model.named_parameters())
    # the global count: each block times the ranks it is split over
    n_params = sum(p.numel() * axes.size(spec_names(param_spec(n)))
                   for n, p in params.items())
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M mesh={args.mesh} "
        f"device={dev}")
    if multi:
        say(f"backend={args.backend} "
            f"ranks_per_card={run['ranks_per_card'] or '-'} "
            f"ranks={run['world']}")
    topts = ST.TrainOptions(overdecompose=args.overdecompose, dtype=dtype,
                            overlap=overlap, gradsync=gs)
    tools = (ST.make_gradsync_tools(cfg, axes, params, topts)
             if gs.state_sharded else None)
    if gs.state_sharded:
        state = tools.init(model.shards if gs.zero3 else params)
    else:
        state = init_state(params)
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                      total_steps=args.steps)
    step_fn = ST.make_train_step(cfg, axes, opt, topts, tools=tools)
    tokens = args.batch * args.seq
    res = TrainResult([], [], [], tokens, n_params, None)
    pred = None
    if prof is not None:
        # the α-β model's step time for THIS run: seeds the drift monitor
        # and the end-of-run print
        pred = predict_step(prof, args, cfg, overlap)
        res.predicted = dict(dataclasses.asdict(pred), total=pred.total)
    telem = None
    if (args.telemetry or args.log_file) and rank0:
        cards = (min(run["world"], torch.cuda.device_count())
                 if dev.type == "cuda" else 1)
        telem = TL.Telemetry(
            f"{cfg.name}-{time.strftime('%Y%m%d-%H%M%S')}",
            path=args.log_file or None, tokens_per_step=tokens,
            flops_per_token=CM.model_flops_per_token(cfg),
            # a profile's rate is one rank's (its share of a shared card);
            # without one, the card's own peak for the dtype, per card
            peak_flops_per_device=(prof.flops if prof is not None
                                   else TL.card_peak_flops(dev, args.dtype)),
            n_devices=run["world"] if prof is not None else cards,
            drift=(TL.DriftMonitor(pred.total)
                   if pred is not None and pred.total > 0 else None),
            meta={"arch": cfg.name, "mesh": [int(x) for x in
                                             args.mesh.split(",")],
                  "n_devices": run["world"], "batch": args.batch,
                  "seq": args.seq, "dtype": args.dtype,
                  "calib": args.calib or None}, device=dev)
    res.state_bytes = ST.state_layouts(cfg, axes, params, topts)
    specs = convert.jax_specs(model)

    def save_checkpoint(at_step: int) -> None:
        # every rank takes part in the gathers, only rank 0 writes; a
        # sharded opt state travels in the replicated per-leaf layout so
        # the run can resume under a different g_data
        t0 = time.perf_counter()
        snap = ST.snapshot_state(model, state, tools, topts, step=at_step,
                                 keep=rank0)
        if rank0:
            # the reference's trainer: its save_sharded adds "zero"
            ckpt.save(args.ckpt, snap["params"], snap["opt_state"],
                      step=at_step, pspecs=specs, extra=dict(
                          dp_bucket_mb=args.dp_bucket_mb, zero3=gs.zero3,
                          mesh=[int(x) for x in args.mesh.split(",")],
                          zero=True) if gs.state_sharded else None)
        del snap
        if multi:
            dist.barrier()
        res.ckpt.setdefault("save_s", []).append(time.perf_counter() - t0)
        if rank0:
            path = args.ckpt if args.ckpt.endswith(".npz") \
                else args.ckpt + ".npz"
            res.ckpt["bytes"] = os.path.getsize(path)

    start_step = 0
    if args.resume:
        t0 = time.perf_counter()
        snap = _ckpt_snapshot(args.ckpt, model)
        state = ST.restore_state(snap, cfg, axes, tools, topts, model)
        start_step = snap["step"] + 1
        del snap
        res.ckpt["restore_s"] = time.perf_counter() - t0
        say(f"resumed {args.ckpt} at step {start_step - 1} "
            f"(mesh {args.mesh})")
    res.first_step = start_step
    data = SyntheticText(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))
    cuda = dev.type == "cuda"
    prof_dir, profiling, traced = None, None, trace.enabled()
    if window is not None:
        # every rank names the run by rank 0's clock
        stamp = time.localtime(M.from_rank0(time.time()))
        prof_dir = os.path.join(
            "runs", "profiles",
            f"{cfg.name}-{time.strftime('%Y%m%d-%H%M%S', stamp)}")
        # the captured window attributes its ring hops
        trace.enable()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    M.reset_comm()
    GS.reset_dp_sync()
    last = args.steps if stop_after is None else min(
        args.steps, start_step + stop_after)
    t_warm = t_step = None     # after this run's first step; the last one
    for step in range(start_step, last):
        if window is not None and step == window[0]:
            profiling = _start_profile(cuda)
        batch = ST.stripe_batch(
            {k: torch.from_numpy(v).to(dev) for k, v in
             make_batch(cfg, step, data, dtype=np.float32).items()}, axes)
        comm0 = copy.deepcopy((M.COMM, M.COMM_AXES, M.HOPS, GS.DP_SYNC))
        t0 = time.perf_counter()
        metrics = step_fn(model, state, batch)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        if cuda:
            torch.cuda.synchronize(dev)
        res.step_s.append(time.perf_counter() - t0)
        by_kind, by_axis, hops, dp_sync = (
            {k: {n: c[n] - before.get(k, {}).get(n, 0) for n in c}
             for k, c in now.items()}
            for now, before in zip((M.COMM, M.COMM_AXES, M.HOPS,
                                    GS.DP_SYNC), comm0))
        res.comm_by_kind.append(by_kind)
        res.comm_by_axis.append(by_axis)
        res.hops_by_axis.append(hops)
        res.dp_sync.append(dp_sync)
        res.comm_s.append(sum(c["seconds"] for c in by_kind.values()))
        res.comm_bytes.append(sum(c["bytes"] for c in by_kind.values()))
        res.losses.append(loss)
        res.grad_norms.append(gn)
        if profiling is not None and step == window[1]:
            _stop_profile(profiling, res, window, prof_dir, run["rank"], say)
            profiling = None
        now = time.time()
        if t_warm is None:
            # the first step pays the kernels' first calls: not timed
            t_warm = now
        elif telem is not None:
            telem.train_step(step, now - t_step, loss=loss, grad_norm=gn)
        t_step = now
        if not np.isfinite(loss):
            raise RuntimeError(f"step {step}: non-finite loss {loss}")
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} gnorm {gn:.3f} "
                f"{tokens / res.step_s[-1]:,.0f} tok/s "
                f"({res.step_s[-1] * 1e3:.1f} ms"
                + (f", comm {res.comm_s[-1] * 1e3:.1f} ms"
                   if multi else "") + ")")
        if (args.ckpt and args.ckpt_every > 0 and step > 0
                and step % args.ckpt_every == 0):
            save_checkpoint(step)
    if profiling is not None:
        # the window ran off the end of the run (B >= the last step)
        if cuda:
            torch.cuda.synchronize(dev)
        _stop_profile(profiling, res, window, prof_dir, run["rank"], say)
    if window is not None:
        trace.enable(traced)
    res.launches = ops.launches()
    if cuda:
        res.max_memory_bytes = torch.cuda.max_memory_allocated(dev)
    if pred is not None and len(res.losses) > 1:
        # the α-β model priced with the --calib profile against this run's
        # wall clock (the first step excluded)
        measured_s = (t_step - t_warm) / (len(res.losses) - 1)
        say(f"calib[{args.calib}]: predicted step {pred.total * 1e3:.2f} ms "
            f"(compute {pred.compute * 1e3:.2f} + exposed "
            f"{pred.exposed_comm * 1e3:.2f}), measured "
            f"{measured_s * 1e3:.2f} ms/step")
    if telem is not None:
        telem.close()
        if telem.drift is not None and telem.drift.n:
            # fold the measured/predicted verdict into the profile's probes
            # as it is now (the fitted constants stay untouched)
            path = CB.default_path() if args.calib == "auto" else args.calib
            CB.merge_drift(CB.resolve(path), telem.drift.record(
                workload=f"{cfg.name}@{args.mesh}")).save(path)
            say(f"drift record merged into {path}")
    # the final save comes after the timed window
    if args.ckpt and res.losses:
        save_checkpoint(start_step + len(res.losses) - 1)
        say("saved", args.ckpt)
    res.max_rss_bytes = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    mine = dict(rank=run["rank"], device=str(dev), comm_s=res.comm_s,
                comm_bytes=res.comm_bytes, comm_by_kind=res.comm_by_kind,
                comm_by_axis=res.comm_by_axis,
                hops_by_axis=res.hops_by_axis,
                max_memory_bytes=res.max_memory_bytes,
                max_rss_bytes=res.max_rss_bytes, launches=res.launches, dp_sync=res.dp_sync,
                state_bytes=res.state_bytes,
                param_sha256=param_sha256(model) if multi else None,
                comm_by_scope=res.comm_by_scope,
                collectives=res.collectives,
                collectives_mesh=res.collectives_mesh)
    res.ranks = [mine]
    if multi:
        res.ranks = [None] * run["world"]
        dist.all_gather_object(res.ranks, mine)
    if res.losses:
        say("final loss:", res.losses[-1])
    say(json.dumps({"train": dict(
        arch=cfg.name, mesh=args.mesh, backend=args.backend if multi
        else None, zero=args.zero, zero3=gs.zero3, prefetch=gs.prefetch,
        first_step=start_step, predicted=res.predicted,
        profile=res.profile, losses=res.losses, grad_norms=res.grad_norms,
        step_s=res.step_s, tokens_per_step=tokens, n_params=n_params,
        ckpt=res.ckpt, ranks=res.ranks)}))
    return res


def _start_profile(cuda: bool) -> contextlib.ExitStack:
    """A ``torch.profiler`` capture (the CPU, and the card's kernels on
    it) and the collective hook, started; both end when the returned
    stack closes, the hook's ops in its ``ops``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    stack = contextlib.ExitStack()
    stack.prof = stack.enter_context(torch.profiler.profile(
        activities=acts, record_shapes=False))
    stack.ops = stack.enter_context(RL.record_collectives())
    return stack


def _stop_profile(stack: contextlib.ExitStack, res: TrainResult, window,
                  prof_dir: str, rank: int, say) -> None:
    """End the capture: this rank's chrome trace written to
    ``prof_dir/rank<rank>.json``, the window's collectives into ``res``."""
    stack.close()
    os.makedirs(prof_dir, exist_ok=True)
    stack.prof.export_chrome_trace(os.path.join(prof_dir, f"rank{rank}.json"))
    stats = RL.collective_stats(stack.ops)
    res.profile = {"steps": list(window), "dir": prof_dir}
    res.comm_by_scope = RL.scope_rows(stack.ops)
    res.collectives = dataclasses.asdict(stats)
    res.collectives_mesh = RL.mesh_totals(stack.ops)
    say(f"profile: steps {window[0]}..{window[1]} -> {prof_dir}")


if __name__ == "__main__":
    main()
