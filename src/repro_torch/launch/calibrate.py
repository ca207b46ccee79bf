"""Hardware calibration of the port: measure, fit, save, validate (the
counterpart of the JAX package's ``benchmarks/calibrate.py``).

Times the port's collectives over its gloo process groups and kernel K1
(``core/calibrate.py``), least-squares-fits γ/α/β per mesh axis and over
all of them, K1's GEMM rate and the overlap and cross-step efficiencies,
and saves a ``CalibrationProfile`` JSON that ``train.py --calib
<path|auto>`` loads back into the analytical model's ``HardwareParams``.
One process a rank, under ``torch.distributed.run``; rank 0 writes the
profile and prints:

  # eight ranks sharing the card, saved to runs/calib/cuda.json:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.launch.calibrate --mesh 1,2,2,2

  # on the CPU (runs/calib/cpu.json), fewer sizes and repetitions:
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.launch.calibrate --mesh 1,2,2,2 \\
      --device cpu --quick

``--validate`` then trains the same model under the 7 decompositions of 8
ranks of the reference's ``benchmarks/measured.fig5_measured`` at S in
{64, 128, 256}, batch 8, one microbatch, timed in 3 interleaved rounds
(the min over rounds of each configuration's max over ranks), and prints
the reference's rows: each configuration's step time, the measured
``best``, the model's ``predicted_best`` and the Spearman correlations of
predicted against measured step times over the whole grid
(``rank_correlation``) and over the decompositions at S = 64
(``rank_correlation_decomp``). One departure: the model is
``qwen3-1.7b`` at ``--preset smoke`` (``ArchConfig.reduced()``), not
``stablelm-1.6b``. All the
decompositions run in this one world of 8 ranks: each one's process
groups are made once (``core.mesh.init_groups``) and brought back
between rounds (``core.mesh.save_groups``/``restore_groups``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import calibrate as CB
from repro_torch.core import comm_model as CM
from repro_torch.core import mesh as M
from repro_torch.launch.mesh import close_mesh, init_mesh, mesh_axes

# the default mesh of each world size (the reference's run_calibration)
DEFAULT_MESHES = {8: "1,2,2,2", 4: "1,1,2,2", 2: "2,1,1,1"}
# the measured grid of the reference's fig5_measured
FIG5_SHAPES = [("gdata4_gy2", (4, 1, 2, 1)),
               ("gdata2_gx2_gy2", (2, 2, 2, 1)),
               ("gdata2_gy4", (2, 1, 4, 1)),
               ("gdata2_gy2_gz2", (2, 1, 2, 2)),
               ("gdata1_gy4_gz2", (1, 1, 4, 2)),
               ("gdata2_gy2_gseq2", (2, 1, 2, 1, 2)),
               ("gdata1_gy2_gseq4", (1, 1, 2, 1, 4))]
FIG5_SEQS = (64, 128, 256)
FIG5_BATCH = 8
FIG5_ARCH = "qwen3-1.7b"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.calibrate",
        description="Measure collective γ/α/β, K1's GEMM rate and overlap "
                    "efficiencies on this world's ranks; fit and save a "
                    "CalibrationProfile for train.py --calib.")
    ap.add_argument("--out", default="",
                    help="profile path (default runs/calib/<backend>.json)")
    ap.add_argument("--mesh", default="",
                    help="g_data,g_x,g_y,g_z[,g_seq] over the world's ranks "
                         "(default: the reference's mesh for the world "
                         "size, 1,2,2,2 for 8)")
    ap.add_argument("--sizes", default="4096,16384,65536,262144",
                    help="message-size sweep in buffer elements")
    ap.add_argument("--reps", type=int, default=5,
                    help="timing repetitions per point (min is kept)")
    ap.add_argument("--quick", action="store_true",
                    help="first 3 sizes, fewer reps")
    ap.add_argument("--no-samples", action="store_true",
                    help="omit the raw timing samples from the JSON")
    ap.add_argument("--validate", action="store_true",
                    help="after fitting, train the fig5 decomposition grid "
                         "and report the predicted-vs-measured step-time "
                         "rank correlation (needs 8 ranks)")
    ap.add_argument("--steps", type=int, default=6,
                    help="train steps per timing round in --validate")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ranks (default: the card)")
    return ap


def _say(*a) -> None:
    if M.process_rank() == 0:
        print(*a, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fig5_run(cfg, axes, S: int, steps: int, device) -> dict:
    """The reference's ``_train_setup`` for one configuration: the model
    from seed 0 (this rank's blocks), AdamW (lr 1e-3, 2 warm-up steps),
    one microbatch in float32, a batch of FIG5_BATCH random sequences of S
    tokens from numpy seed 0, striped on a seq axis; then one warm-up
    step (its metrics in "metrics")."""
    from repro_torch.launch import steps as ST
    from repro_torch.optim.adamw import AdamWConfig, init_state
    model = ST.init_model(cfg, axes, seed=0, device=device)
    state = init_state(dict(model.named_parameters()))
    fn = ST.make_train_step(
        cfg, axes, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps),
        ST.TrainOptions(overdecompose=1, dtype=torch.float32))
    rng = np.random.RandomState(0)
    batch = ST.stripe_batch({k: torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (FIG5_BATCH, S)).astype(np.int32)).to(device)
        for k in ("tokens", "labels")}, axes)
    return dict(fn=fn, model=model, state=state, batch=batch,
                metrics=fn(model, state, batch))


def fig5_measured(steps: int = 6, calib: str = None, device="cuda"
                  ) -> List[Tuple[str, float, str]]:
    """The reference's ``fig5_measured`` on this world's 8 ranks: step time
    in µs of each (decomposition, S), measured and predicted by the
    analytical model priced with the profile ``calib``; the same rows.
    Every rank calls it and gets the same rows."""
    from repro_torch.configs import get_config
    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    shapes = [(n, s) for n, s in FIG5_SHAPES if int(np.prod(s)) == world]
    if not shapes:
        return [("fig5_measured/skipped", 0.0,
                 f"needs 8 ranks, have {world}")]
    cfg = get_config(FIG5_ARCH).reduced()
    seqs = FIG5_SEQS
    groups, runs = {}, {}
    for name, shape in shapes:
        axes = M.MeshAxes(shape)
        M.init_groups(axes)
        for S in seqs:
            runs[(name, S)] = _fig5_run(cfg, axes, S, steps, device)
        groups[name] = M.save_groups()
    # time every configuration in interleaved rounds (min over rounds):
    # load drifting during the sweep would otherwise correlate with
    # whichever configuration ran under it
    times = {key: [] for key in runs}
    for _ in range(3):
        for name, _shape in shapes:
            M.restore_groups(groups[name])
            for S in seqs:
                r = runs[(name, S)]
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(steps):
                    r["metrics"] = r["fn"](r["model"], r["state"],
                                           r["batch"])
                    float(r["metrics"]["loss"])
                _sync(device)
                times[(name, S)].append((time.perf_counter() - t0) / steps)
            groups[name] = M.save_groups()
    keys = [(name, S) for name, _ in shapes for S in seqs]
    # each round's time is its slowest rank's
    t = torch.tensor([times[k] for k in keys], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    results = {k: float(t[i].min()) * 1e6 for i, k in enumerate(keys)}
    rows = [(f"fig5_measured/{name}_s{S}", results[(name, S)],
             f"loss={float(runs[(name, S)]['metrics']['loss']):.3f}")
            for name, S in keys]
    base = {name: results[(name, seqs[0])] for name, _ in shapes}
    best = min(base, key=base.get)
    rows.append(("fig5_measured/best", base[best],
                 f"config={best} (S={seqs[0]})"))
    # the predicted grid, wire bytes priced at the measured run's dtype
    # (float32)
    hw = dataclasses.replace(CB.resolve_hw(calib), bytes_per_elem=4.0)
    layers = list(cfg.comm_layers())
    pred = {(name, S): CM.predict_step_time(
        layers, FIG5_BATCH * S, CM.Decomposition(*shape), hw).total
        for name, shape in shapes for S in seqs}
    pbase = {name: pred[(name, seqs[0])] for name, _ in shapes}
    pbest = min(pbase, key=pbase.get)
    rows.append(("fig5_measured/predicted_best", pbase[pbest] * 1e6,
                 f"config={pbest} measured_best={best} "
                 f"agree={pbest == best}"))
    rho = CB.spearman([results[k] for k in keys], [pred[k] for k in keys])
    rows.append(("fig5_measured/rank_correlation", rho,
                 f"calib={calib or 'none'} n={len(keys)} "
                 f"spearman(predicted, measured) over decomposition x "
                 f"seq grid"))
    names = [n for n, _ in shapes]
    rho_d = CB.spearman([base[n] for n in names], [pbase[n] for n in names])
    rows.append(("fig5_measured/rank_correlation_decomp", rho_d,
                 f"decompositions only at S={seqs[0]} (n={len(names)}; "
                 f"near-tied configurations are noisy by construction)"))
    return rows


def report(prof: CB.CalibrationProfile, out: str) -> None:
    """The reference's printout of a fitted profile, with the ranks per
    card beside the GEMM rate and each kind's counted ring hops against
    the port's code's count (``calibrate.ring_hops``)."""
    print(f"backend={prof.backend} devices={prof.n_devices} "
          f"mesh={prof.mesh_shape}")
    per_card = prof.probes.get("ranks_per_card")
    print(f"alpha={prof.alpha:.3e} s/hop  gamma={prof.gamma:.3e} s/call  "
          f"link_bw={prof.link_bw:.3e} B/s  "
          f"flops={prof.flops:.3e} FLOP/s  (fit r2={prof.fit_r2:.3f})"
          + (f"  [flops: one of {per_card:g} ranks sharing the card]"
             if per_card else ""))
    for f in prof.axis_fits:
        print(f"  axis {f.axis} (p={f.p}): alpha={f.alpha:.3e} "
              f"gamma={f.gamma:.3e} bw={f.link_bw:.3e} r2={f.r2:.3f} "
              f"n={f.n_samples}")
    print(f"overlap_efficiency={prof.overlap_efficiency:.3f} "
          f"z_claims_first={prof.z_claims_first} "
          f"cross_step_efficiency={prof.cross_step_efficiency:.3f}")
    p_of = {f.axis: f.p for f in prof.axis_fits}
    for k, v in sorted(prof.probes.items()):
        if k.startswith("hops:"):
            kind, axis = k[len("hops:"):].split("@")
            print(f"  hops {kind}@{axis}: counted {v:g} a call, the code's "
                  f"{CB.ring_hops(kind, p_of[axis])} (the model's "
                  f"{CB.collective_geometry(kind, p_of[axis], 1.0)[0]})")
        else:
            print(f"  probe {k}={v:.6g}")
    print("saved", out)


def main(argv=None) -> CB.CalibrationProfile:
    args = build_parser().parse_args(argv)
    from repro_torch.launch import steps as ST
    ST.resolve_device(args.device)       # float32 products stay float32
    world = int(os.environ.get("WORLD_SIZE", "1"))
    axes = mesh_axes(args.mesh or DEFAULT_MESHES.get(
        world, f"{world // 2},1,2,1"))
    run = init_mesh(axes, device=args.device)
    try:
        sizes = tuple(int(v) for v in args.sizes.split(","))
        prof = CB.run_calibration(axes, sizes=sizes, reps=args.reps,
                                  quick=args.quick, device=run["device"])
        if args.no_samples:
            prof = dataclasses.replace(prof, samples=())
        out = args.out or CB.default_path(prof.backend)
        if run["rank"] == 0:
            prof.save(out)
            if run["device"].type == "cuda":
                print(f"card={torch.cuda.get_device_name(run['device'])} "
                      f"ranks_per_card={run['ranks_per_card']}")
            report(prof, out)
        if args.validate:
            if run["world"] > 1:
                dist.barrier()          # the profile is on disk
            _say("name,us_per_call,derived")
            for label, val, derived in fig5_measured(
                    steps=args.steps, calib=out, device=run["device"]):
                _say(f"{label},{val:.2f},{derived}")
        return prof
    finally:
        close_mesh()


if __name__ == "__main__":
    main()
