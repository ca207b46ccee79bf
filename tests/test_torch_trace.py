"""The port's tracing half (``core/trace.py``, the scopes at the
reference's sites, ``launch/roofline.py``'s dispatch hook and
``train.py --profile-steps``) held against the JAX package on the CPU.

  * ``trace.label`` gives the reference's ``label`` on the reference's
    cases and a grid of kinds, axes and details; the disabled ``scope`` is
    the shared no-op, which puts no range in a ``torch.profiler`` capture;
    the scope stack is per thread.
  * One ``torch.distributed.run --nproc-per-node 8`` launch of this file's
    ``__main__`` runs eight gloo ranks over five meshes in one world: the
    toy programs of the reference's HLO-scope tests (``ag_matmul`` on a z
    ring of 4; the w/b leaf plan's bucket reduce-scatters and leaf gather
    on (4,1,2,1)), the seq ring of ``seq_attn`` forward and backward,
    ``ring_all_reduce`` over a tuple axis, ``tp_matmul``'s overlapped and
    blocking programs, the blocking, ZeRO-1 and ZeRO-3 train steps on
    (4,1,2,1), and a 4-layer overlapped train step on (1,2,2,2), each
    under ``roofline.record_collectives`` and ``torch.profiler``. Held: the
    scope names the reference's compiled HLO carries appear among the
    port's profiled labels; the recorded ``CollectiveStats`` meet what the
    reference's HLO-count tests assert on their parsed HLO
    (``tests/test_overlap.py``, ``tests/test_gradsync.py``,
    ``tests/test_zero3.py``); the hook's totals equal ``mesh.COMM``'s,
    calls and bytes; tracing on and off give the same bits.
  * ``train.py --profile-steps 1:1`` on two ranks writes both ranks'
    traces and the reference's line, and its losses are those of the run
    without the flag, bit for bit (two more launches, beside the first);
    ``--profile-steps 2:1`` exits with the reference's message.

The reference's ``test_scopes_in_seq_kv_ring_hlo`` fails in this
environment (ROADMAP.md §3), so the seq ring's label is held to the
reference's ``label`` alone. ``step_time_estimate`` and
``model_flops_per_device`` are the reference's bit for bit, the
hardware constants given to both.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import InputShape
from repro.configs import get_config as jax_get_config
from repro.core import collective_matmul as JCMM
from repro.core import comm_model as JCM
from repro.core import gradsync as JGS
from repro.core import trace as JT
from repro.core.compat import shard_map
from repro.launch import mesh as LM
from repro.launch import roofline as JRL
from repro_torch.configs import get_config
from repro_torch.core import collective_matmul as CMM
from repro_torch.core import comm_model as CM
from repro_torch.core import gradsync as GS
from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core import trace
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.data.synthetic import DataConfig, SyntheticText, make_batch
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.layers import attention as A
from repro_torch.optim import adamw as OPT

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
WORLD = 8
MESHES = {"z4": (1, 1, 2, 4),          # the reference's _z_mesh
          "dp4": (4, 1, 2, 1),         # SHAPE_DP4 and the w/b leaf plan
          "p2": (1, 2, 2, 2),          # SHAPE_Z, and the 4-layer step
          "zx4": (1, 2, 1, 4),         # tp_matmul("x", None), a z ring of 4
          "seq4": (1, 1, 1, 2, 4)}     # the seq ring of 4
# tests/test_overlap.py's toy tp_matmul: x (B, S, K), w (K, N)
K, N, B, S = 16, 24, 8, 8
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=50)
STEP_LAYERS = 4
CLI_FLAGS = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
             "--steps", "3", "--batch", "4", "--seq", "16", "--log-every",
             "1", "--mesh", "1,1,1,2", "--backend", "gloo"]
# (the reference's overlap of _tp_collective_counts)
TP_OVERLAPS = {"blocking": OverlapConfig(),
               "ring_z": OverlapConfig(matmul=True, batched_matmul=True,
                                       tied_logits=True),
               "all_on": OverlapConfig.all_on()}
HW = CM.HardwareParams(flops=2.5e11, link_bw=1.1e9, alpha=3e-4,
                       overlap_efficiency=0.4)


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _op_rows(ops):
    return [dataclasses.astuple(op) for op in ops]


def _capture(fn, *, traced=True):
    """``fn()`` under ``torch.profiler`` (the CPU) and the collective hook,
    with tracing on or off: (its result, the recorded ops as tuples, the
    names of the profile's events)."""
    trace.enable(traced)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with RL.record_collectives() as ops:
                out = fn()
    finally:
        trace.enable(False)
    return out, _op_rows(ops), sorted({e.name for e in prof.events()})


def _ag_matmul(axes):
    """The reference's ``_ring_ag_hlo`` program: ones (4, 8) against this
    rank's (8, 6) block of ones, gathered over z by the ring."""
    return CMM.ag_matmul(torch.ones(4, 8), torch.ones(8, 6), axes, "z")


def _leaf_plan_program(axes):
    """The reference's ``test_scopes_in_zero3_and_dp_hlo`` program: the w/b
    leaf plan (bucket0 "b", bucket1 "w"), both buckets reduce-scattered,
    leaf 0 gathered from its shard."""
    leaves = [GS.Leaf("b", ("b",), (8,), torch.float32, (None,)),
              GS.Leaf("w", ("w",), (4, 8), torch.float32, (None, None))]
    plan = GS.make_leaf_plan(leaves, axes)
    shards = GS.reduce_scatter_grads({"w": torch.ones(4, 8),
                                      "b": torch.ones(8)}, plan, axes)
    return GS.gather_param_leaf(shards[0], (8,), axes, leaf=0), shards[1]


def _tp_program(axes, ov, rank):
    """tests/test_overlap.py's ``_tp_collective_counts`` program: one
    tp_matmul (x, y) forward and backward under ``ov``, the loss summed
    over the batch axes and y, the weight gradient psum'd over data."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(B, S, K, generator=gen)
    xl = M.shard(x, axes, (("data", "z"), None, "x")).clone()
    w = PP.tp_linear_init(torch.Generator().manual_seed(8), K, N, axes)
    xl.requires_grad_(True)
    w.requires_grad_(True)
    axes = axes.with_overlap(ov)
    y = PP.tp_matmul(xl, w, axes, "x", "y")
    loss = PP.ar_bwd_identity((y.float() ** 2).sum(), axes,
                              ("data", "y", "z"))
    loss.backward()
    return loss.detach(), xl.grad, M.psum(w.grad, axes, "data")


def _x_ring_program(axes):
    """tests/test_overlap.py:280-292: the forward of tp_matmul(x, w, "x",
    None) under the overlapped schedule, w's n over z alone."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(B, S, K, generator=gen)
    xl = M.shard(x, axes, (("data", "z"), None, "x"))
    w = PP.tp_linear_init(torch.Generator().manual_seed(10), K, N, axes,
                          "x", None)
    return PP.tp_matmul(xl, w, axes.with_overlap(OverlapConfig.all_on()),
                        "x", None)


def _batch(cfg, axes, batch, seq):
    data = SyntheticText(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch))
    return ST.stripe_batch({k: torch.from_numpy(v) for k, v in make_batch(
        cfg, 0, data, dtype=np.float32).items()}, axes)


def _train_setup(cfg, axes, gs, ov=OverlapConfig()):
    opts = ST.TrainOptions(overdecompose=2, dtype=torch.float32,
                           gradsync=gs, overlap=ov)
    model = ST.init_model(cfg, axes, seed=0, device="cpu", zero3=gs.zero3)
    params = dict(model.named_parameters())
    tools = (ST.make_gradsync_tools(cfg, axes, params, opts)
             if gs.state_sharded else None)
    state = (tools.init(model.shards if gs.zero3 else params) if tools
             else OPT.init_state(params))
    step = ST.make_train_step(cfg, axes, OPT.AdamWConfig(**OPT_CFG), opts,
                              tools=tools)
    return model, state, step, tools


def _dp_steps(axes):
    """One step of the blocking, ZeRO-1 and ZeRO-3 schedules on the
    reduced qwen3-1.7b (the reference's tests run stablelm-1.6b, whose
    layernorm the port refuses): each step's recorded ops, and ZeRO-3's
    largest gathered unit and whole plan in bytes."""
    cfg = get_config(ARCH).reduced()
    batch = _batch(cfg, axes, 8, 32)
    out = {}
    for name, gs in (("base", GS.GradSyncConfig()),
                     ("zero", GS.GradSyncConfig(zero=True, bucket_mb=0.25)),
                     ("zero3", GS.GradSyncConfig(zero3=True))):
        model, state, step, tools = _train_setup(cfg, axes, gs)
        with RL.record_collectives() as ops:
            step(model, state, batch)
        out[name] = _op_rows(ops)
        if gs.zero3:
            sizes = [(b, torch.empty((), dtype=b.dtype).element_size())
                     for b in tools.plan.buckets]
            out["unit"] = max(b.padded * e for b, e in sizes)
            out["total"] = sum(b.padded * b.stack * e for b, e in sizes)
    return out


def _overlapped_step(axes):
    """The 4-layer reduced qwen3-1.7b's overlapped train step on this
    mesh, traced under the profiler and the hook, then on a fresh model
    untraced: the hook's ops and mesh.COMM of the traced step, the labels,
    and both steps' metrics and parameters."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              n_layers=STEP_LAYERS)
    batch = _batch(cfg, axes, 4, 32)
    out = {}
    for traced in (True, False):
        model, state, step, _ = _train_setup(
            cfg, axes, GS.GradSyncConfig(), OverlapConfig.all_on())
        M.reset_comm()
        if traced:
            metrics, ops, names = _capture(
                lambda: step(model, state, batch))
            out["ops"], out["names"] = ops, names
            out["comm"] = {k: dict(c) for k, c in M.COMM.items()}
        else:
            metrics = step(model, state, batch)
        out[traced] = ({k: float(v) for k, v in metrics.items()},
                       {n: p.detach().clone()
                        for n, p in model.named_parameters()})
    return out


def _seq_ring(axes, rank):
    """The ring ``seq_attn`` forward and backward on this rank's stripe."""
    gen = torch.Generator().manual_seed(300 + rank)
    q = torch.randn(2, 8, 4, 16, generator=gen, requires_grad=True)
    k = torch.randn(2, 8, 2, 16, generator=gen, requires_grad=True)
    v = torch.randn(2, 8, 2, 16, generator=gen, requires_grad=True)
    ring = axes.with_overlap(OverlapConfig(ring_attention=True))

    def run():
        A.seq_attn(q, k, v, ring).sum().backward()
        return q.grad
    return _capture(run)


def _worker_mesh(name, axes, rank):
    out = {}
    if name == "z4":
        out["ag_on"] = _capture(lambda: _ag_matmul(axes))
        out["ag_off"] = _capture(lambda: _ag_matmul(axes), traced=False)
    elif name == "dp4":
        out["leaf_plan"] = _capture(lambda: _leaf_plan_program(axes))
        out["steps"] = _dp_steps(axes)
    elif name == "p2":
        v = torch.randint(-4, 5, (2, 8),
                          generator=torch.Generator().manual_seed(11)).float()
        out["tuple_ar"] = (v,) + _capture(lambda: M.ring_all_reduce(
            v, axes, ("x", "y", "z"), dim=-1))
        out["tp"] = {k: _capture(lambda ov=ov: _tp_program(axes, ov, rank))
                     for k, ov in TP_OVERLAPS.items()}
        out["step"] = _overlapped_step(axes)
    elif name == "zx4":
        out["x_ring"] = _capture(lambda: _x_ring_program(axes))
    elif name == "seq4":
        out["seq"] = _seq_ring(axes, rank)
    return out


def _rank_worker(outdir: pathlib.Path):
    """One rank: every mesh of MESHES in turn in one world of 8, saved to
    rank<r>.pt."""
    from repro_torch.launch.mesh import close_mesh, init_mesh
    out = {}
    try:
        for i, (name, sizes) in enumerate(MESHES.items()):
            axes = MeshAxes(sizes)
            if i == 0:
                init_mesh(axes, device="cpu")
            else:
                M.init_groups(axes)
            out[name] = _worker_mesh(name, axes, M.process_rank())
        rank = M.process_rank()
    finally:
        close_mesh()
    torch.save(out, outdir / f"rank{rank}.pt")


# ---------------------------------------------------------------------- #
# the launches, and the reference's compiled HLO meanwhile
# ---------------------------------------------------------------------- #

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _torchrun(args, nproc, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), *args], env=_env(), cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _wait(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    return out


def _jax_ring_ag_hlo():
    """tests/test_telemetry.py's ``_ring_ag_hlo``, traced with the
    reference's scopes on."""
    mesh = LM.make_smoke_mesh((1, 1, 2, 4))
    axes = LM.bind_4d(mesh)
    f = shard_map(lambda v, w: JCMM.ag_matmul(v, w, axes.z), mesh=mesh,
                  in_specs=(P(None, None), P(None, "z")),
                  out_specs=P(None, None), check_vma=False)
    return jax.jit(f).lower(jnp.ones((4, 8)), jnp.ones((8, 24))) \
        .compile().as_text()


def _jax_leaf_plan_hlo():
    """tests/test_telemetry.py's ``test_scopes_in_zero3_and_dp_hlo``
    program, traced with the reference's scopes on."""
    from repro.core.partition import ParamSpec
    mesh = LM.make_smoke_mesh((4, 1, 2, 1))
    axes = LM.bind_4d(mesh)
    structs = {"w": jax.ShapeDtypeStruct((4, 8), jnp.float32),
               "b": jax.ShapeDtypeStruct((8,), jnp.float32)}
    specs = {"w": ParamSpec(P(None, None), False),
             "b": ParamSpec(P(None,), False)}
    plan = JGS.make_leaf_plan(structs, specs, axes)

    def body(w, b):
        shards = JGS.reduce_scatter_grads({"w": w, "b": b}, plan, axes)
        return JGS.gather_param_leaf(shards[0], plan.buckets[0],
                                     axes), shards[1]
    f = shard_map(body, mesh=mesh, in_specs=(P(None, None), P(None)),
                  out_specs=(P(None), P("data")), check_vma=False)
    return jax.jit(f).lower(jnp.ones((4, 8)), jnp.ones((8,))) \
        .compile().as_text()


def _jax_hlos():
    JT.enable()
    try:
        return {"ag": _jax_ring_ag_hlo(), "leaf_plan": _jax_leaf_plan_hlo()}
    finally:
        JT.enable(False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank worker and the two 2-rank train CLI runs (profiled and
    not) launched together; the reference's HLO compiled meanwhile.
    Returns (ranks' results, HLO texts, CLI runs {name: (cwd, stdout)})."""
    outdir = tmp_path_factory.mktemp("trace_ranks")
    procs = {"worker": _torchrun([__file__, str(outdir)], WORLD, ROOT)}
    cli = {}
    for name, extra in (("profiled", ["--profile-steps", "1:1"]),
                        ("plain", [])):
        cwd = tmp_path_factory.mktemp(f"cli_{name}")
        cli[name] = cwd
        procs[name] = _torchrun(["-m", "repro_torch.launch.train",
                                 *CLI_FLAGS, *extra], 2, cwd)
    try:
        hlos = _jax_hlos()
    finally:
        outs = {name: _wait(p) for name, p in procs.items()}
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, hlos, {n: (cli[n], outs[n]) for n in cli}


def _ops(rows):
    return [RL.CollectiveOp(*r) for r in rows]


def _labels(names):
    """The scope labels among a profile's event names."""
    return {n for n in names if "/" in n or "[" in n}


# ---------------------------------------------------------------------- #
# labels and the scope object
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("args", [
    ("ring_ag", "z", "hop2"), ("dp_rs", None, "bucket3"),
    ("ring_rs", ("data", "z")), ("embed_gather", ())],
    ids=lambda a: repr(a))
def test_label_is_the_reference_label_on_its_cases(args):
    """tests/test_telemetry.py::test_scope_labels' cases."""
    assert trace.label(*args) == JT.label(*args)


@pytest.mark.parametrize("kind", ["ring_ag", "gemm", "zero3_stream"])
@pytest.mark.parametrize("axis", [None, "z", "data", ("x", "y", "z"),
                                  ["data", "seq"], (), ""],
                         ids=lambda a: repr(a))
@pytest.mark.parametrize("detail", [None, "", "hop0", "leaf7", "prefetch"])
def test_label_is_the_reference_label(kind, axis, detail):
    assert trace.label(kind, axis, detail) == JT.label(kind, axis, detail)


def test_disabled_scope_is_the_shared_noop():
    """Off, ``scope`` is one shared object that enters nothing: no range
    reaches a profile, no name is pushed, and the decorator returns the
    function itself."""
    assert not trace.enabled()
    s = trace.scope("ring_ag", "z", "hop0")
    assert s is trace.scope("dp_rs", None, "bucket1") is trace._NULL
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with s:
            assert trace.current() is None
            torch.ones(3).add_(1)

    def fn(x):
        return x + 1
    assert s(fn) is fn
    names = {e.name for e in prof.events()}
    assert not any("ring_ag" in n for n in names), names


def test_enabled_scope_is_a_profiler_range_on_a_per_thread_stack():
    """On, a scope is a ``record_function`` range and the innermost name of
    this thread's stack; another thread (autograd's, for a CUDA backward)
    starts with its own, empty stack; ``restored`` runs a block under an
    earlier snapshot (a hop posted later keeps the scope it was made in);
    the decorator, applied while tracing is on, opens a range a call."""
    seen = {}

    def other():
        seen["start"] = trace.current()
        with trace.scope("ring_rs", "z", "hop0"):
            seen["inner"] = trace.current()

    trace.enable()
    try:
        # the decorator binds when it decorates, as the reference's does
        @trace.scope("dp_rs", None, "bucket0")
        def decorated():
            return trace.current()

        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.scope("ring_ag", "z", "hop1"):
                with trace.scope("gemm", None, "chunk0"):
                    snap = trace.snapshot()
                t = threading.Thread(target=other)
                t.start()
                t.join()
                assert trace.current() == "ring_ag[z]/hop1"
                with trace.scope("ring_ag", "z", "hop2"):
                    with trace.restored(snap):
                        assert trace.current() == "gemm/chunk0"
                    assert trace.current() == "ring_ag[z]/hop2"
            assert decorated() == "dp_rs/bucket0"
        assert trace.current() is None and trace.snapshot() == ()
    finally:
        trace.enable(False)
    assert seen == {"start": None, "inner": "ring_rs[z]/hop0"}
    assert snap == ("ring_ag[z]/hop1", "gemm/chunk0")
    names = {e.name for e in prof.events()}
    assert {"ring_ag[z]/hop1", "gemm/chunk0", "ring_ag[z]/hop2",
            "dp_rs/bucket0"} <= names


# ---------------------------------------------------------------------- #
# the scopes at the reference's sites
# ---------------------------------------------------------------------- #

def test_ring_matmul_scopes_are_the_reference_hlo_names(world):
    """``ag_matmul`` on a z ring of 4: every scope name the reference's
    compiled HLO of the same program carries is a range in each rank's
    profile, and each hop is recorded under its hop's scope."""
    ranks, hlos, _ = world
    want = {"ring_ag[z]/hop0", "gemm/chunk0"}
    assert all(w in hlos["ag"] for w in want)
    for r in ranks:
        _, rows, names = r["z4"]["ag_on"]
        assert want <= set(names)
        scopes = [op.scope for op in _ops(rows)]
        assert scopes == ["ring_ag[z]/hop0", "ring_ag[z]/hop1",
                          "ring_ag[z]/hop2"]


def test_ring_matmul_permutes_are_the_reference_hlo_count(world):
    """A ring of 4 with one chunk: 3 collective-permutes and nothing else,
    as many as the reference's compiled HLO holds (XLA neither merges nor
    drops them there)."""
    ranks, hlos, _ = world
    stats = JRL.parse_collectives(hlos["ag"])
    for r in ranks:
        got = RL.collective_stats(_ops(r["z4"]["ag_on"][1]))
        assert got.counts == {"collective-permute": 3}
        assert got.counts == stats.counts


def test_bucket_and_leaf_scopes_are_the_reference_hlo_names(world):
    """The w/b leaf plan on (4,1,2,1): ``dp_rs/bucket0``, ``dp_rs/bucket1``
    and ``zero3_ag[data]/leaf0`` are in the reference's HLO and in each
    rank's profile; the data rings inside them record as ring scopes."""
    ranks, hlos, _ = world
    want = {"dp_rs/bucket0", "dp_rs/bucket1", "zero3_ag[data]/leaf0"}
    assert all(w in hlos["leaf_plan"] for w in want)
    for r in ranks:
        _, rows, names = r["dp4"]["leaf_plan"]
        assert want <= set(names)
        classes = {RL.scope_class(op.scope) for op in _ops(rows)}
        assert classes == {"ring_rs[data]", "ring_ag[data]"}


def test_seq_ring_scopes_follow_the_label_convention(world):
    """The seq ring of 4, forward and backward: every hop's
    ``ring_exchange[seq]/hop{s}`` (the reference's label; its HLO test
    fails here) is a range, and every hop recorded is under one."""
    ranks, _, _ = world
    want = {JT.label("ring_exchange", "seq", f"hop{s}") for s in range(4)}
    assert JT.label("ring_exchange", "seq", "hop1") == \
        "ring_exchange[seq]/hop1"
    for r in ranks:
        _, rows, names = r["seq4"]["seq"]
        assert want <= set(names)
        ops = _ops(rows)
        # 3 hops of K and V forward, 3 back
        assert len(ops) == 12
        assert all(RL.scope_class(op.scope) == "ring_exchange[seq]"
                   and op.axis == "seq" for op in ops)


def test_tracing_off_leaves_no_range_and_the_same_bits(world):
    """The counterpart of test_scope_disabled_hlo_byte_identical: with
    tracing off the profile has no scope range and no op a scope, and the
    results are those with tracing on, bit for bit; so is a whole
    overlapped train step on (1,2,2,2) (metrics and every parameter)."""
    ranks, _, _ = world
    for r in ranks:
        on, off = r["z4"]["ag_on"], r["z4"]["ag_off"]
        assert torch.equal(on[0], off[0])
        assert not _labels(off[2]) and _labels(on[2])
        assert all(op.scope is None for op in _ops(off[1]))
        step = r["p2"]["step"]
        (m_on, p_on), (m_off, p_off) = step[True], step[False]
        assert m_on == m_off
        assert all(torch.equal(p_on[n], p_off[n]) for n in p_on)


# ---------------------------------------------------------------------- #
# the reference's HLO-count assertions on the recorded ops
# ---------------------------------------------------------------------- #

def test_ring_all_reduce_tuple_axis(world):
    """tests/test_overlap.py::test_ring_all_reduce_tuple_axis: the sum
    over (x, y, z), and no all-reduce, at least one permute."""
    ranks, _, _ = world
    for r in ranks:
        v, got, rows, _ = r["p2"]["tuple_ar"]
        assert torch.equal(got, v * 8)
        stats = RL.collective_stats(_ops(rows))
        assert stats.counts.get("all-reduce", 0) == 0
        assert stats.counts.get("collective-permute", 0) >= 1
        # one flattened ring of 8: 7 reduce-scatter and 7 gather hops
        assert stats.counts == {"collective-permute": 14}


def test_tp_matmul_x_ring_takes_the_ring(world):
    """tests/test_overlap.py:280-292 (tp_matmul(x, w, "x", None) under the
    overlapped schedule): no all-gather, at least one permute. The
    reference's z there is the tuple (y, z) of 4; the port's axes are the
    mesh's, so its z is one axis of 4, (1,2,1,4)."""
    ranks, _, _ = world
    for r in ranks:
        stats = RL.collective_stats(_ops(r["zx4"]["x_ring"][1]))
        assert stats.counts.get("all-gather", 0) == 0, stats.counts
        assert stats.counts.get("collective-permute", 0) >= 1, stats.counts


def _tp_stats(r, name):
    return RL.collective_stats(_ops(r["p2"]["tp"][name][1]))


def test_overlap_uses_collective_permute(world):
    """tests/test_overlap.py::test_overlap_hlo_uses_collective_permute on
    the port's toy program. One departure, named: the port's blocking
    reduce-scatter (``mesh.psum_scatter``) runs gloo's all-reduce and
    slices, so the blocking program records its dW reduce-scatter as an
    all-reduce over z (group 2) and no "reduce-scatter"; the
    estimate's inequalities hold with one HardwareParams given to both."""
    ranks, _, _ = world
    for r in ranks:
        blocking, ring = _tp_stats(r, "blocking"), _tp_stats(r, "ring_z")
        assert blocking.counts.get("all-gather", 0) >= 2
        assert blocking.counts.get("reduce-scatter", 0) == 0
        dw_rs = [op for op in _ops(r["p2"]["tp"]["blocking"][1])
                 if op.tally == "psum_scatter"]
        assert len(dw_rs) >= 1 and all(op.kind == "all-reduce"
                                       and op.axis == "z" for op in dw_rs)
        assert blocking.counts.get("collective-permute", 0) == 0
        assert ring.counts.get("all-gather", 0) == 0
        assert ring.counts.get("reduce-scatter", 0) == 0
        assert ring.counts.get("collective-permute", 0) >= 3
        est_b = RL.step_time_estimate(1e9, blocking.bytes_by_kind, hw=HW)
        est_r = RL.step_time_estimate(1e9, ring.bytes_by_kind, hw=HW)
        assert est_r.exposed_comm < est_b.exposed_comm
        assert est_r.hidden_comm > 0.0


def test_ar_overlap_replaces_all_reduces(world):
    """tests/test_overlap.py::test_ar_overlap_hlo_replaces_all_reduces:
    with ``all_reduce`` on, the x (forward) and y (dX) activation
    all-reduces become permute chains."""
    ranks, _, _ = world
    converts = sum(1 for p in MESHES["p2"][1:3] if p > 1)
    for r in ranks:
        ring_z, ring_xy = _tp_stats(r, "ring_z"), _tp_stats(r, "all_on")
        assert (ring_xy.counts.get("all-reduce", 0)
                <= ring_z.counts.get("all-reduce", 0) - converts), (
            ring_z.counts, ring_xy.counts)
        assert (ring_xy.counts.get("collective-permute", 0)
                > ring_z.counts.get("collective-permute", 0))
        assert ring_xy.counts.get("all-gather", 0) == 0
        assert ring_xy.counts.get("reduce-scatter", 0) == 0


def test_tp_programs_give_the_same_numbers(world):
    """The three schedules of the toy program: the same loss, dX and dW
    within tests/test_overlap.py's tolerance."""
    ranks, _, _ = world
    for r in ranks:
        base = r["p2"]["tp"]["blocking"][0]
        for name in ("ring_z", "all_on"):
            for a, b in zip(r["p2"]["tp"][name][0], base):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                           atol=1e-5, err_msg=name)


def _big_dp_ar(ops, dp=4):
    return sum(1 for op in ops if op.kind == "all-reduce"
               and op.group_size == dp and op.raw_bytes > 2048)


def _permutes(ops):
    return sum(1 for op in ops if op.kind == "collective-permute")


def test_zero_has_no_data_allreduce(world):
    """tests/test_gradsync.py::test_zero_hlo_collective_permute_no_data_
    allreduce on (4,1,2,1) (reduced qwen3-1.7b: the port refuses the
    reference's stablelm-1.6b)."""
    ranks, _, _ = world
    for r in ranks:
        steps = r["dp4"]["steps"]
        base, zero = _ops(steps["base"]), _ops(steps["zero"])
        assert _big_dp_ar(base) > 0
        assert _big_dp_ar(zero) == 0, \
            "DP gradient all-reduces survived the ZeRO ring schedule"
        assert _permutes(zero) > _permutes(base)


def test_zero3_streaming_window(world):
    """tests/test_zero3.py::test_zero3_hlo_streaming_window: no data-axis
    gradient all-reduce, no data-axis gather or hop above one gathered
    unit of the leaf plan, and some permutes."""
    ranks, _, _ = world
    for r in ranks:
        steps = r["dp4"]["steps"]
        ops = _ops(steps["zero3"])
        assert _big_dp_ar(ops) == 0, "DP gradient all-reduces survived"
        unit, total = steps["unit"], steps["total"]
        assert unit < total / 2
        offenders = [op for op in ops
                     if op.kind in ("all-gather", "collective-permute")
                     and op.raw_bytes > unit]
        assert not offenders, offenders[:5]
        assert _permutes(ops) > 0


def test_step_hook_totals_equal_mesh_comm(world):
    """A 4-layer overlapped smoke step on (1,2,2,2): the hook's calls and
    bytes in ``mesh.COMM``'s terms equal ``mesh.COMM``'s, kind for kind;
    the scoped and unscoped calls sum to the hook's totals; the trace
    holds the labels phase 18 of chip_smoke.py asserts on the card."""
    ranks, _, _ = world
    for r in ranks:
        step = r["p2"]["step"]
        ops = _ops(step["ops"])
        assert ops
        got = RL.mesh_totals(ops)
        want = {k: {"calls": c["calls"], "bytes": float(c["bytes"])}
                for k, c in step["comm"].items()}
        assert got == want
        rows = RL.by_scope(ops)
        assert sum(v["calls"] for v in rows.values()) == len(ops)
        assert {k[0] for k in rows} >= {"ring_ag[z]", "ring_rs[z]"}
        assert {"ring_ag[z]/hop1", "ring_rs[z]/hop0", "gemm/chunk0",
                "embed_gather[z]"} <= set(step["names"])


@pytest.mark.parametrize("cross_step", [False, True])
@pytest.mark.parametrize("flops", [1e9, 3.7e12])
def test_step_time_estimate_is_the_reference(cross_step, flops):
    """The same roofline terms and hardware give the reference's estimate,
    bit for bit."""
    bytes_by_kind = {"collective-permute": 3.1e8, "all-reduce": 1.7e7,
                     "all-gather": 2.2e8, "reduce-scatter": 9.0e6,
                     "all-to-all": 4.0e5}
    hw = dict(flops=2.5e11, link_bw=1.1e9, alpha=3e-4,
              overlap_efficiency=0.4)
    got = RL.step_time_estimate(flops, bytes_by_kind,
                                hw=CM.HardwareParams(**hw),
                                cross_step=cross_step)
    want = JRL.step_time_estimate(flops, bytes_by_kind,
                                  hw=JCM.HardwareParams(**hw),
                                  cross_step=cross_step)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    with pytest.raises(TypeError):
        RL.step_time_estimate(flops, bytes_by_kind)    # hw is required


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_per_device_is_the_reference(kind):
    shape = InputShape("t", seq_len=32, global_batch=8, kind=kind)
    for arch in (ARCH, "jamba-v0.1-52b"):
        assert RL.model_flops_per_device(get_config(arch).reduced(), shape,
                                         4) == JRL.model_flops_per_device(
            jax_get_config(arch).reduced(), shape, 4)


# ---------------------------------------------------------------------- #
# train.py --profile-steps
# ---------------------------------------------------------------------- #

def _report(out):
    return json.loads(next(x for x in out.splitlines()
                           if x.startswith('{"train"')))["train"]


def test_profile_steps_writes_every_rank_and_keeps_the_losses(world):
    """``--profile-steps 1:1`` on (1,1,1,2): the reference's line, a chrome
    trace per rank under runs/profiles/<run>, each rank's window by scope
    and its CollectiveStats in the ``{"train"}`` line, the window's calls
    in mesh.COMM's terms equal to the step's own tally, and the losses and
    grad norms of the run without the flag, bit for bit."""
    _, _, cli = world
    (cwd, out), (_, plain) = cli["profiled"], cli["plain"]
    rep, base = _report(out), _report(plain)
    assert rep["losses"] == base["losses"]
    assert rep["grad_norms"] == base["grad_norms"]
    prof_dir = rep["profile"]["dir"]
    assert rep["profile"]["steps"] == [1, 1]
    assert f"profile: steps 1..1 -> {prof_dir}" in out
    assert prof_dir.startswith(os.path.join("runs", "profiles",
                                            "qwen3-1.7b-smoke-"))
    for r in rep["ranks"]:
        events = json.loads((cwd / prof_dir / f"rank{r['rank']}.json"
                             ).read_text())["traceEvents"]
        names = {e.get("name") for e in events}
        # the blocking schedule: the embedding's gather, no ring
        assert "embed_gather[z]" in names
        assert not any(str(n).startswith("ring_") for n in names)
        assert r["comm_by_scope"] and r["collectives"]["counts"]
        assert sum(row["calls"] for row in r["comm_by_scope"]) == sum(
            r["collectives"]["counts"].values())
        assert {row["axis"] for row in r["comm_by_scope"]} == {"z"}
        step = {k: c for k, c in r["comm_by_kind"][1].items()
                if c["calls"]}
        assert {k: v["calls"] for k, v in r["collectives_mesh"].items()} \
            == {k: c["calls"] for k, c in step.items()}
        assert {k: v["bytes"] for k, v in r["collectives_mesh"].items()} \
            == {k: float(c["bytes"]) for k, c in step.items()}
    assert base["profile"] is None
    assert all(r["comm_by_scope"] == [] for r in base["ranks"])


def test_profile_steps_rejects_a_reversed_window():
    with pytest.raises(SystemExit, match="--profile-steps 2:1: need 0 <= "
                       "A <= B"):
        train.main(["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
                    "--profile-steps", "2:1"])


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
