"""The port's bucketed data-parallel sync and ZeRO-1 AdamW
(``repro_torch.core.gradsync``, ``optim.adamw.apply_updates_sharded``, the
train step's ``GradSyncConfig`` modes, snapshot/restore across g_data, and
remat policy "dots" on the overlapped mesh) held against the JAX package
and against the port's blocking step on the CPU.

The plans are compared in this process (a rank's local shapes do not need
its ranks). Everything that needs ranks runs in one
``torch.distributed.run --nproc-per-node 8`` launch of this file's
``__main__``: each rank works through the meshes of ``MESHES`` in turn (a
mesh of fewer than 8 ranks leaves the others idle), while the JAX package
computes its side on the same mesh shapes in this process (8 forced host
devices). Weights cross with ``convert.params_from_jax(..., axes, rank)``
and inputs are made with numpy from seeds; the port runs its kernels'
plain versions. Tolerances are the reference's
``test_train_step_parity_all_modes`` bounds (loss 1e-5, grad norm 1e-4
relative, parameters 5e-6; across frameworks the first two); bitwise
where the reference's tests are (two-term sums at g_data 2,
exactly-summable values).
"""
import dataclasses
import os
import pathlib
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config
from repro.core import gradsync as JGS
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import gradsync as GS
from repro_torch.core import mesh as M
from repro_torch.core.gradsync import GradSyncConfig
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import leaf_spec, param_spec
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
JAMBA = "jamba-v0.1-52b-dense-ffn"
WORLD = 8
NAMES = ("data", "x", "y", "z", "seq")
PLAN_MESHES = [(2, 1, 1, 1), (2, 2, 2, 1), (2, 1, 1, 2), (4, 1, 1, 1)]
PLAN_MB = (0.25, 4.0)
# the meshes the ranks train on: g_data 2 beside x and y (the y_heads
# elements of a bucket), beside y and z, g_data 4, and a seq axis
MESHES = {"dp2": (2, 2, 2, 1), "yz": (2, 1, 2, 2), "dp4": (4, 1, 2, 1),
          "seq": (2, 1, 1, 1, 2)}
MODES = {"bucketed": GradSyncConfig(bucketed=True, bucket_mb=0.25),
         "zero": GradSyncConfig(zero=True, bucket_mb=0.25),
         "zero_noring": GradSyncConfig(zero=True, bucket_mb=0.25,
                                       ring=False),
         "zero_nostream": GradSyncConfig(zero=True, bucket_mb=0.25,
                                         stream=False)}
# the meshes every mode runs on; the others run "zero"
ALL_MODES_ON = ("dp2", "seq")
BITWISE_SYNC = ("dp2", "yz")          # two-term sums only
RESUME = {"A": (2, 1, 1, 1), "B": (1, 1, 1, 1)}
DOTS_MESH = (1, 2, 2, 2)
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=50)
STEPS = 3
UPDATE_STEP = 2          # the same-input update's step (past warmup)
LOSS_TOL = 1e-5          # test_train_step_parity_all_modes
GN_RTOL = 1e-4
PARAM_TOL = 5e-6
JAX_THREADS = 4


def _cfgs(arch=ARCH, **kw):
    if arch == JAMBA:
        jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b"),
                                   moe=None, name=JAMBA).reduced()
    else:
        jcfg = jax_get_config(arch).reduced()
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


# the trajectories' config: the reference's qk-norm gains are summed over
# data and z only (ROADMAP.md §3), so on a mesh with y above 1 the two
# packages train qk-norm models apart; without qk-norm they agree
NOQK = dict(qk_norm=False)


def _inputs(vocab):
    """A one-microbatch loss batch and the train batch of the reference's
    ``_model_setup`` (B 8, S 32)."""
    rng = np.random.RandomState(8)
    loss = [rng.randint(0, vocab, (4, 32)).astype(np.int32)
            for _ in range(2)]
    rng = np.random.RandomState(0)
    train = [rng.randint(0, vocab, (8, 32)).astype(np.int32)
             for _ in range(2)]
    return dict(loss=loss, train=train)


def _save_tree(tree, path):
    np.savez(path, **convert._flat_tree(tree))


def _load_tree(path):
    with np.load(path) as f:
        return convert._nest({k: f[k] for k in f.files})


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _torch_batch(arrays, axes):
    return ST.stripe_batch({k: torch.from_numpy(v) for k, v in
                            zip(("tokens", "labels"), arrays)}, axes)


def _opts(gs, **kw):
    return ST.TrainOptions(overdecompose=2, dtype=torch.float32,
                           gradsync=gs, **kw)


def _trajectory(tcfg, axes, tree, batch, rank, gs):
    """STEPS steps of the train step of ``gs``: metrics per step and the
    final parameters."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    params = dict(model.named_parameters())
    opts = _opts(gs)
    tools = (ST.make_gradsync_tools(tcfg, axes, params, opts)
             if gs.state_sharded else None)
    state = tools.init(params) if tools else OPT.init_state(params)
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**OPT_CFG), opts,
                              tools=tools)
    out = [{k: float(v) for k, v in step(model, state, batch).items()}
           for _ in range(STEPS)]
    return out, {n: p.detach().clone() for n, p in model.named_parameters()}


def _cmp(a, b):
    """(bitwise equal, max |a - b| / max |b|) over two name -> tensor
    dicts."""
    eq = all(torch.equal(a[k], b[k]) for k in b)
    err = max(float((a[k] - b[k]).abs().max())
              / max(float(b[k].abs().max()), 1e-30) for k in b)
    return eq, err


def _exact_grads(params, seed):
    """Per-rank gradients of small integers (every sum exact)."""
    gen = torch.Generator().manual_seed(seed + 97 * M.process_rank())
    return {n: torch.randint(-1, 2, p.shape, generator=gen).float()
            for n, p in params.items()}


def _zero_vs_blocking(params, leaves_of, axes, specs, no_decay,
                      bucket_bytes):
    """Two AdamW steps on exact gradients: the blocking sync and
    ``apply_updates`` against the bucketed reduce-scatter and
    ``apply_updates_sharded``. Returns (grad norms equal, params equal,
    states equal)."""
    cfg = OPT.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    plan = GS.make_plan(leaves_of(params), axes, bucket_bytes,
                        no_decay=OPT._no_decay)
    base = {n: p.clone() for n, p in params.items()}
    zero = {n: p.clone() for n, p in params.items()}
    sb, sz = OPT.init_state(base), GS.init_sharded_state(zero, plan, axes)
    norms = []
    for i in range(2):
        grads = _exact_grads(params, i)
        g = ST.sync_grads({n: t.clone() for n, t in grads.items()}, axes)
        nb = OPT.apply_updates(base, g, sb, cfg, no_decay=no_decay,
                               specs=specs, axes=axes)["grad_norm"]
        shards = GS.tensor_reduce_shards(
            GS.reduce_scatter_grads(grads, plan, axes), plan, axes)
        nz = OPT.apply_updates_sharded(shards, sz, plan, axes, cfg,
                                       params=zero)["grad_norm"]
        norms.append(float(nb) == float(nz))
    full = GS.gather_sharded_state(sz, plan, axes)
    return (all(norms), _cmp(zero, base)[0],
            all(torch.equal(full["opt"][n][k], sb["opt"][n][k])
                for n in base for k in ("m", "v", "master")))


def _update_inputs(shard_sizes, world):
    """Per bucket, global (world x shard) arrays of gradient shards and
    m/v/master from a seed (v >= 0; the gradients' norm ~0.1, below the
    clip): rank r's shards are row r, as the reference's flat state tiles
    its devices."""
    rng = np.random.default_rng(11)
    out = []
    for ln in shard_sizes:
        n = world * ln
        out.append({"g": 1e-4 * rng.standard_normal(n),
                    "m": 1e-4 * rng.standard_normal(n),
                    "v": 1e-8 * rng.random(n),
                    "master": rng.standard_normal(n)})
    return [{k: v.astype(np.float32) for k, v in b.items()} for b in out]


def _update_same_inputs(params, plan, axes):
    """``apply_updates_sharded`` on this rank's row of
    :func:`_update_inputs`: the updated m, v and master shards, the grad
    norm and the lr (the parameters it rebuilds are copies)."""
    r, world = M.process_rank(), axes.world
    inp = _update_inputs(plan.shard_sizes, world)
    rows = [{k: torch.from_numpy(a.reshape(world, -1)[r].copy())
             for k, a in b.items()} for b in inp]
    state = {"buckets": [{k: b[k] for k in ("m", "v", "master")}
                         for b in rows], "step": UPDATE_STEP}
    met = OPT.apply_updates_sharded(
        [b["g"] for b in rows], state, plan, axes,
        OPT.AdamWConfig(**OPT_CFG),
        params={n: p.detach().clone() for n, p in params.items()})
    return state["buckets"], float(met["grad_norm"]), float(met["lr"])


def _toy_params(axes):
    """A toy tree named with ``partition.LEAF_SPECS``' leaf names: a
    normal and a transposed weight, a norm gain, a qk-norm gain (y_heads,
    no decay) and an embedding; this rank's blocks of global values."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"blk.wi": (16, 8), "blk.wo": (8, 16), "blk.g": (16,),
              "blk.q_norm": (8,), "emb.embed": (32, 8)}
    return {n: M.shard(torch.randn(s, generator=gen), axes,
                       param_spec(n)).clone() for n, s in shapes.items()}


def _toy_leaves(params):
    out = []
    for n in sorted(params, key=lambda n: n.replace(".", "/")):
        ps = leaf_spec(n)
        out.append(GS.Leaf(path=n.replace(".", "/"), names=(n,),
                           shape=tuple(params[n].shape),
                           dtype=params[n].dtype, spec=tuple(ps.spec),
                           z_reduced=ps.z_reduced, y_reduce=ps.y_reduce,
                           y_heads=ps.y_heads))
    return out


def _worker_mesh(name, axes, outdir):
    rank = M.process_rank()
    jcfg, tcfg = _cfgs()
    inp = _inputs(tcfg.vocab_size)
    tree = _load_tree(outdir / "qwen.npz")
    out = {}
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    params = dict(model.named_parameters())
    tools = ST.make_gradsync_tools(tcfg, axes, params, _opts(MODES["zero"]))
    out["fingerprint"] = GS.plan_fingerprint(tools.plan)
    out["shards"] = [b["master"] for b in tools.init(params)["buckets"]]
    out["update-same"] = _update_same_inputs(params, tools.plan, axes)
    # one microbatch's gradients: the blocking sync against the buckets
    batch = _torch_batch(inp["loss"], axes)
    tokens, labels = (M.seq_shard(M.batch_shard(batch[k], axes), axes)
                      for k in ("tokens", "labels"))
    loss, _ = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in params.items()}
    model.zero_grad(set_to_none=True)
    block = ST.sync_grads({n: g.clone() for n, g in grads.items()}, axes)
    for ring in (True, False):
        shards = GS.reduce_scatter_grads(grads, tools.plan, axes, ring=ring)
        shards = [M.psum(s, axes, "seq") for s in shards]   # the step's
        shards = GS.tensor_reduce_shards(shards, tools.plan, axes)
        out[f"sync-{ring}"] = _cmp(GS.all_gather_grads(
            shards, tools.plan, axes, ring=ring), block)
    if name in BITWISE_SYNC:
        specs = {n: param_spec(n) for n in params}
        out["update-model"] = _zero_vs_blocking(
            params, lambda p: GS.model_leaves(p, tcfg), axes, specs,
            ST.no_decay_names(model), 2 ** 18)
        toy = _toy_params(axes)
        out["update-toy"] = _zero_vs_blocking(
            toy, _toy_leaves, axes, {n: param_spec(n) for n in toy},
            {n for n in toy if OPT._no_decay(n.replace(".", "/"))}, 256)
    # STEPS train steps of each mode, and of the blocking step
    train = _torch_batch(inp["train"], axes)
    noqk = _cfgs(**NOQK)[1]
    tree = _load_tree(outdir / "qwen-noqk.npz")
    modes = ["blocking"] + (list(MODES) if name in ALL_MODES_ON
                            else ["zero"])
    for mode in modes:
        out[f"traj-{mode}"] = _trajectory(
            noqk, axes, tree, train, rank,
            MODES.get(mode, GradSyncConfig()))
    return out


def _worker_resume(outdir):
    """Save under ZeRO at g_data 2 after one step; resume at g_data 1
    (blocking) and with ZeRO at g_data 2; the uninterrupted run's second
    step beside both. Returns {run: (metrics, final params)}."""
    rank = M.process_rank()
    _, tcfg = _cfgs()
    tree = _load_tree(outdir / "qwen.npz")
    path = str(outdir / "resume.npz")
    out = {}
    axes = MeshAxes(RESUME["A"])
    M.init_groups(axes)
    batch = _torch_batch(_inputs(tcfg.vocab_size)["train"], axes)
    zero = _opts(MODES["zero"])
    cfg = OPT.AdamWConfig(**OPT_CFG)

    def run_on(axes, opts, snapshot=None):
        model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
        params = dict(model.named_parameters())
        tools = (ST.make_gradsync_tools(tcfg, axes, params, opts)
                 if opts.gradsync.state_sharded else None)
        if snapshot is None:
            state = (tools.init(params) if tools
                     else OPT.init_state(params))
        else:
            state = ST.restore_state(snapshot, tcfg, axes, tools, opts,
                                     model)
        return model, tools, state, ST.make_train_step(tcfg, axes, cfg,
                                                       opts)

    like = None
    if rank < axes.world:
        model, tools, state, step = run_on(axes, zero)
        like = model
        step(model, state, batch)
        snap = ST.snapshot_state(model, state, tools, zero, step=0,
                                 keep=rank == 0)
        if rank == 0:
            ckpt.save(path, snap["params"], snap["opt_state"], step=0,
                      pspecs=convert.jax_specs(model))
        m = step(model, state, batch)
        out["uninterrupted"] = ({k: float(v) for k, v in m.items()},
                                dict(model.named_parameters()))
    torch.distributed.barrier()
    if rank < axes.world:
        model, tools, state, step = run_on(axes, zero,
                                           _read_snapshot(path, like))
        m = step(model, state, batch)
        out["zero-gdata2"] = ({k: float(v) for k, v in m.items()},
                              dict(model.named_parameters()))
    if rank == 0:
        axes1 = MeshAxes(RESUME["B"])
        model, tools, state, step = run_on(
            axes1, _opts(GradSyncConfig()), _read_snapshot(path, like))
        m = step(model, state, batch)
        out["blocking-gdata1"] = ({k: float(v) for k, v in m.items()},
                                  dict(model.named_parameters()))
    return {k: (m, {n: p.detach().clone() for n, p in ps.items()})
            for k, (m, ps) in out.items()}


def _read_snapshot(path, model):
    params, step = ckpt.restore(path, convert.jax_structs(model))
    state, _ = ckpt.restore(path, convert.jax_opt_structs(model),
                            root="opt_state")
    return {"params": params, "opt_state": state, "step": step,
            "fingerprint": None}


def _worker_dots(outdir):
    """The loss and every gradient of one microbatch under remat "full"
    and "dots" on (1,2,2,2) with the overlapped schedule, and the K1
    products each ran (its plain version, counted)."""
    rank = M.process_rank()
    _, tcfg = _cfgs()
    tree = _load_tree(outdir / "qwen.npz")
    axes = MeshAxes(DOTS_MESH).with_overlap(OverlapConfig.all_on())
    M.init_groups(axes)
    batch = _torch_batch(_inputs(tcfg.vocab_size)["loss"], axes)
    tokens, labels = (M.seq_shard(M.batch_shard(batch[k], axes), axes)
                      for k in ("tokens", "labels"))
    plain, calls = ops.block_matmul_plain, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)
    ops.block_matmul_plain = counted
    out = {}
    try:
        for policy in ("full", "dots"):
            model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
            calls[0] = 0
            with D.overlap_bound(model, axes.overlap):
                loss, _ = D.lm_loss(model, tokens, labels, remat=True,
                                    remat_policy=policy)
                loss.backward()
            out[policy] = (float(loss.detach()), calls[0],
                           {n: p.grad for n, p in model.named_parameters()})
    finally:
        ops.block_matmul_plain = plain
    return out


def _rank_worker(outdir: pathlib.Path):
    """One rank: every mesh of MESHES in turn in one world of 8 (ranks
    past a mesh's size wait), then the resume runs and the dots run;
    saved to rank<r>.pt."""
    from repro_torch.launch.mesh import close_mesh, init_mesh
    out = {}
    try:
        init_mesh(MeshAxes((2, 2, 2, 1)), device="cpu")
        rank = M.process_rank()
        for name, sizes in MESHES.items():
            axes = MeshAxes(sizes)
            M.init_groups(axes)
            if rank < axes.world:
                out[name] = _worker_mesh(name, axes, outdir)
            torch.distributed.barrier()
        out["resume"] = _worker_resume(outdir)
        torch.distributed.barrier()
        out["dots"] = _worker_dots(outdir)
    finally:
        close_mesh()
    torch.save(out, outdir / f"rank{rank}.pt")


# ---------------------------------------------------------------------- #
# the JAX side
# ---------------------------------------------------------------------- #

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _torchrun(args, nproc=WORLD):
    """``args`` under ``torch.distributed.run`` in a session of its own
    (a timeout stops the launcher and every rank together)."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), *args], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _wait(proc, timeout=400):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    return out


def _jax_mesh(sizes):
    mesh = LM.make_smoke_mesh(sizes, NAMES[:len(sizes)])
    return mesh, LM.bind_4d(mesh)


def _jax_setup(jcfg, sizes, tree, gs):
    mesh, axes = _jax_mesh(sizes)
    opts = JST.TrainOptions(overdecompose=2, dtype=jnp.float32, gradsync=gs)
    _, specs = JST.init_model(jcfg, axes, abstract=True, dtype=jnp.float32)
    from repro.core.partition import spec_tree_to_pspecs
    params = JST.device_put_tree(mesh, jax.tree.map(jnp.asarray, tree),
                                 spec_tree_to_pspecs(specs))
    tools = JST.make_gradsync_tools(jcfg, mesh, axes, opts)
    return mesh, axes, opts, params, tools


def _jax_shards(jcfg, sizes, tree):
    """The reference's init_sharded_state masters, per device (row-major
    device order, the port's rank order), and its plan fingerprint."""
    _, _, _, params, tools = _jax_setup(jcfg, sizes, tree,
                                        JGS.GradSyncConfig(zero=True,
                                                           bucket_mb=0.25))
    state = tools.init(params)
    world = int(np.prod(sizes))
    shards = [np.asarray(b["master"]).reshape(world, -1)
              for b in state["buckets"]]
    return shards, JGS.plan_fingerprint(tools.plan)


def _jax_update(jcfg, sizes, tree):
    """The reference's ``apply_updates_sharded`` on :func:`_update_inputs`
    (its own plan of the same model and mesh): per bucket the updated m,
    v and master as (world, shard) rows, the grad norm and the lr."""
    from jax.sharding import PartitionSpec as P
    from repro.core.compat import shard_map
    mesh, axes, _, _, tools = _jax_setup(
        jcfg, sizes, tree, JGS.GradSyncConfig(zero=True, bucket_mb=0.25))
    plan, sspecs = tools.plan, tools.state_pspecs
    world = int(np.prod(sizes))
    inp = _update_inputs(plan.shard_sizes, world)
    state = {"buckets": [{k: jnp.asarray(b[k]) for k in ("m", "v", "master")}
                         for b in inp], "step": jnp.int32(UPDATE_STEP)}

    def update(shards, st):
        _, new, met = JOPT.apply_updates_sharded(
            shards, st, plan, axes, JOPT.AdamWConfig(**OPT_CFG))
        return new, met

    fn = jax.jit(shard_map(
        update, mesh=mesh,
        in_specs=([b["master"] for b in sspecs["buckets"]], sspecs),
        out_specs=(sspecs, {"grad_norm": P(), "lr": P()}), check_vma=False))
    new, met = fn([jnp.asarray(b["g"]) for b in inp], state)
    return ([{k: np.asarray(b[k]).reshape(world, -1)
              for k in ("m", "v", "master")} for b in new["buckets"]],
            float(met["grad_norm"]), float(met["lr"]))


def _jax_trajectory(jcfg, sizes, tree, batch):
    """The reference's zero step, STEPS steps: (loss, grad_norm) per step
    and the final global parameters."""
    mesh, axes, opts, params, tools = _jax_setup(
        jcfg, sizes, tree, JGS.GradSyncConfig(zero=True, bucket_mb=0.25))
    state = tools.init(params)
    step_fn, _, _ = JST.make_train_step(
        jcfg, mesh, axes, JOPT.AdamWConfig(**OPT_CFG), opts)
    jb = JST.stripe_batch(dict(zip(("tokens", "labels"),
                                   map(jnp.asarray, batch))), axes)
    out = []
    for _ in range(STEPS):
        params, state, m = step_fn(params, state, jb)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX weights saved, the 8-rank worker launched; while it runs,
    the JAX package computes its side on the same meshes (a few at a time
    on threads). Returns (ranks' results, JAX's results, the JAX tree)."""
    outdir = tmp_path_factory.mktemp("gradsync_ranks")
    _, axes = _jax_mesh((1, 1, 1, 1))
    trees = {}
    for key, kw in (("qwen", {}), ("qwen-noqk", NOQK)):
        params, _ = JST.init_model(_cfgs(**kw)[0], axes,
                                   jax.random.PRNGKey(0), dtype=jnp.float32)
        trees[key] = jax.tree.map(np.asarray, params)
        _save_tree(trees[key], outdir / f"{key}.npz")
    jcfg, tcfg = _cfgs()
    proc = _torchrun([__file__, str(outdir)])
    try:
        train = _inputs(tcfg.vocab_size)["train"]
        tasks = []
        for name, sizes in MESHES.items():
            tasks.append(((name, "shards"), _jax_shards,
                          (jcfg, sizes, trees["qwen"])))
            tasks.append(((name, "update"), _jax_update,
                          (jcfg, sizes, trees["qwen"])))
            tasks.append(((name, "traj"), _jax_trajectory,
                          (_cfgs(**NOQK)[0], sizes, trees["qwen-noqk"],
                           train)))
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            done = [pool.submit(fn, *args) for _, fn, args in tasks]
            jax_out = {key: f.result() for (key, *_), f in zip(tasks, done)}
    finally:
        _wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out, trees


# ---------------------------------------------------------------------- #
# the plan (in this process)
# ---------------------------------------------------------------------- #

def _plans(arch, sizes, mb):
    jcfg, tcfg = _cfgs(arch)
    mesh, jaxes = _jax_mesh(sizes)
    structs, specs = JST.init_model(jcfg, jaxes, abstract=True,
                                    dtype=jnp.float32)
    jplan = JGS.make_plan(structs, specs, jaxes, int(mb * 2 ** 20),
                          no_decay=JOPT._no_decay)
    axes = MeshAxes(sizes)
    model = ST.init_model(tcfg, axes, device="cpu")
    plan = ST.train_plan(dict(model.named_parameters()), tcfg, axes,
                         GradSyncConfig(zero=True, bucket_mb=mb))
    flat, _ = jax.tree_util.tree_flatten_with_path(structs)
    return jplan, plan, ["/".join(str(k.key) for k in p) for p, _ in flat]


@pytest.mark.parametrize("mb", PLAN_MB)
@pytest.mark.parametrize("sizes", PLAN_MESHES, ids=str)
@pytest.mark.parametrize("arch", [ARCH, JAMBA])
def test_plan_matches_the_reference(arch, sizes, mb):
    """The same leaves in the same order, the same buckets (segments,
    sizes, padding, classes, dtype, groups and gid) and the reference's
    plan_fingerprint."""
    jplan, plan, paths = _plans(arch, sizes, mb)
    assert [lf.path for lf in plan.leaves] == paths
    assert plan.dp == jplan.dp and plan.n_leaves == jplan.n_leaves
    assert len(plan.buckets) == len(jplan.buckets) > 1
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert (b.size, b.padded, b.z_reduced, b.y_reduce, b.stack) == (
            jb.size, jb.padded, jb.z_reduced, jb.y_reduce, jb.stack)
        assert GS._DTYPE_NAMES[b.dtype] == jnp.dtype(jb.dtype).name
        assert [dataclasses.astuple(x) for x in b.segments] == [
            dataclasses.astuple(x) for x in jb.segments]
        assert [(g.decay, g.norm_names) for g in b.groups] == [
            (g.decay, g.norm_names) for g in jb.groups]
        np.testing.assert_array_equal(b.gid, jb.gid)
    assert plan.shard_sizes == jplan.shard_sizes
    assert GS.plan_fingerprint(plan) == JGS.plan_fingerprint(jplan)


def test_fingerprint_ignores_gdata_and_sees_the_tensor_axes():
    """The reference's property: g_data does not change the fingerprint,
    a tensor factor does."""
    fps = {s: GS.plan_fingerprint(_plans(ARCH, s, 0.25)[1])
           for s in [(2, 1, 1, 1), (4, 1, 1, 1), (2, 2, 1, 1)]}
    assert fps[(2, 1, 1, 1)] == fps[(4, 1, 1, 1)] != fps[(2, 2, 1, 1)]


def test_flatten_unflatten_roundtrip():
    """Every bucket's leaves come back bitwise, their padding is zero and
    a stacked leaf's layers are raveled in period order."""
    _, tcfg = _cfgs(JAMBA)
    axes = MeshAxes((2, 1, 1, 1))
    model = ST.init_model(tcfg, axes, device="cpu")
    params = dict(model.named_parameters())
    plan = ST.train_plan(params, tcfg, axes, GradSyncConfig(bucket_mb=0.25))
    seen = set()
    for b in plan.buckets:
        flat = GS.flatten_bucket(params, b, plan)
        assert flat.shape == (b.padded,) and flat.dtype == torch.float32
        assert torch.all(flat[b.size:] == 0)
        for n, arr in GS.unflatten_bucket(flat, b, plan):
            assert torch.equal(arr, params[n]) and n not in seen
            seen.add(n)
        s0 = b.segments[0]
        lf = plan.leaves[s0.leaf]
        assert torch.equal(flat[s0.offset:s0.offset + params[
            lf.names[0]].numel()], params[lf.names[0]].reshape(-1))
    assert seen == set(params)


def test_gradsync_config_validation():
    """The reference's messages and properties."""
    with pytest.raises(ValueError, match="bucket_mb must be > 0"):
        GradSyncConfig(bucket_mb=0.0)
    with pytest.raises(ValueError, match="prefetch is a zero3 knob"):
        GradSyncConfig(prefetch=True)
    assert not GradSyncConfig().enabled
    assert GradSyncConfig(bucketed=True).enabled
    assert GradSyncConfig(zero=True).enabled
    assert GradSyncConfig(zero=True).state_sharded
    assert not GradSyncConfig(bucketed=True).state_sharded
    assert GradSyncConfig(bucket_mb=0.25).bucket_bytes == 2 ** 18


def test_zero_state_bytes_shrink_by_gdata():
    """Per-rank optimizer state under ZeRO is 1/g_data of the blocking
    state, plus at most a ring block of padding a bucket."""
    _, tcfg = _cfgs()
    axes = MeshAxes((4, 1, 1, 1))
    params = dict(ST.init_model(tcfg, axes, device="cpu").named_parameters())
    full = ST.state_layouts(tcfg, axes, params, _opts(GradSyncConfig()))
    zero = ST.state_layouts(tcfg, axes, params, _opts(MODES["zero"]))
    plan = ST.train_plan(params, tcfg, axes, MODES["zero"])
    assert zero["params"] == full["params"]
    assert full["opt_state"] / 4 <= zero["opt_state"] <= (
        full["opt_state"] / 4 + 12 * len(plan.buckets))
    state = GS.init_sharded_state(params, plan, axes)
    assert sum(t.numel() * t.element_size() for b in state["buckets"]
               for t in b.values()) == zero["opt_state"]


# ---------------------------------------------------------------------- #
# on the ranks
# ---------------------------------------------------------------------- #

def _ranks_of(world, name):
    ranks, _, _ = world
    return [(r, out[name]) for r, out in enumerate(ranks) if name in out]


@pytest.mark.parametrize("name", list(MESHES))
def test_init_shards_match_the_reference(world, name):
    """Each rank's init_sharded_state masters are bitwise the reference's
    on the same mesh, and the plan fingerprints agree."""
    _, jax_out, _ = world
    shards, fp = jax_out[name, "shards"]
    for r, out in _ranks_of(world, name):
        assert out["fingerprint"] == fp
        assert len(out["shards"]) == len(shards)
        for mine, theirs in zip(out["shards"], shards):
            np.testing.assert_array_equal(mine.numpy(), theirs[r])


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "blocking"])
@pytest.mark.parametrize("name", list(MESHES))
def test_bucketed_sync_matches_the_blocking_sync(world, name, ring):
    """On one microbatch's model gradients, reduce-scatter -> tensor
    reduce -> all-gather equals ``steps.sync_grads``: bitwise where every
    sum has two terms, within fp32 rounding at g_data 4 or with seq."""
    for r, out in _ranks_of(world, name):
        eq, err = out[f"sync-{ring}"]
        if name in BITWISE_SYNC:
            assert eq, (r, err)
        assert err <= 1e-6, (r, err)


@pytest.mark.parametrize("tree", ["toy", "model"])
@pytest.mark.parametrize("name", BITWISE_SYNC)
def test_zero_update_bitwise_vs_blocking(world, name, tree):
    """Two ZeRO-1 steps on exactly-summable gradients equal the blocking
    sync + replicated AdamW bitwise: grad norms, parameters and the
    gathered state (``test_zero_update_bitwise_vs_baseline``)."""
    for r, out in _ranks_of(world, name):
        assert out[f"update-{tree}"] == (True, True, True), r


@pytest.mark.parametrize("name", list(MESHES))
def test_apply_updates_sharded_matches_the_reference_on_the_same_inputs(
        world, name):
    """One ZeRO-1 update on the same gradient shards and m/v/master
    (seeded, past warmup, weight decay on) by the port's and the
    reference's ``apply_updates_sharded``: m, v and master within fp32
    rounding (1e-6 relative to each array's largest element), the lr
    within 1e-6 relative (the port's schedule is float64, the
    reference's float32), the grad norm within the reference's 1e-4
    relative (XLA's CPU sum of ~1e6 squares runs in another order than
    torch's: up to 6e-5 apart here). The gradients are small enough that
    clipping leaves them whole, so the norm does not reach the update."""
    _, jax_out, _ = world
    jbuckets, jn, jlr = jax_out[name, "update"]
    for r, out in _ranks_of(world, name):
        buckets, n, lr = out["update-same"]
        assert abs(lr - jlr) <= 1e-6 * jlr, (r, lr, jlr)
        assert abs(n - jn) <= GN_RTOL * jn, (r, n, jn)
        assert len(buckets) == len(jbuckets)
        for i, (mine, theirs) in enumerate(zip(buckets, jbuckets)):
            for k in ("m", "v", "master"):
                want = theirs[k][r]
                np.testing.assert_allclose(
                    mine[k].numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()),
                    err_msg=f"rank {r} bucket {i} {k}")


def _modes(name):
    return list(MODES) if name in ALL_MODES_ON else ["zero"]


@pytest.mark.parametrize("name,mode", [(n, m) for n in MESHES
                                       for m in _modes(n)])
def test_train_step_parity_with_the_blocking_step(world, name, mode):
    """Each mode's 3 steps against the port's blocking step on the same
    mesh: the reference's bounds (loss 1e-5, grad norm 1e-4 relative,
    parameters 5e-6); the default GradSyncConfig is the blocking step."""
    for r, out in _ranks_of(world, name):
        base, pb = out["traj-blocking"]
        got, pz = out[f"traj-{mode}"]
        lb, nb = base[-1]["loss"], base[-1]["grad_norm"]
        l, n = got[-1]["loss"], got[-1]["grad_norm"]
        assert abs(l - lb) < LOSS_TOL, (r, l, lb)
        assert abs(n - nb) < GN_RTOL * max(1.0, nb), (r, n, nb)
        gap = max(float((pz[k] - pb[k]).abs().max()) for k in pb)
        assert gap < PARAM_TOL, (r, gap)


@pytest.mark.parametrize("name,mode", [(n, m) for n in MESHES
                                       for m in _modes(n)])
def test_train_step_parity_with_the_reference_zero_step(world, name, mode):
    """Each mode's 3 steps against the reference's zero step on the same
    mesh: the loss within 1e-5 and the grad norm within 1e-4 (relative)
    at every step, the reference's bounds. The parameters are held to the
    port's blocking step (above), not across frameworks: AdamW's
    normalised update turns a rounding-level difference in a near-zero
    gradient element into a step of up to 2 lr (up to 1.2e-4 on the
    embedding after 3 steps on the seq mesh, with every loss within
    5e-7)."""
    _, jax_out, _ = world
    jtraj, _ = jax_out[name, "traj"]
    for r, out in _ranks_of(world, name):
        got, _ = out[f"traj-{mode}"]
        for i, (jl, jn) in enumerate(jtraj):
            assert abs(got[i]["loss"] - jl) < LOSS_TOL, (r, i)
            assert abs(got[i]["grad_norm"] - jn) < GN_RTOL * jn, (r, i)


def test_resume_across_gdata_matches_the_uninterrupted_run(world):
    """Saved under ZeRO at g_data 2 after one step, resumed with ZeRO at
    g_data 2 (bitwise the uninterrupted second step) and without ZeRO at
    g_data 1 (within the train step's bounds)."""
    ranks, _, _ = world
    res = {r: out["resume"] for r, out in enumerate(ranks)}
    m, p = res[0]["uninterrupted"]
    mz, pz = res[0]["zero-gdata2"]
    assert mz == m and all(torch.equal(pz[k], p[k]) for k in p)
    m1, p1 = res[0]["blocking-gdata1"]
    assert abs(m1["loss"] - m["loss"]) < LOSS_TOL
    assert abs(m1["grad_norm"] - m["grad_norm"]) < GN_RTOL * m["grad_norm"]
    assert max(float((p1[k] - p[k]).abs().max()) for k in p) < PARAM_TOL
    m, p = res[1]["uninterrupted"]
    mz, pz = res[1]["zero-gdata2"]
    assert mz == m and all(torch.equal(pz[k], p[k]) for k in p)


def test_dots_equals_full_on_the_overlapped_mesh(world):
    """Remat "dots" on (1,2,2,2) with OverlapConfig.all_on(): the loss and
    every gradient block bitwise "full"'s; the recompute runs no K1
    product (each rank's ring hop GEMMs included): 7 of 28 a layer
    fewer."""
    ranks, _, _ = world
    _, tcfg = _cfgs()
    for r, out in enumerate(ranks):
        (lf, cf, gf), (ld, cd, gd) = out["dots"]["full"], out["dots"]["dots"]
        assert lf == ld and all(torch.equal(gf[k], gd[k]) for k in gf), r
        assert cd < cf and (cf - cd) * 4 == cf - 3 * DOTS_MESH[3], (r, cf,
                                                                    cd)


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
