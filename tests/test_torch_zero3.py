"""The port's ZeRO-3 parameter-shard streaming (``core/gradsync.py``'s
leaf plan, shard helpers, ``gather_param_leaf`` and ``ParamStreamer``,
``adamw.apply_updates_sharded(rebuild=False)``, the decoder's per-layer
gather, the train step's ``GradSyncConfig(zero3=True)`` and the train
CLI's ``--zero3``/``--zero3-prefetch``) held against the JAX package's
ZeRO-3 and against the port's blocking and ZeRO-1 steps on the CPU, and
its data-axis traffic against the copied ``comm_model.dp_sync_volume``.

The plans are compared in this process. Everything that needs ranks runs
in one ``torch.distributed.run --nproc-per-node 8`` launch of this file's
``__main__``: each rank works through the meshes of ``MESHES`` in turn (a
mesh of fewer ranks leaves the others idle), while the JAX package
computes its side on the same mesh shapes in this process. Weights cross
with ``convert.params_from_jax``; inputs are made with numpy from seeds;
the port runs its kernels' plain versions. Tolerances are the reference's
``test_zero3_train_step_parity`` bounds (loss 1e-5, grad norm 1e-4
relative, parameters 5e-6 against the port's blocking step); bitwise at
g_data 2 and on exactly-summable values, and prefetch against no
prefetch.
"""
import dataclasses
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.core import gradsync as JGS
from repro.core.compat import shard_map
from repro.core.partition import spec_tree_to_pspecs
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import comm_model as CM
from repro_torch.core import gradsync as GS
from repro_torch.core import mesh as M
from repro_torch.core.gradsync import GradSyncConfig
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.partition import param_spec
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
JAMBA = "jamba-v0.1-52b-dense-ffn"
WORLD = 8
NAMES = ("data", "x", "y", "z", "seq")
PLAN_MESHES = [(2, 1, 1, 1), (2, 2, 2, 1), (2, 1, 1, 2), (4, 1, 1, 1)]
MESHES = {"dp2": (2, 2, 2, 1), "yz": (2, 1, 2, 2), "dp4": (4, 1, 2, 1),
          "seq": (2, 1, 1, 1, 2)}
Z3 = GradSyncConfig(zero3=True, bucket_mb=0.25)
# the reference's ZERO3_MODES (tests/test_zero3.py); "zero3_od1" runs one
# microbatch
MODES = {"zero3": Z3,
         "zero3_prefetch": GradSyncConfig(zero3=True, prefetch=True,
                                          bucket_mb=0.25),
         "zero3_noring": GradSyncConfig(zero3=True, ring=False),
         "zero3_od1": GradSyncConfig(zero3=True)}
BASES = {"blocking": GradSyncConfig(),
         "zero": GradSyncConfig(zero=True, bucket_mb=0.25)}
ALL_MODES_ON = ("dp2", "seq")      # the other meshes run "zero3" alone
BITWISE = ("dp2", "yz")            # g_data 2
RESUME = {"A": (2, 1, 1, 1), "B": (4, 1, 1, 1)}
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=50)
STEPS = 3
LOSS_TOL = 1e-5
GN_RTOL = 1e-4
PARAM_TOL = 5e-6
BF16_RTOL = 2e-2                   # test_torch_mesh_train.py's
JAX_THREADS = 4
# a mesh with g_y > 1 trains without qk-norm: the reference sums the
# qk-norm gains' gradients over data and z only (ROADMAP.md §3)
NOQK = dict(qk_norm=False)


def _od(mode):
    return 1 if mode.endswith("od1") else 2


def _cfgs(arch=ARCH, **kw):
    if arch == JAMBA:
        jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b"),
                                   moe=None, name=JAMBA).reduced()
    else:
        jcfg = jax_get_config(arch).reduced()
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _cfg_kw(sizes):
    return NOQK if MeshAxes(sizes).gy > 1 else {}


def _tree_name(sizes):
    return "qwen-noqk" if _cfg_kw(sizes) else "qwen"


def _train_batch(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (8, 32)).astype(np.int32)
            for _ in range(2)]


def _save_tree(tree, path):
    np.savez(path, **convert._flat_tree(tree))


def _load_tree(path):
    with np.load(path) as f:
        return convert._nest({k: f[k] for k in f.files})


def _cotangent(name, shape, rank):
    """Rank ``rank``'s cotangent of the leaf ``name``'s working copy:
    small integers, so every sum of them is exact."""
    seed = (sum(map(ord, name)) * 31 + rank) % (2 ** 31)
    return np.random.RandomState(seed).randint(-3, 4, shape).astype(
        np.float32)


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _torch_batch(arrays, axes):
    return ST.stripe_batch({k: torch.from_numpy(v) for k, v in
                            zip(("tokens", "labels"), arrays)}, axes)


def _opts(gs, od=2, **kw):
    kw.setdefault("dtype", torch.float32)
    return ST.TrainOptions(overdecompose=od, gradsync=gs, **kw)


def _build(tcfg, axes, tree, rank, opts):
    """The model of ``tree`` on this rank, in the layout of ``opts``, its
    optimizer state and tools."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    if opts.dtype != torch.float32:
        model = model.to(opts.dtype)
    gs = opts.gradsync
    if gs.zero3:
        ST.shard_model(model)
    params = dict(model.named_parameters())
    tools = (ST.make_gradsync_tools(tcfg, axes, params, opts)
             if gs.state_sharded else None)
    if tools is None:
        state = OPT.init_state(params)
    else:
        state = tools.init(model.shards if gs.zero3 else params)
    return model, tools, state


def _full_params(model, tools):
    if model.shards is None:
        return {n: p.detach().clone() for n, p in model.named_parameters()}
    return tools.unshard_params(model.shards)


class _Hops:
    """Records the bytes of every data-axis collective that moves blocks
    (all but the all-reduces: the grad norm's scalars) while it is on."""

    def __init__(self):
        self.sizes, self._count = [], M._count

    def __enter__(self):
        def count(kind, axis, nbytes, seconds):
            if kind != "all_reduce" and "+".join(M._names(axis)) == "data":
                self.sizes.append((kind, nbytes))
            return self._count(kind, axis, nbytes, seconds)
        M._count = count
        return self

    def __exit__(self, *exc):
        M._count = self._count


def _trajectory(tcfg, axes, tree, batch, rank, gs, od=2, steps=STEPS,
                **kw):
    """``steps`` steps of the train step of ``gs``: each step's metrics,
    its data-axis traffic by kind (``gradsync.DP_SYNC``) and the largest
    data-axis hop; the final full parameters."""
    opts = _opts(gs, od, **kw)
    model, tools, state = _build(tcfg, axes, tree, rank, opts)
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**OPT_CFG), opts,
                              tools=tools)
    out = []
    for _ in range(steps):
        GS.reset_dp_sync()
        with _Hops() as hops:
            m = {k: float(v) for k, v in step(model, state, batch).items()}
        out.append(dict(m, dp_sync={k: dict(v) for k, v in
                                    GS.DP_SYNC.items()},
                        hops=hops.sizes))
    return out, _full_params(model, tools)


def _exact_grads(params, seed):
    gen = torch.Generator().manual_seed(seed + 97 * M.process_rank())
    return {n: torch.randint(-1, 2, p.shape, generator=gen).float()
            for n, p in params.items()}


def _update_vs_blocking(tcfg, axes, tree, rank):
    """Two AdamW steps on exactly-summable gradients: the blocking sync and
    ``apply_updates`` against the gathers' backward (each gradient
    reduce-scattered over data by ``gather_param_leaf``), the shards'
    y/z reductions and ``apply_updates_sharded(rebuild=False)``. Returns
    (grad norms equal, parameters equal, gathered states equal)."""
    cfg = OPT.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    sb = OPT.init_state(base)
    ST.shard_model(model)
    opts = _opts(Z3)
    tools = ST.make_gradsync_tools(tcfg, axes, dict(model.named_parameters()),
                                   opts)
    sz = tools.init(model.shards)
    shapes = GS.leaf_shapes(tools.plan)
    norms = []
    for i in range(2):
        acc = ST.shard_grad_buffers(model.shards, tools.plan, True)
        grads = _exact_grads(base, i)
        g = ST.sync_grads({n: t.clone() for n, t in grads.items()}, axes)
        nb = OPT.apply_updates(base, g, sb, cfg,
                               no_decay=ST.no_decay_names(model),
                               specs={n: param_spec(n) for n in base},
                               axes=axes)["grad_norm"]
        for n, s in model.shards.items():
            w = GS.gather_param_leaf(s, shapes[n], axes)
            (w * grads[n]).sum().backward()
        ST.add_shard_grads(acc, model.shards, tools.plan)
        for s in model.shards.values():
            s.grad = None
        shards = GS.tensor_reduce_shards(acc, tools.plan, axes)
        nz = OPT.apply_updates_sharded(shards, sz, tools.plan, axes, cfg,
                                       params=model.shards,
                                       rebuild=False)["grad_norm"]
        norms.append(float(nb) == float(nz))
    full = tools.gather(sz)
    got = tools.unshard_params(model.shards)
    return (all(norms), all(torch.equal(got[n], base[n]) for n in base),
            all(torch.equal(full["opt"][n][k], sb["opt"][n][k])
                for n in base for k in ("m", "v", "master")))


def _worker_mesh(name, axes, outdir):
    rank = M.process_rank()
    sizes = MESHES[name]
    _, tcfg = _cfgs(**_cfg_kw(sizes))
    tree = _load_tree(outdir / f"{_tree_name(sizes)}.npz")
    out = {}
    full = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    params = {n: p.detach() for n, p in full.named_parameters()}
    shards = GS.shard_params(params, axes)
    out["shards"] = shards
    # the sharded init draws each part and shards it at once
    drawn = ST.init_model(tcfg, axes, seed=3, device="cpu")
    sharded = ST.init_model(tcfg, axes, seed=3, device="cpu", zero3=True)
    want = GS.shard_params(dict(drawn.named_parameters()), axes)
    out["init"] = (list(sharded.shards) == list(want) and all(
        torch.equal(sharded.shards[n], want[n]) for n in want)
        and all(p.is_meta for p in sharded.parameters()))
    plan = ST.train_plan(dict(sharded.named_parameters()), tcfg, axes, Z3)
    out["fingerprint"] = GS.plan_fingerprint(plan)
    # the round trip: the ring, the blocking gather, the posted exchange
    for ring in (True, False):
        back = GS.unshard_params(shards, plan, axes, ring=ring)
        posted = {n: GS.ParamStreamer(plan, axes, ring=ring).gather(
            s, n, GS._Fetch(s, axes, ring, M.GatherAsync(
                s, axes, "data", ring=ring))).detach()
            for n, s in shards.items()}
        out[f"roundtrip-{ring}"] = all(
            torch.equal(back[n], params[n]) and torch.equal(posted[n],
                                                            params[n])
            for n in params)
    # the gather's backward: this rank's block of the cotangents' data sum
    grads = {}
    for n, s in shards.items():
        s = s.clone().requires_grad_()
        w = GS.gather_param_leaf(s, params[n].shape, axes)
        (w * torch.from_numpy(_cotangent(n, tuple(w.shape), rank))
         ).sum().backward()
        grads[n] = s.grad
    out["transpose"] = grads
    if name in BITWISE:
        # with qk-norm: port against port, so its gains' psum over y (the
        # y_heads elements of their stacked buckets) is held too
        out["update"] = _update_vs_blocking(
            _cfgs()[1], axes, _load_tree(outdir / "qwen.npz"), rank)
    # trajectories
    train = _torch_batch(_train_batch(tcfg.vocab_size), axes)
    modes = list(MODES) if name in ALL_MODES_ON else ["zero3"]
    for mode in modes:
        out[f"traj-{mode}"] = _trajectory(tcfg, axes, tree, train, rank,
                                          MODES[mode], _od(mode))
    for base, gs in BASES.items():
        for od in sorted({_od(m) for m in modes}):
            out[f"traj-{base}-od{od}"] = _trajectory(tcfg, axes, tree, train,
                                                     rank, gs, od)
    if name == "dp2":
        out.update(_worker_dp2_extras(tcfg, axes, tree, train, rank))
    return out


def _worker_dp2_extras(tcfg, axes, tree, train, rank):
    """On dp2: a one-layer cut (its segment of one period is resident),
    bf16, and remat "dots" against "full"."""
    out = {}
    one = dataclasses.replace(tcfg, n_layers=1)
    cut = {k: v for k, v in tree.items()}
    cut["segments"] = {"seg0": {"pos0": jax.tree.map(
        lambda x: x[:1], tree["segments"]["seg0"]["pos0"])}}
    for mode in ("zero3", "zero3_prefetch", "blocking"):
        gs = MODES.get(mode, GradSyncConfig())
        out[f"cut-{mode}"] = _trajectory(one, axes, cut, train, rank, gs,
                                         steps=2)
    for mode, gs in (("zero3", Z3), ("zero", BASES["zero"])):
        out[f"bf16-{mode}"] = _trajectory(tcfg, axes, tree, train, rank, gs,
                                          dtype=torch.bfloat16)
    # one microbatch's loss and shard gradients under "full" and "dots",
    # and the K1 products each ran (their plain version, counted)
    tokens, labels = (M.seq_shard(M.batch_shard(train[k], axes), axes)
                      for k in ("tokens", "labels"))
    plain, calls = ops.block_matmul_plain, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)
    ops.block_matmul_plain = counted
    try:
        for policy in ("full", "dots"):
            model, tools, _ = _build(tcfg, axes, tree, rank, _opts(Z3))
            pstream = GS.ParamStreamer(tools.plan, axes)
            calls[0] = 0
            loss, _ = D.lm_loss(model, tokens[:4], labels[:4], remat=True,
                                remat_policy=policy, pstream=pstream)
            loss.backward()
            out[f"remat-{policy}"] = (float(loss.detach()), calls[0], {
                n: s.grad for n, s in model.shards.items()})
    finally:
        ops.block_matmul_plain = plain
    return out


def _read_snapshot(path, model):
    params, step = ckpt.restore(path, convert.jax_structs(model))
    state, _ = ckpt.restore(path, convert.jax_opt_structs(model),
                            root="opt_state")
    return {"params": params, "opt_state": state, "step": step,
            "fingerprint": None}


def _worker_resume(outdir):
    """ZeRO-3 on (2,1,1,1): one step, a checkpoint (rank 0 writes), a
    second step (the uninterrupted run); then resumed with ZeRO-3 at
    g_data 2 and at g_data 4; and the reference's ZeRO-3 file
    (``jax.npz``, g_data 2) restored at g_data 4. Returns {run: (metrics,
    final full parameters)} and the restored reference file's
    parameters and gathered state."""
    rank = M.process_rank()
    _, tcfg = _cfgs()
    tree = _load_tree(outdir / "qwen.npz")
    path = str(outdir / "port.npz")
    batch_np = _train_batch(tcfg.vocab_size)
    opts = _opts(Z3)
    cfg = OPT.AdamWConfig(**OPT_CFG)
    out = {}

    def run_on(sizes, snapshot=None):
        axes = MeshAxes(sizes)
        M.init_groups(axes)
        if rank >= axes.world:
            return None
        if snapshot is None:
            model, tools, state = _build(tcfg, axes, tree, rank, opts)
        else:
            model = ST.init_model(tcfg, axes, device="cpu", zero3=True)
            tools = ST.make_gradsync_tools(
                tcfg, axes, dict(model.named_parameters()), opts)
            state = ST.restore_state(snapshot, tcfg, axes, tools, opts,
                                     model)
        step = ST.make_train_step(tcfg, axes, cfg, opts, tools=tools)
        return model, tools, state, step, _torch_batch(batch_np, axes)

    r = run_on(RESUME["A"])
    if r is not None:
        model, tools, state, step, batch = r
        step(model, state, batch)
        snap = ST.snapshot_state(model, state, tools, opts, step=0,
                                 keep=rank == 0)
        if rank == 0:
            ckpt.save(path, snap["params"], snap["opt_state"], step=0,
                      pspecs=convert.jax_specs(model), extra=dict(
                          dp_bucket_mb=Z3.bucket_mb, zero3=True,
                          mesh=list(RESUME["A"]), zero=True))
        m = step(model, state, batch)
        out["uninterrupted"] = ({k: float(v) for k, v in m.items()},
                                _full_params(model, tools))
    torch.distributed.barrier()
    like = ST.init_model(tcfg, device="cpu")
    for key, sizes in (("gdata2", RESUME["A"]), ("gdata4", RESUME["B"])):
        r = run_on(sizes, _read_snapshot(path, like))
        if r is not None:
            model, tools, state, step, batch = r
            m = step(model, state, batch)
            out[key] = ({k: float(v) for k, v in m.items()},
                        _full_params(model, tools))
    r = run_on(RESUME["B"], _read_snapshot(str(outdir / "jax.npz"), like))
    if r is not None:
        model, tools, state, _, _ = r
        out["from-jax"] = (_full_params(model, tools),
                           tools.gather(state))
    torch.distributed.barrier()
    return out


def _rank_worker(outdir: pathlib.Path):
    """One rank: every mesh of MESHES in turn in one world of 8 (ranks
    past a mesh's size wait), then the checkpoint runs; saved to
    rank<r>.pt."""
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


def _jax_tools(jcfg, sizes, gs, od=2, dtype=jnp.float32):
    mesh, axes = _jax_mesh(sizes)
    opts = JST.TrainOptions(overdecompose=od, dtype=dtype, gradsync=gs)
    return mesh, axes, opts, JST.make_gradsync_tools(jcfg, mesh, axes, opts)


def _jax_params(jcfg, mesh, axes, tree, dtype=jnp.float32):
    _, specs = JST.init_model(jcfg, axes, abstract=True, dtype=dtype)
    return JST.device_put_tree(
        mesh, jax.tree.map(lambda x: jnp.asarray(x, dtype), tree),
        spec_tree_to_pspecs(specs))


def _jax_shards(jcfg, sizes, tree):
    """The reference's shard_params of ``tree`` per leaf, (world, stack,
    shard) or (world, shard) rows in the port's rank order, keyed by JAX
    path; and its leaf plan's fingerprint."""
    mesh, axes, _, tools = _jax_tools(jcfg, sizes, JGS.GradSyncConfig(
        zero3=True))
    shards = tools.shard_params(_jax_params(jcfg, mesh, axes, tree))
    world = int(np.prod(sizes))
    flat = {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(shards)[0]}
    out = {}
    for path, v in flat.items():
        stacked = v.ndim == 2
        out[path] = (v.reshape(v.shape[0], world, -1).transpose(1, 0, 2)
                     if stacked else v.reshape(world, -1))
    return out, JGS.plan_fingerprint(tools.plan)


def _jax_transpose(jcfg, sizes, tree):
    """The transpose JAX takes of the reference's gather_param_leaf on
    every leaf (unstacked, or one slot row of a stacked one), rank r's
    cotangent ``_cotangent(name, shape, r)``: per port parameter name
    (world, shard) rows, in one program."""
    from jax.sharding import PartitionSpec as P
    mesh, axes, _, tools = _jax_tools(jcfg, sizes, JGS.GradSyncConfig(
        zero3=True))
    jplan, world = tools.plan, int(np.prod(sizes))
    _, tcfg = _cfgs(**_cfg_kw(sizes))
    model = ST.init_model(tcfg, MeshAxes(sizes), device="cpu", zero3=True)
    plan = ST.train_plan(dict(model.named_parameters()), tcfg,
                         MeshAxes(sizes), Z3)
    shapes = GS.leaf_shapes(plan)
    names, buckets = [], []
    for lf, b in zip(plan.leaves, jplan.buckets):
        names += list(lf.names)
        buckets += [b] * len(lf.names)
    cots = [jnp.asarray(np.stack([_cotangent(n, shapes[n], r)
                                  for r in range(world)])) for n in names]
    everything = P(NAMES[:len(sizes)])

    def body(*cs):
        outs = []
        for c, b in zip(cs, buckets):
            shard = jnp.zeros((b.padded // jplan.dp,), jnp.float32)
            _, vjp = jax.vjp(lambda s, _b=b: JGS.gather_param_leaf(
                s, _b, axes), shard)
            outs.append(vjp(c[0].reshape(b.segments[0].shape))[0][None])
        return tuple(outs)
    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=tuple(everything for _ in names),
                           out_specs=tuple(everything for _ in names),
                           check_vma=False))
    return {n: np.asarray(g) for n, g in zip(names, fn(*cots))}


def _jax_trajectory(jcfg, sizes, tree, batch, gs, od=2,
                    dtype=jnp.float32):
    """The reference's ZeRO-3 step, STEPS steps: (loss, grad_norm) per
    step."""
    mesh, axes, opts, tools = _jax_tools(jcfg, sizes, gs, od, dtype)
    params = _jax_params(jcfg, mesh, axes, tree, dtype)
    state = tools.init(params)
    params = tools.shard_params(params)
    step_fn, _, _ = JST.make_train_step(
        jcfg, mesh, axes, JOPT.AdamWConfig(**OPT_CFG), opts)
    jb = JST.stripe_batch(dict(zip(("tokens", "labels"),
                                   map(jnp.asarray, batch))), axes)
    out = []
    for _ in range(STEPS):
        params, state, m = step_fn(params, state, jb)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _jax_checkpoint(path):
    """The reference's trainer writes a ZeRO-3 checkpoint on (2,1,1,1)."""
    from repro.launch import train as jtrain
    argv = sys.argv
    sys.argv = ["train", "--arch", ARCH, "--preset", "smoke", "--steps", "1",
                "--batch", "8", "--seq", "32", "--mesh", "2,1,1,1",
                "--zero3", "--dp-bucket-mb", "0.25", "--ckpt", str(path)]
    try:
        jtrain.main()
    finally:
        sys.argv = argv


def _jax_reads_port_file(path, jcfg):
    """The port's ZeRO-3 file restored by the reference at g_data 4 with
    its ZeRO-3 tools: the parameters gathered back from their shards and
    the state gathered back, against the file's arrays."""
    mesh, axes, _, tools = _jax_tools(jcfg, RESUME["B"], JGS.GradSyncConfig(
        zero3=True))
    structs, _ = JST.init_model(jcfg, axes, abstract=True,
                                dtype=jnp.float32)
    like = JOPT.init_state(structs, abstract=True)
    params, state, step = jckpt.restore_sharded(path, structs, like,
                                                tools.scatter)
    shards = tools.shard_params(params)
    back = jax.tree.map(np.asarray, tools.unshard_params(shards))
    full = jax.tree.map(np.asarray, tools.gather(state))
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files if not k.startswith("__")}
    got = {f"params/{k}": v for k, v in convert._flat_tree(back).items()}
    got.update({f"opt_state/opt/{k}": v for k, v in
                convert._flat_tree(full["opt"]).items()})
    return step, all(np.array_equal(got[k], arrays[k]) for k in got), \
        len(got)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX weights and the reference's ZeRO-3 checkpoint saved, the
    8-rank worker launched; while it runs, the JAX package computes its
    side on the same meshes (a few at a time on threads). Returns (ranks'
    results, JAX's results, outdir)."""
    outdir = tmp_path_factory.mktemp("zero3_ranks")
    _, axes = _jax_mesh((1, 1, 1, 1))
    trees = {}
    for key, kw in (("qwen", {}), ("qwen-noqk", NOQK)):
        params, _ = JST.init_model(_cfgs(**kw)[0], axes,
                                   jax.random.PRNGKey(0), dtype=jnp.float32)
        trees[key] = jax.tree.map(np.asarray, params)
        _save_tree(trees[key], outdir / f"{key}.npz")
    _jax_checkpoint(outdir / "jax.npz")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), __file__, str(outdir)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        tasks = []
        for name, sizes in MESHES.items():
            jcfg = _cfgs(**_cfg_kw(sizes))[0]
            tree = trees[_tree_name(sizes)]
            tcfg = _cfgs(**_cfg_kw(sizes))[1]
            train_np = _train_batch(tcfg.vocab_size)
            tasks.append(((name, "shards"), _jax_shards, (jcfg, sizes, tree)))
            tasks.append(((name, "transpose"), _jax_transpose,
                          (jcfg, sizes, tree)))
            ods = (1, 2) if name in ALL_MODES_ON else (2,)
            for od in ods:
                tasks.append(((name, f"traj-od{od}"), _jax_trajectory,
                              (jcfg, sizes, tree, train_np,
                               JGS.GradSyncConfig(zero3=True), od)))
        tasks.append((("dp2", "bf16"), _jax_trajectory, (
            _cfgs(**NOQK)[0], MESHES["dp2"], trees["qwen-noqk"],
            _train_batch(_cfgs()[1].vocab_size),
            JGS.GradSyncConfig(zero3=True), 2, jnp.bfloat16)))
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            done = [pool.submit(fn, *args) for _, fn, args in tasks]
            jax_out = {key: f.result() for (key, *_), f in zip(tasks, done)}
    finally:
        _wait(proc)
    jax_out["reads-port"] = _jax_reads_port_file(str(outdir / "port.npz"),
                                                 _cfgs()[0])
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out, outdir


def _ranks_of(world, name):
    ranks, _, _ = world
    return [(r, out[name]) for r, out in enumerate(ranks) if name in out]


# ---------------------------------------------------------------------- #
# the plan (in this process)
# ---------------------------------------------------------------------- #

def _plans(arch, sizes, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    _, jaxes = _jax_mesh(sizes)
    structs, specs = JST.init_model(jcfg, jaxes, abstract=True,
                                    dtype=jnp.float32)
    jplan = JST._zero3_plan(structs, specs, jaxes)
    axes = MeshAxes(sizes)
    model = ST.init_model(tcfg, axes, device="cpu", zero3=True)
    plan = ST.train_plan(dict(model.named_parameters()), tcfg, axes, Z3)
    flat, _ = jax.tree_util.tree_flatten_with_path(structs)
    return jplan, plan, ["/".join(str(k.key) for k in p) for p, _ in flat]


@pytest.mark.parametrize("sizes", PLAN_MESHES, ids=str)
@pytest.mark.parametrize("arch,kw", [(ARCH, {}), (JAMBA, {}),
                                     (ARCH, dict(n_layers=1))],
                         ids=["qwen3", "jamba", "qwen3-one-layer"])
def test_leaf_plan_matches_the_reference(arch, kw, sizes):
    """One bucket a leaf in the JAX tree's order, each stacked leaf
    sharded per layer (a one-period segment unstacked, its leading 1
    kept): the reference's make_leaf_plan bucket for bucket, and its
    plan_fingerprint."""
    jplan, plan, paths = _plans(arch, sizes, **kw)
    assert [lf.path for lf in plan.leaves] == paths
    assert plan.dp == jplan.dp and plan.n_leaves == jplan.n_leaves
    assert len(plan.buckets) == len(jplan.buckets) == len(paths)
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
    stacked = any(n > 1 for _, n in _cfgs(arch, **kw)[1].segments())
    assert any(b.stack > 1 for b in plan.buckets) == stacked


def test_zero3_state_bytes_shrink_by_gdata():
    """Per-rank parameter and optimizer bytes under ZeRO-3 are the
    blocking layout's divided by g_data, plus at most a ring block of
    padding a leaf and layer, and what the shards and state hold."""
    _, tcfg = _cfgs()
    axes = MeshAxes((4, 1, 1, 1))
    model = ST.init_model(tcfg, axes, device="cpu")
    params = dict(model.named_parameters())
    full = ST.state_layouts(tcfg, axes, params, _opts(GradSyncConfig()))
    ST.shard_model(model)
    meta = dict(model.named_parameters())
    z3 = ST.state_layouts(tcfg, axes, meta, _opts(Z3))
    plan = ST.train_plan(meta, tcfg, axes, Z3)
    slack = 4 * sum(b.stack for b in plan.buckets)
    assert full["params"] / 4 <= z3["params"] <= full["params"] / 4 + slack
    assert full["opt_state"] / 4 <= z3["opt_state"] <= (
        full["opt_state"] / 4 + 3 * slack)
    assert z3["params"] == sum(s.numel() * s.element_size()
                               for s in model.shards.values())
    state = GS.init_state_from_shards(model.shards, plan)
    assert sum(t.numel() * t.element_size() for b in state["buckets"]
               for k, t in b.items()) == z3["opt_state"]


def test_init_state_from_shards_is_init_sharded_state():
    """The state made from the shards has the bits of the reference's
    init_sharded_state on the full parameters (stacked leaves (stack,
    padded/dp))."""
    _, tcfg = _cfgs()
    axes = MeshAxes((1, 1, 1, 1))
    model = ST.init_model(tcfg, axes, device="cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    plan = ST.train_plan(params, tcfg, axes, Z3)
    want = GS.init_sharded_state(params, plan, axes)
    got = GS.init_state_from_shards(GS.shard_params(params, axes), plan)
    for b, w, g in zip(plan.buckets, want["buckets"], got["buckets"]):
        assert w["master"].shape == ((b.stack, b.padded) if b.stack > 1
                                     else (b.padded,))
        assert all(torch.equal(w[k], g[k]) for k in ("m", "v", "master"))


# ---------------------------------------------------------------------- #
# the CLI (one rank, in this process)
# ---------------------------------------------------------------------- #

CLI = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--steps",
       "4", "--batch", "4", "--seq", "16", "--log-every", "1",
       "--dp-bucket-mb", "0.25"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train CLI on one rank, torch on one thread (beside the other
    test files' workers): 4 uninterrupted steps under --zero3 and
    blocking, and runs stopped after 3 of them with a checkpoint, one
    under --zero3 and one blocking. Returns ({mode: full run}, {mode:
    checkpoint path})."""
    outdir = tmp_path_factory.mktemp("zero3_cli")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        full, paths = {}, {}
        for mode, flags in (("zero3", ["--zero3"]), ("blocking", [])):
            full[mode] = train.main([*CLI, *flags])
            paths[mode] = str(outdir / f"{mode}.npz")
            cut = train.main([*CLI, *flags, "--ckpt", paths[mode]],
                             stop_after=3)
            assert cut.losses == full[mode].losses[:3]
        yield full, paths
    finally:
        torch.set_num_threads(threads)


def _resume(flags, path, tmp_path):
    """``--resume`` from a copy of the checkpoint ``path`` (the resumed
    run saves over its file)."""
    mine = str(tmp_path / "run.npz")
    shutil.copyfile(path, mine)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return train.main([*CLI, *flags, "--ckpt", mine, "--resume"])
    finally:
        torch.set_num_threads(threads)


def test_train_cli_zero3_checkpoint_keys_are_the_reference_trainers(
        world, cli_runs):
    """``--zero3 --ckpt``: the file's extra holds the keys the reference's
    trainer writes under --zero3 (its save_sharded adds "zero"), zero3
    true, and the run's losses are the blocking run's."""
    full, paths = cli_runs
    assert full["zero3"].losses == pytest.approx(full["blocking"].losses,
                                                 rel=1e-6)
    _, _, outdir = world
    mine = json.loads(str(np.load(paths["zero3"])["__meta__"]))["extra"]
    theirs = json.loads(str(np.load(outdir / "jax.npz")["__meta__"]))[
        "extra"]
    assert sorted(mine) == sorted(theirs)
    assert mine["zero3"] is True and theirs["zero3"] is True
    assert mine["dp_bucket_mb"] == theirs["dp_bucket_mb"] == 0.25


@pytest.mark.parametrize("resume", [["--zero3"], ["--zero3",
                                                   "--zero3-prefetch"],
                                    ["--zero"], []],
                         ids=["zero3", "prefetch", "zero", "blocking"])
def test_train_cli_zero3_resumes_across_modes(cli_runs, resume, tmp_path):
    """Stopped after 3 of 4 steps under --zero3, resumed for the 4th under
    each mode: the step matches the uninterrupted run's (bitwise under
    --zero3, with or without prefetch)."""
    full, paths = cli_runs
    full = full["zero3"]
    res = _resume(resume, paths["zero3"], tmp_path)
    assert res.first_step == 3 and len(res.losses) == 1
    if resume[:1] == ["--zero3"]:
        assert res.losses[0] == full.losses[3]
        assert res.grad_norms[0] == full.grad_norms[3]
    assert abs(res.losses[0] - full.losses[3]) < LOSS_TOL
    assert abs(res.grad_norms[0] - full.grad_norms[3]) < GN_RTOL * \
        full.grad_norms[3]


def test_train_cli_blocking_checkpoint_resumes_under_zero3(cli_runs,
                                                          tmp_path):
    full, paths = cli_runs
    res = _resume(["--zero3"], paths["blocking"], tmp_path)
    assert res.first_step == 3
    assert abs(res.losses[0] - full["blocking"].losses[3]) < LOSS_TOL


# ---------------------------------------------------------------------- #
# on the ranks
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(MESHES))
def test_shards_match_the_reference(world, name):
    """Each rank's shard of every parameter is bitwise the reference's
    shard_params row (a stacked leaf's layer i: row i of its (stack,
    padded/dp) shard); the fingerprints agree; the init that shards each
    part as it is drawn gives shard_params(init_model(...))'s bits."""
    _, jax_out, _ = world
    jshards, fp = jax_out[name, "shards"]
    _, tcfg = _cfgs(**_cfg_kw(MESHES[name]))
    for r, out in _ranks_of(world, name):
        assert out["fingerprint"] == fp and out["init"], r
        for n, s in out["shards"].items():
            want = jshards[convert.jax_path(n, tcfg)][r]
            if want.ndim == 2:
                want = want[convert._slot(n, tcfg)[2]]
            np.testing.assert_array_equal(s.numpy(), want.reshape(-1),
                                          err_msg=f"rank {r} {n}")


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "blocking"])
@pytest.mark.parametrize("name", list(MESHES))
def test_shard_gather_roundtrip(world, name, ring):
    """unshard_params(shard_params(p)) is p bitwise, and so is the
    exchange posted ahead (``mesh.GatherAsync``) that prefetch uses."""
    for r, out in _ranks_of(world, name):
        assert out[f"roundtrip-{ring}"], r


@pytest.mark.parametrize("name", list(MESHES))
def test_gather_backward_is_the_jax_transpose(world, name):
    """gather_param_leaf's backward (the gradient reduce-scattered over
    data) against the transpose JAX takes of the reference's
    gather_param_leaf, on exactly-summable cotangents: bitwise."""
    _, jax_out, _ = world
    want = jax_out[name, "transpose"]
    for r, out in _ranks_of(world, name):
        for n, g in out["transpose"].items():
            np.testing.assert_array_equal(g.numpy(), want[n][r],
                                          err_msg=f"rank {r} {n}")


@pytest.mark.parametrize("name", BITWISE)
def test_zero3_update_bitwise_vs_blocking(world, name):
    """Two ZeRO-3 updates on exactly-summable gradients (through the
    gathers' backward, rebuild=False) equal the blocking sync and
    replicated AdamW bitwise: grad norms, parameters, gathered state; on
    a model with qk-norm, whose gains' gradients both psum over y."""
    for r, out in _ranks_of(world, name):
        assert out["update"] == (True, True, True), r


def _zero3_modes(name):
    return list(MODES) if name in ALL_MODES_ON else ["zero3"]


@pytest.mark.parametrize("name,mode", [(n, m) for n in MESHES
                                       for m in _zero3_modes(n)])
def test_zero3_step_matches_the_jax_zero3_step(world, name, mode):
    """Each mode's 3 steps against the reference's ZeRO-3 step at the
    same overdecompose on the same mesh: loss within 1e-5 and grad norm
    within 1e-4 (relative) at every step."""
    _, jax_out, _ = world
    jtraj = jax_out[name, f"traj-od{_od(mode)}"]
    for r, out in _ranks_of(world, name):
        got, _ = out[f"traj-{mode}"]
        for i, (jl, jn) in enumerate(jtraj):
            assert abs(got[i]["loss"] - jl) < LOSS_TOL, (r, i)
            assert abs(got[i]["grad_norm"] - jn) < GN_RTOL * jn, (r, i)


@pytest.mark.parametrize("base", list(BASES))
@pytest.mark.parametrize("name,mode", [(n, m) for n in MESHES
                                       for m in _zero3_modes(n)])
def test_zero3_step_matches_the_ports_blocking_and_zero1_steps(
        world, name, mode, base):
    """Each mode's 3 steps against the port's blocking and ZeRO-1 steps
    at the same overdecompose: the reference's bounds (loss 1e-5, grad
    norm 1e-4 relative, parameters 5e-6)."""
    for r, out in _ranks_of(world, name):
        want, pb = out[f"traj-{base}-od{_od(mode)}"]
        got, pz = out[f"traj-{mode}"]
        for w, g in zip(want, got):
            assert abs(g["loss"] - w["loss"]) < LOSS_TOL, r
            assert abs(g["grad_norm"] - w["grad_norm"]) < GN_RTOL * max(
                1.0, w["grad_norm"]), r
        gap = max(float((pz[k] - pb[k]).abs().max()) for k in pb)
        assert gap < PARAM_TOL, (r, gap)


@pytest.mark.parametrize("name", ALL_MODES_ON)
def test_prefetch_is_bitwise_no_prefetch(world, name):
    """The same gathered values and the same reduce-scatters: losses,
    grad norms and parameters bitwise."""
    for r, out in _ranks_of(world, name):
        (a, pa), (b, pb) = out["traj-zero3"], out["traj-zero3_prefetch"]
        assert [(m["loss"], m["grad_norm"]) for m in a] == [
            (m["loss"], m["grad_norm"]) for m in b], r
        assert all(torch.equal(pa[k], pb[k]) for k in pa), r


@pytest.mark.parametrize("name,mode", [(n, m) for n in MESHES
                                       for m in _zero3_modes(n)
                                       if m != "zero3_noring"])
def test_streaming_window_and_passes(world, name, mode):
    """No data-axis hop of a step moves more than one leaf's shard (each
    way), and per microbatch each streamed leaf is gathered, gathered
    again by remat (not with prefetch) and reduce-scattered once; each
    resident leaf gathered and reduce-scattered once."""
    _, tcfg = _cfgs(**_cfg_kw(MESHES[name]))
    axes = MeshAxes(MESHES[name])
    model = ST.init_model(tcfg, axes, device="cpu", zero3=True)
    plan = ST.train_plan(dict(model.named_parameters()), tcfg, axes, Z3)
    pstream = GS.ParamStreamer(plan, axes)
    names = list(model.shards)
    streamed = [n for n in names if pstream.streamed(n)]
    assert 0 < len(streamed) < len(names)
    unit = 2 * 4 * max(b.padded // plan.dp for b in plan.buckets)
    total = 2 * 4 * sum(b.padded * b.stack for b in plan.buckets)
    assert unit < total / 4
    mb = _od(mode)
    for r, out in _ranks_of(world, name):
        for m in out[f"traj-{mode}"][0]:
            dp = m["dp_sync"]
            assert dp["all_gather"]["calls"] == mb * len(names), r
            assert dp["reduce_scatter"]["calls"] == mb * len(names), r
            regather = dp.get("regather", {"calls": 0})["calls"]
            assert regather == (0 if "prefetch" in mode
                                else mb * len(streamed)), r
            assert m["hops"] and max(b for _, b in m["hops"]) <= unit, r
            assert sum(b for _, b in m["hops"]) == sum(
                c["bytes"] for c in dp.values()), r


@pytest.mark.parametrize("name,mode", [(n, m) for n in MESHES
                                       for m in ["zero", "zero3"]
                                       + (["zero3_prefetch", "zero3_od1"]
                                          if n in ALL_MODES_ON else [])])
def test_counted_data_axis_volume_is_the_comm_models(world, name, mode):
    """The data-axis bytes each step counts (every hop's bytes sent and
    received) are twice 4 bytes times the copied
    ``comm_model.dp_sync_volume`` over the same padded buffers: ZeRO-1's
    buckets (a reduce-scatter a microbatch, one all-gather), ZeRO-3's
    streamed leaves (3 passes a microbatch, 2 with prefetch) and its
    resident leaves (2 passes: the model's prefetch count)."""
    _, tcfg = _cfgs(**_cfg_kw(MESHES[name]))
    axes = MeshAxes(MESHES[name])
    gs = BASES.get(mode) or MODES[mode]
    od = 1 if mode == "zero3_od1" else 2
    model = ST.init_model(tcfg, axes, device="cpu", zero3=gs.zero3)
    plan = ST.train_plan(dict(model.named_parameters()), tcfg, axes, gs)
    p = axes.dp
    elems = 0.0
    for b in plan.buckets:
        buf = b.padded * b.stack
        mine = gs if b.stack > 1 or not gs.zero3 else dataclasses.replace(
            gs, prefetch=True)
        elems += CM.dp_sync_volume(p, buf, mine, od)
    key = "traj-zero-od2" if mode == "zero" else f"traj-{mode}"
    for r, out in _ranks_of(world, name):
        for m in out[key][0]:
            counted = sum(c["bytes"] for c in m["dp_sync"].values())
            assert counted == 2 * 4 * elems, (r, counted, elems)


def test_one_layer_cut_is_resident_and_matches_blocking(world):
    """A one-period segment (n_layers 1) is gathered once a microbatch
    with the resident leaves, never by remat; its steps match the
    blocking step's, with and without prefetch."""
    for r, out in _ranks_of(world, "dp2"):
        base, pb = out["cut-blocking"]
        for mode in ("zero3", "zero3_prefetch"):
            got, pz = out[f"cut-{mode}"]
            for w, g in zip(base, got):
                assert abs(g["loss"] - w["loss"]) < LOSS_TOL, r
                assert "regather" not in g["dp_sync"], r
            gap = max(float((pz[k] - pb[k]).abs().max()) for k in pb)
            assert gap < PARAM_TOL, (r, gap)


def test_bf16_zero3_step_at_dp2(world):
    """bfloat16 at (2,2,2,1): the ZeRO-3 step against the reference's bf16
    ZeRO-3 step and the port's bf16 ZeRO-1 step, within bf16's 2e-2."""
    _, jax_out, _ = world
    jtraj = jax_out["dp2", "bf16"]
    for r, out in _ranks_of(world, "dp2"):
        got, _ = out["bf16-zero3"]
        z1, _ = out["bf16-zero"]
        for (jl, jn), g, w in zip(jtraj, got, z1):
            assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
            assert abs(g["loss"] - jl) <= BF16_RTOL * abs(jl), r
            assert abs(g["grad_norm"] - jn) <= BF16_RTOL * jn, r
            assert abs(g["loss"] - w["loss"]) <= BF16_RTOL * abs(w["loss"])


def test_dots_equals_full_under_zero3(world):
    """Remat "dots" under ZeRO-3 at (2,2,2,1): the loss and every shard's
    gradient bitwise "full"'s, with 7 of the 28 K1 products a layer fewer
    (the recompute replays them)."""
    _, tcfg = _cfgs(**NOQK)
    for r, out in _ranks_of(world, "dp2"):
        (lf, cf, gf), (ld, cd, gd) = out["remat-full"], out["remat-dots"]
        assert lf == ld and all(torch.equal(gf[k], gd[k]) for k in gf), r
        assert cf - cd == 7 * tcfg.n_layers, (r, cf, cd)


def test_resume_across_gdata_and_from_the_reference(world):
    """A ZeRO-3 checkpoint written at g_data 2 resumes at g_data 2
    bitwise the uninterrupted step and at g_data 4 within the step's
    bounds; the reference's ZeRO-3 file restores into the port at g_data
    4 with its parameters and state bitwise; the port's file restores
    into the reference at g_data 4 bitwise."""
    ranks, jax_out, outdir = world
    m, p = ranks[0]["resume"]["uninterrupted"]
    m2, p2 = ranks[0]["resume"]["gdata2"]
    assert m2 == m and all(torch.equal(p2[k], p[k]) for k in p)
    for r in range(RESUME["B"][0]):
        m4, p4 = ranks[r]["resume"]["gdata4"]
        assert abs(m4["loss"] - m["loss"]) < LOSS_TOL
        assert abs(m4["grad_norm"] - m["grad_norm"]) < GN_RTOL * \
            m["grad_norm"]
        assert max(float((p4[k] - p[k]).abs().max()) for k in p) < \
            PARAM_TOL
    with np.load(outdir / "jax.npz") as f:
        arrays = {k: f[k] for k in f.files}
    _, tcfg = _cfgs()
    want_p = {k[len("params/"):]: v for k, v in arrays.items()
              if k.startswith("params/")}
    for r in range(RESUME["B"][0]):
        params, full = ranks[r]["resume"]["from-jax"]
        for n, v in params.items():
            block = convert._block(want_p, n, tcfg, MeshAxes(), 0)
            assert torch.equal(v, block), (r, n)
        for n, st in full["opt"].items():
            path = convert.jax_path(n, tcfg)
            for k, v in st.items():
                leaf = arrays[f"opt_state/opt/{path}/{k}"]
                if n.startswith("layers."):
                    leaf = leaf[convert._slot(n, tcfg)[2]]
                np.testing.assert_array_equal(v.numpy(), leaf)
        assert full["step"] == int(arrays["opt_state/step"])
    step, equal, n_arrays = jax_out["reads-port"]
    assert step == 0 and equal and n_arrays > 4


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
