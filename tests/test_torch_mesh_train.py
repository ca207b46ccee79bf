"""The port's training on the multi-rank mesh (data, x, y, z and seq above
1) held against the JAX package on the CPU.

One ``torch.distributed.run --nproc-per-node 8`` launch of this file's
``__main__`` runs eight gloo ranks; within that world each rank trains four
meshes in turn: ``mesh4`` (2,2,2,1) with the reduced ``qwen3-1.7b``,
``meshz`` (1,2,2,2), ``dup`` (2,1,4,1) with ``n_kv_heads=2`` (the
duplicated-KV layout) and ``seqtp`` (1,2,2,1,2), the seq axis beside x and
y (K4's plain version on the path). The JAX package runs on the same mesh
shapes in this process (8 forced host devices) and on the one-device mesh;
weights cross with ``convert.params_from_jax(..., axes, rank)`` and inputs
are made with numpy from seeds. On the CPU the port's wrappers run their
kernels' plain versions.

Held on each mesh: the loss and every gradient block of one microbatch
after the step's reductions, against JAX on the same mesh and against the
one-device gradient; the 3-step trajectory of ``conftest.train_smoke``'s
settings in float32 against the one-device JAX step (and, with
``qk_norm=False``, against JAX's step on the same mesh); on ``mesh4`` and
``meshz`` the same in bfloat16, and the weight gradients' fp32 z
reduce-scatter; equal bits on the data replicas. Two JAX-only tests pin the
reference's faults that the port does not copy (ROADMAP.md §3): its
qk-norm gains' gradients hold only their y rank's heads, and in the
duplicated-KV layout the kv projection's input gradient is not summed over
y. Tolerances are ``tests/test_torch_training.py``'s (float32, sums in
another order) and, in bfloat16, ``tests/test_torch_kernels.py``'s.
"""
import dataclasses
import json
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
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core import mesh as JM
from repro.core.compat import shard_map
from repro.core.partition import spec_tree_to_pspecs
from repro.core.partition import z_reduce_grads as jax_z_reduce_grads
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.models import decoder as JD
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.partition import LEAF_SPECS, param_spec
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
WORLD = 8
NAMES = ("data", "x", "y", "z", "seq")
# name -> (mesh sizes, config changes on both sides)
MESHES = {"mesh4": ((2, 2, 2, 1), {}),
          "meshz": ((1, 2, 2, 2), {}),
          "dup": ((2, 1, 4, 1), {"n_kv_heads": 2}),
          "seqtp": ((1, 2, 2, 1, 2), {})}
BF16_MESHES = ("mesh4", "meshz")
VARIANTS = ("qk", "noqk")          # qk_norm on (the config's) and off
LOSS_RTOL = 1e-5      # lm_loss, relative          (test_torch_training.py)
GRAD_REL = 1e-4       # per leaf: max|dg| <= GRAD_REL * max|g_leaf|
TRAJ_RTOL = 1e-4      # loss and grad_norm at each step, relative
BF16_RTOL = 2e-2      # test_torch_kernels.py's BF16_TOL (test_kernels.py)
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=50)
LOSS_BATCH = (4, 32)  # one microbatch: B over (data, z), T over seq
JAX_THREADS = 4       # JAX computations at once beside the 8 ranks
CLI_FLAGS = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
             "--steps", "3", "--batch", "4", "--seq", "32", "--log-every",
             "1"]


def _cfgs(name, variant="qk"):
    kw = dict(MESHES[name][1])
    if variant == "noqk":
        kw["qk_norm"] = False
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _inputs(vocab):
    """The loss batch and conftest.train_smoke's batch (B 8, S 32)."""
    rng = np.random.RandomState(8)
    loss = [rng.randint(0, vocab, LOSS_BATCH).astype(np.int32)
            for _ in range(2)]
    rng = np.random.RandomState(0)
    traj = [rng.randint(0, vocab, (8, 32)).astype(np.int32)
            for _ in range(2)]
    return dict(loss=loss, traj=traj)


def _save_tree(tree, path):
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    np.savez(path, **flat)


def _load_tree(path):
    tree = {}
    with np.load(path) as f:
        for k in f.files:
            node = tree
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[k]
    return tree


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _torch_batch(arrays, axes):
    return ST.stripe_batch({k: torch.from_numpy(v) for k, v in
                            zip(("tokens", "labels"), arrays)}, axes)


def _trajectory(tcfg, axes, tree, batch, rank, *, dtype=torch.float32,
                overdecompose=2, steps=3):
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank).to(dtype)
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(overdecompose=overdecompose,
                                              dtype=dtype))
    out = [{k: float(v) for k, v in step(model, state, batch).items()}
           for _ in range(steps)]
    return out, ST.param_sha256(model)


def _exact_block(a, b, axes, spec):
    """This rank's block, by ``spec``, of a^T b over the rows of its data
    shard of the global operands (the batch splits data-major over (data,
    z)), in float64: the sum rounded nowhere; and the same of |a|^T |b|,
    which bounds the fp32 sum's error."""
    a, b = (t.chunk(axes.dp, 0)[M.axis_index(axes, "data")].double()
            for t in (a, b))
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (M.shard(a.t() @ b, axes, spec),
            M.shard(a.abs().t() @ b.abs(), axes, spec), a.shape[0])


def _weight_grads_bf16(axes):
    """A bf16 ``tp_matmul`` and tied head, forward and backward, on this
    rank's shards of global inputs: the weight gradients the backward
    reduce-scatters over z, beside the exact sums of their blocks."""
    gen = torch.Generator().manual_seed(11)
    B, S, k, n, V = 4, 8, 64, 96, 128
    bz = ("data", "z")
    x, dy = torch.randn(B, S, k, generator=gen), torch.randn(B, S, n,
                                                             generator=gen)
    w = torch.randn(k, n, generator=gen) / 8
    h, dlg = torch.randn(B, S, k, generator=gen), torch.randn(B, S, V,
                                                              generator=gen)
    table = torch.randn(V, k, generator=gen) / 8
    x, dy, w, h, dlg, table = (t.to(torch.bfloat16)
                               for t in (x, dy, w, h, dlg, table))
    wl = M.shard(w, axes, param_spec("wq")).clone().requires_grad_()
    PP.tp_matmul(M.shard(x, axes, (bz, None, "x")), wl, axes, "x", "y"
                 ).backward(M.shard(dy, axes, (bz, None, "y")))
    tl = M.shard(table, axes, param_spec("embed")).clone().requires_grad_()
    PP.tied_lm_logits(M.shard(h, axes, (bz, None, "x")), tl, axes
                      ).backward(M.shard(dlg, axes, (bz, None, "y")))
    return dict(dw=(wl.grad, *_exact_block(x, dy, axes, param_spec("wq"))),
                dtable=(tl.grad, *_exact_block(dlg, h, axes,
                                               param_spec("embed"))))


def _worker_mesh(name, axes, outdir):
    rank = M.process_rank()
    _, tcfg = _cfgs(name)
    inp = _inputs(tcfg.vocab_size)
    trees = {v: _load_tree(outdir / f"{name}-{v}.npz") for v in VARIANTS}
    out = {}
    # one microbatch: the loss and this rank's gradient blocks after the
    # step's reductions
    model = convert.params_from_jax(trees["qk"], tcfg, "cpu", axes, rank)
    batch = _torch_batch(inp["loss"], axes)
    tokens, labels = (M.seq_shard(M.batch_shard(batch[k], axes), axes)
                      for k in ("tokens", "labels"))
    loss, _ = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = {k: g.clone() for k, g in ST.sync_grads(
        {n: p.grad for n, p in model.named_parameters()}, axes).items()}
    # 3 steps in float32, qk-norm on and off
    traj = _torch_batch(inp["traj"], axes)
    for v in VARIANTS:
        _, vcfg = _cfgs(name, v)
        out[f"traj-{v}"], out[f"sha-{v}"] = _trajectory(vcfg, axes, trees[v],
                                                        traj, rank)
    if name in BF16_MESHES:
        _, vcfg = _cfgs(name, "noqk")
        for od, steps in ((2, 3), (1, 1)):
            out[f"bf16-od{od}"], _ = _trajectory(
                vcfg, axes, trees["noqk"], traj, rank, dtype=torch.bfloat16,
                overdecompose=od, steps=steps)
        out["rs_bf16"] = _weight_grads_bf16(axes)
    return out


def _rank_worker(outdir: pathlib.Path):
    """One rank: every mesh of MESHES in turn in one world of 8, saved to
    rank<r>.pt."""
    from repro_torch.launch.mesh import close_mesh, init_mesh
    out = {}
    try:
        for i, (name, (sizes, _)) in enumerate(MESHES.items()):
            axes = MeshAxes(sizes)
            if i == 0:
                init_mesh(axes, device="cpu")
            else:
                M.init_groups(axes)
            out[name] = _worker_mesh(name, axes, outdir)
        rank = M.process_rank()
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
    """``args`` under ``torch.distributed.run`` on ``nproc`` ranks, started
    in a session of its own (so that a timeout stops the launcher and
    every rank together)."""
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


def _jax_grads(jcfg, sizes, tree, tokens, labels):
    """JAX's loss and every device's gradient blocks after the step's
    reductions (psum over data and seq, then ``z_reduce_grads``): leaves
    stacked (world, ...) in the row-major device order of the mesh, which
    is the port's rank order."""
    mesh, axes = _jax_mesh(sizes)
    names = NAMES[:len(sizes)]
    _, specs = JST.init_model(jcfg, axes, abstract=True, dtype=jnp.float32)
    pspecs = spec_tree_to_pspecs(specs)
    params = JST.device_put_tree(mesh, jax.tree.map(jnp.asarray, tree),
                                 pspecs)

    def step(p, t, lab):
        (loss, _), g = jax.value_and_grad(
            lambda p: JD.lm_loss(p, jcfg, axes, t, lab, remat=True),
            has_aux=True)(p)
        g = jax.tree.map(lambda x: JM.psum(x, axes.data), g)
        if axes.seq is not None:
            g = jax.tree.map(lambda x: JM.psum(x, axes.seq), g)
        g = jax_z_reduce_grads(g, specs, axes, JM.psum)
        return loss, jax.tree.map(lambda x: x[None], g)
    bspec = P(("data", "z"), "seq" if len(sizes) == 5 else None)
    f = shard_map(step, mesh=mesh, in_specs=(pspecs, bspec, bspec),
                  out_specs=(P(), jax.tree.map(lambda _: P(names), tree)),
                  check_vma=False)
    tokens, labels = (JM.stripe_seq(jnp.asarray(t), axes.gseq)
                      for t in (tokens, labels))
    loss, g = jax.jit(f)(params, tokens, labels)
    return float(loss), jax.tree.map(np.asarray, g)


def _jax_trajectory(jcfg, sizes, tree, batch, *, dtype=jnp.float32,
                    overdecompose=2, steps=3):
    """conftest.train_smoke's step: (loss, grad_norm) per step."""
    mesh, axes = _jax_mesh(sizes)
    _, specs = JST.init_model(jcfg, axes, abstract=True, dtype=dtype)
    params = JST.device_put_tree(
        mesh, jax.tree.map(lambda a: jnp.asarray(a, dtype), tree),
        spec_tree_to_pspecs(specs))
    state = JOPT.init_state(params)
    step_fn, _, _ = JST.make_train_step(
        jcfg, mesh, axes, JOPT.AdamWConfig(**OPT_CFG),
        JST.TrainOptions(overdecompose=overdecompose, dtype=dtype))
    jb = JST.stripe_batch(dict(zip(("tokens", "labels"),
                                   map(jnp.asarray, batch))), axes)
    out = []
    for _ in range(steps):
        params, state, m = step_fn(params, state, jb)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _one_device_tree(tree):
    """The one-device leaves of the same function: the duplicated-KV
    layout's ``wkv_dup`` (d, 2 nkv hd) split into ``wk`` and ``wv``."""
    out = {k: _one_device_tree(v) if isinstance(v, dict) else v
           for k, v in tree.items()}
    if "wkv_dup" in out:
        out["wk"], out["wv"] = np.split(out.pop("wkv_dup"), 2, axis=-1)
    return out


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _one_device_leaf(grads, path):
    """The one-device gradient (``_jax_grads`` on (1,1,1,1)) of the JAX
    leaf at ``path``, its device dim dropped; ``wkv_dup``'s is [wk |
    wv]."""
    if path.endswith("/wkv_dup"):
        base = path.rsplit("/", 1)[0]
        return np.concatenate([_leaf(grads, f"{base}/{k}")[0]
                               for k in ("wk", "wv")], axis=-1)
    return _leaf(grads, path)[0]


def _init_tree(jcfg, sizes):
    _, axes = _jax_mesh(sizes)
    params, _ = JST.init_model(jcfg, axes, jax.random.PRNGKey(0),
                               dtype=jnp.float32)
    return jax.tree.map(np.asarray, params)


def _jax_tasks(trees):
    """Every JAX computation the tests read: (name, key, fn, args,
    kwargs). One-device results are computed once per configuration and
    shared by the meshes that have it."""
    tasks, seen = [], set()
    for name, (sizes, kw) in MESHES.items():
        jcfg, tcfg = _cfgs(name)
        noqk = _cfgs(name, "noqk")[0]
        inp = _inputs(tcfg.vocab_size)
        tasks.append((name, "grads", _jax_grads,
                      (jcfg, sizes, trees[name, "qk"], *inp["loss"]), {}))
        one = [("one_grads", _jax_grads, (jcfg, (1, 1, 1, 1)), inp["loss"]),
               ("one-traj-qk", _jax_trajectory, (jcfg, (1, 1, 1, 1)),
                [inp["traj"]])]
        if name == "dup":
            # the reference is wrong on this mesh (its kv fault): the
            # trajectory without qk-norm is held to one device too
            one.append(("one-traj-noqk", _jax_trajectory,
                        (noqk, (1, 1, 1, 1)), [inp["traj"]]))
        else:
            tasks.append((name, "traj-noqk", _jax_trajectory,
                          (noqk, sizes, trees[name, "noqk"], inp["traj"]),
                          {}))
        for key, fn, head, tail in one:
            if (key, tuple(kw.items())) not in seen:
                seen.add((key, tuple(kw.items())))
                variant = "noqk" if key.endswith("noqk") else "qk"
                tasks.append(((key, tuple(kw.items())), key, fn,
                              (*head, _one_device_tree(trees[name, variant]),
                               *tail), {}))
        if name in BF16_MESHES:
            for od, steps in ((2, 3), (1, 1)):
                tasks.append((name, f"bf16-od{od}", _jax_trajectory,
                              (noqk, sizes, trees[name, "noqk"],
                               inp["traj"]),
                              dict(dtype=jnp.bfloat16, overdecompose=od,
                                   steps=steps)))
    return tasks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX weights per mesh and variant saved, the 8-rank worker launched;
    while it runs, the JAX package computes every case (a few at a time on
    threads: most of their time is XLA's compiler, which releases the
    GIL). Returns (ranks' results, JAX's results by mesh)."""
    outdir = tmp_path_factory.mktemp("mesh_train_ranks")
    trees = {}
    for name, (sizes, _) in MESHES.items():
        for v in VARIANTS:
            trees[name, v] = _init_tree(_cfgs(name, v)[0], sizes)
            _save_tree(trees[name, v], outdir / f"{name}-{v}.npz")
    proc = _torchrun([__file__, str(outdir)])
    try:
        tasks = _jax_tasks(trees)
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            done = [pool.submit(fn, *args, **kw)
                    for _, _, fn, args, kw in tasks]
            results = {(owner, key): f.result()
                       for (owner, key, *_), f in zip(tasks, done)}
    finally:
        _wait(proc)
    jax_out = {}
    for name, (_, kw) in MESHES.items():
        j = jax_out[name] = {k: v for (o, k), v in results.items()
                             if o == name}
        j["loss"], j["grads"] = j["grads"]
        for (o, k), v in results.items():
            if o == (k, tuple(kw.items())):
                j[k] = v
        j["one_loss"], j["one_grads"] = j["one_grads"]
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out


def _block(a, axes, rank, spec):
    """Rank ``rank``'s block of the global numpy array ``a``."""
    return M.shard(torch.from_numpy(np.array(a)), axes, spec, rank).numpy()


def _layer(a, name):
    """A stacked JAX leaf's entry for the port parameter ``name``."""
    return a[int(name.split(".")[1])] if name.startswith("layers.") else a


def _qk_norm(name):
    return name.rsplit(".", 1)[-1] in ("q_norm", "k_norm")


# in the duplicated-KV layout the reference's fault (its kv projection's
# input gradient is not summed over y) reaches every gradient upstream of
# the last layer's kv projection: these leaves alone are right there
DUP_RIGHT = ("layers.1.mixer.wq", "layers.1.mixer.wkv_dup",
             "layers.1.mixer.wo", "layers.1.ffn.wi", "layers.1.ffn.wg",
             "layers.1.ffn.wo", "layers.1.norm2.g", "final_norm.g")


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(MESHES))
def test_loss_and_gradient_blocks_match_jax_on_the_same_mesh(world, name):
    """One microbatch: every rank's loss, and each of its gradient blocks
    after the step's reductions against the block JAX's device of its
    coordinates holds (the qk-norm gains excepted at g_y > 1, where the
    reference keeps only its y rank's heads; on ``dup`` only the leaves
    the reference's kv fault does not reach)."""
    ranks, jax_out = world
    j = jax_out[name]
    _, tcfg = _cfgs(name)
    axes = MeshAxes(MESHES[name][0])
    checked = 0
    for r, res in enumerate(ranks):
        got = res[name]
        assert abs(got["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"])
        for n, g in got["grads"].items():
            if (_qk_norm(n) and axes.gy > 1) or (name == "dup"
                                                 and n not in DUP_RIGHT):
                continue
            jg = _layer(_leaf(j["grads"], convert.jax_path(n, tcfg))[r], n)
            assert g.shape == jg.shape, (n, r)
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_REL * np.abs(jg).max(), (name, n, r, err)
            checked += 1
    assert checked >= WORLD * (len(DUP_RIGHT) if name == "dup" else 10)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_every_gradient_block_is_the_one_device_gradient(world, name):
    """Every leaf, qk-norm gains included: each rank's block after the
    step's reductions against the block, by ``param_spec``, of JAX's
    gradient on the one-device mesh (on ``dup``, of [wk | wv] for
    ``wkv_dup``): the mesh trains what one device trains."""
    ranks, jax_out = world
    j = jax_out[name]
    _, tcfg = _cfgs(name)
    axes = MeshAxes(MESHES[name][0])
    assert abs(j["loss"] - j["one_loss"]) <= LOSS_RTOL * abs(j["one_loss"])
    n_leaves = len(dict(ST.init_model(tcfg, axes, device="cpu"
                                      ).named_parameters()))
    for r, res in enumerate(ranks):
        assert len(res[name]["grads"]) == n_leaves
        for n, g in res[name]["grads"].items():
            whole = _layer(_one_device_leaf(j["one_grads"],
                                            convert.jax_path(n, tcfg)), n)
            jg = _block(whole, axes, r, param_spec(n))
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_REL * np.abs(jg).max(), (name, n, r, err)


@pytest.mark.parametrize("name,variant", [
    *((n, "qk") for n in sorted(MESHES)), ("dup", "noqk")])
def test_three_step_trajectory_matches_one_device(world, name, variant):
    """conftest.train_smoke's settings (B 8, S 32, overdecompose 2, lr
    1e-3, warmup 1, f32): every rank's loss and grad_norm at each step
    against JAX's make_train_step on (1,1,1,1), with qk-norm (where the
    reference departs on a mesh) and, on ``dup`` (where its kv fault
    does), without."""
    ranks, jax_out = world
    want = jax_out[name][f"one-traj-{variant}"]
    for r, res in enumerate(ranks):
        for i, ((jloss, jgn), m) in enumerate(zip(
                want, res[name][f"traj-{variant}"])):
            assert abs(m["loss"] - jloss) <= TRAJ_RTOL * abs(jloss), (r, i)
            assert abs(m["grad_norm"] - jgn) <= TRAJ_RTOL * jgn, (r, i)
    assert want[2][0] < want[0][0]


@pytest.mark.parametrize("name", sorted(set(MESHES) - {"dup"}))
def test_three_step_trajectory_matches_jax_on_the_same_mesh(world, name):
    """With qk_norm=False, where the reference is right on a mesh: loss
    and grad_norm at each step against JAX's make_train_step on the same
    mesh shape."""
    ranks, jax_out = world
    want = jax_out[name]["traj-noqk"]
    for r, res in enumerate(ranks):
        for i, ((jloss, jgn), m) in enumerate(zip(want,
                                                  res[name]["traj-noqk"])):
            assert abs(m["loss"] - jloss) <= TRAJ_RTOL * abs(jloss), (r, i)
            assert abs(m["grad_norm"] - jgn) <= TRAJ_RTOL * jgn, (r, i)


@pytest.mark.parametrize("od", [2, 1])
@pytest.mark.parametrize("name", BF16_MESHES)
def test_bf16_trajectory_matches_jax_on_the_same_mesh(world, name, od):
    """bfloat16, qk_norm=False: three steps at overdecompose 2 and one at
    overdecompose 1 (gradients reduced in bf16, as the reference's),
    loss and grad_norm against JAX bf16 on the same mesh within the
    bfloat16 tolerance."""
    ranks, jax_out = world
    want = jax_out[name][f"bf16-od{od}"]
    assert len(want) == (3 if od == 2 else 1)
    for r, res in enumerate(ranks):
        for i, ((jloss, jgn), m) in enumerate(zip(want,
                                                  res[name][f"bf16-od{od}"])):
            assert abs(m["loss"] - jloss) <= BF16_RTOL * abs(jloss), (r, i)
            assert abs(m["grad_norm"] - jgn) <= BF16_RTOL * jgn, (r, i)


@pytest.mark.parametrize("what", ["dw", "dtable"])
@pytest.mark.parametrize("name", BF16_MESHES)
def test_bf16_weight_gradients_round_once_after_the_z_sum(world, name, what):
    """bf16 ``tp_matmul``'s dW and the tied head's dtable: each rank's
    block is the exact sum over its data shard's rows rounded once to bf16
    (within half a bf16 ulp beyond the fp32 sum's error bound, 2^-24 rows
    sum|a b|), because K1 writes the partials in fp32 and the z
    reduce-scatter sums them before the cast; summing bf16-rounded
    partials over g_z = 2 would miss by up to 1.5 ulp."""
    ranks, _ = world
    for res in ranks:
        got, exact, mag, rows = res[name]["rs_bf16"][what]
        assert got.dtype == torch.bfloat16
        near = torch.maximum(exact.abs(), got.double().abs())
        ulp = torch.exp2(torch.floor(torch.log2(near)) - 7)
        miss = ((got.double() - exact).abs() - 2.0 ** -24 * rows * mag) / ulp
        assert float(miss.max()) <= 0.5, (what, float(miss.max()))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ranks_holding_the_same_block_end_bitwise_equal(world, name):
    """After 3 steps, the ranks that differ only in their data and seq
    coordinates (the replicas of every block) have bitwise-equal
    parameters, and ranks that differ in x, y or z hold other blocks."""
    ranks, _ = world
    axes = MeshAxes(MESHES[name][0])
    for v in VARIANTS:
        groups = {}
        for r in range(WORLD):
            c = axes.coords(r)
            groups.setdefault(c[1:4], set()).add(ranks[r][name][f"sha-{v}"])
        assert all(len(s) == 1 for s in groups.values()), (v, groups)
        assert len(groups) == WORLD // (axes.dp * axes.gseq)
        assert len(set.union(*groups.values())) == len(groups)




def test_reference_qk_norm_gradient_holds_one_y_rank_of_heads():
    """The reference's fault that the port departs from (ROADMAP.md §3):
    on (1,1,2,1) each y rank's q_norm gradient holds only its own heads,
    more than 10% of max|g| away from the one-device gradient, while the
    sum over the y ranks is it within GRAD_REL."""
    jcfg, tcfg = _cfgs("mesh4")
    sizes = (1, 1, 2, 1)
    tokens, labels = _inputs(tcfg.vocab_size)["loss"]
    path = "segments/seg0/pos0/mixer/q_norm"
    tree = _init_tree(jcfg, sizes)
    per_rank = _leaf(_jax_grads(jcfg, sizes, tree, tokens, labels)[1],
                     path)[:, 0]
    whole = _one_device_leaf(_jax_grads(jcfg, (1, 1, 1, 1), tree, tokens,
                                        labels)[1], path)[0]
    scale = np.abs(whole).max()
    assert per_rank.shape == (2, *whole.shape)
    for g in per_rank:
        assert np.abs(g - whole).max() > 0.1 * scale
    assert np.abs(per_rank.sum(0) - whole).max() <= GRAD_REL * scale
    assert LEAF_SPECS["q_norm"].y_heads and LEAF_SPECS["k_norm"].y_heads


def test_reference_duplicated_kv_input_gradient_is_not_summed_over_y(
        world):
    """The reference's second fault that the port does not copy
    (ROADMAP.md §3): in the duplicated-KV layout its kv projection
    (``tp_matmul(h, wkv_dup, axes, "x", None)``) leaves each y rank's
    input gradient partial, so on ``dup`` the first layer's norm1 gain,
    replicated over y, gets another gradient on each y rank, and none is
    the one-device gradient; the port's blocks match it."""
    ranks, jax_out = world
    j = jax_out["dup"]
    n, path = "layers.0.norm1.g", "segments/seg0/pos0/norm1/g"
    jg = _leaf(j["grads"], path)[:, 0]
    whole = _one_device_leaf(j["one_grads"], path)[0]
    assert jg.shape == (WORLD, *whole.shape)
    scale = np.abs(whole).max()
    axes = MeshAxes(MESHES["dup"][0])
    by_y = {axes.coords(r)[2]: jg[r] for r in range(WORLD)}
    assert len(by_y) == 4
    for g in by_y.values():
        assert np.abs(g - whole).max() > 0.05 * scale
    for res in ranks:
        assert np.abs(res["dup"]["grads"][n].numpy() - whole).max() \
            <= GRAD_REL * scale


def test_flags_match_the_reference_param_specs():
    """``partition.LEAF_SPECS``' z_reduced and y_reduce flags, leaf by
    leaf, against the JAX ParamSpecs of the dense and duplicated-KV
    decoders; ``y_heads`` (the port's departure) is on the qk-norm gains
    alone, which the reference leaves without a y reduction."""
    seen = set()
    for name in ("mesh4", "dup"):
        jcfg, _ = _cfgs(name)
        _, axes = _jax_mesh(MESHES[name][0])
        _, specs = JST.init_model(jcfg, axes, abstract=True,
                                  dtype=jnp.float32)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: hasattr(s, "z_reduced"))
        for path, s in flat:
            leaf = str(path[-1].key)
            ours = LEAF_SPECS[leaf]
            assert (ours.z_reduced, ours.y_reduce) == (s.z_reduced,
                                                       s.y_reduce), leaf
            assert ours.y_heads == (leaf in ("q_norm", "k_norm")), leaf
            seen.add(leaf)
    assert {"embed", "wkv_dup", "q_norm", "g", "wo"} <= seen
    assert [k for k, s in LEAF_SPECS.items() if s.y_heads] == ["q_norm",
                                                               "k_norm"]


def test_train_cli_on_four_ranks():
    """``launch/train.py --mesh 1,2,2,1 --backend gloo --device cpu`` on 4
    ranks: rank 0 alone prints; its last line is the ``{"train": ...}``
    report: finite, falling losses within 1e-3 of the one-rank run of the
    same seed and data, the global parameter count, and every rank's
    collectives by axis (x and y) with their calls and bytes, no kernel
    launched (the CPU runs the plain versions)."""
    proc = _torchrun(["-m", "repro_torch.launch.train", *CLI_FLAGS,
                      "--mesh", "1,2,2,1", "--backend", "gloo"], nproc=4)
    one = train.main(CLI_FLAGS)
    lines = _wait(proc).strip().splitlines()
    assert lines.count("backend=gloo ranks_per_card=- ranks=4") == 1
    assert sum(ln.startswith("step ") for ln in lines) == 3
    rep = json.loads(lines[-1])["train"]
    assert rep["mesh"] == "1,2,2,1" and len(rep["ranks"]) == 4
    assert np.isfinite(rep["losses"]).all()
    assert rep["losses"][-1] < rep["losses"][0]
    assert max(abs(a - b) for a, b in zip(rep["losses"], one.losses)) <= 1e-3
    assert rep["n_params"] == one.n_params
    assert len({r["param_sha256"] for r in rep["ranks"]}) == 4
    for r in rep["ranks"]:
        assert len(r["comm_by_axis"]) == 3
        for step in r["comm_by_axis"]:
            assert set(step) >= {"x", "y"}
            assert all(step[a]["calls"] > 0 and step[a]["bytes"] > 0
                       for a in ("x", "y"))
        assert r["launches"]["block_matmul"] == 0


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
