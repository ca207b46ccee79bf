"""The port's multi-rank mesh (data, x, y, z above 1) held against the JAX
package on the CPU.

One ``torch.distributed.run --nproc-per-node 4`` launch of this file's
``__main__`` runs four gloo ranks; within that world each rank runs three
meshes in turn: (1,2,2,1) with the reduced ``qwen3-1.7b``, (2,1,1,2)
(slots and pages sharded four ways) and (1,1,4,1) with ``n_kv_heads=2``,
the duplicated-KV layout. Each rank's outputs are held against the JAX
package run on the same mesh shape in this process (8 forced host
devices), on weights carried across by ``convert.params_from_jax(...,
axes, rank)``: every collective primitive over single axes and tuples,
``parallel.rms_norm`` forward and backward, the paged step, prefill and
decode logits (``LOGIT_TOL``, as ``tests/test_torch_serving.py``), and the
engine's served ids against the port's one-rank engine. A second launch
runs the serve CLI on (1,2,2,1). On the CPU the port's wrappers run their
kernels' plain versions. Inputs are made with numpy from seeds.
"""
import dataclasses
import json
import math
import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core import mesh as JM
from repro.core import parallel as JPP
from repro.core.compat import shard_map
from repro.core.partition import spec_tree_to_pspecs
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core.gradsync import GradSyncConfig
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.partition import param_spec
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.launch.serving import PagedEngine, Request, ServeConfig

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
WORLD = 4
# name -> (mesh sizes, config changes on both sides)
MESHES = {"tp": ((1, 2, 2, 1), {}),
          "dz": ((2, 1, 1, 2), {}),
          "dup": ((1, 1, 4, 1), {"n_kv_heads": 2})}
# every collective runs over these axes and tuples (size-1 ones are the
# identity on both sides)
COLL_AXES = ["data", "x", "y", "z", ("data", "z"), ("x", "y"),
             ("x", "y", "z"), ("data", "x", "y", "z")]
NAMES = ("data", "x", "y", "z")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_serving.py's
NORM_TOL = dict(rtol=1e-5, atol=1e-5)    # rms_norm: fp32, psum order
# the paged schedule: 4 slots (one a shard on (2,1,1,2)), chunk 8, page 4,
# 12 pages a shard; every slot's local page ids are distinct, so the table
# is valid whether the slots share a shard or not; slot 2 stays idle
PAGED = dict(R=4, chunk=8, page=4, pages_per_shard=12)
TABLE = np.array([[3, 1, 6, 0], [2, 5, 4, 0], [0, 0, 0, 0], [9, 11, 10, 0]],
                 np.int32)
Q_LEN = np.array([8, 5, 0, 8], np.int32)
DECODES = 3
FIXED = dict(B=4, T=8, S=12)     # prefill 4 x 8 into 12 positions, 3 decodes
ENGINE = dict(slots=4, page_size=4, pages_per_shard=10, chunk=8)
CLI_FLAGS = ["--arch", ARCH, "--device", "cpu", "--requests", "4",
             "--prompt-len", "6", "--gen", "3", "--slots", "2",
             "--page-size", "4", "--pages", "12", "--chunk", "4"]


def _cfgs(name):
    kw = MESHES[name][1]
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _key(axis):
    return "+".join((axis,) if isinstance(axis, str) else axis)


# ---------------------------------------------------------------------- #
# inputs, from numpy seeds
# ---------------------------------------------------------------------- #

def _inputs(cfg):
    rng = np.random.RandomState(0)
    R, chunk = PAGED["R"], PAGED["chunk"]
    tokens = rng.randint(1, cfg.vocab_size, (R, chunk)).astype(np.int32)
    tokens[Q_LEN[:, None] <= np.arange(chunk)[None]] = 0
    decode = rng.randint(1, cfg.vocab_size, (DECODES, R, 1)).astype(np.int32)
    B, T = FIXED["B"], FIXED["T"]
    return dict(
        coll=rng.randn(8, 12).astype(np.float32),
        norm=[rng.randn(2, 3, cfg.d_model).astype(np.float32),
              (1 + 0.1 * rng.randn(cfg.d_model)).astype(np.float32),
              rng.randn(2, 3, cfg.d_model).astype(np.float32)],
        paged_tokens=tokens, paged_decode=decode,
        prompts=rng.randint(1, cfg.vocab_size, (B, T)).astype(np.int32),
        fixed_decode=rng.randint(1, cfg.vocab_size,
                                 (DECODES, B, 1)).astype(np.int32))


def _paged_plans(inp):
    """(tokens, positions, q_len, table) of the chunk, then each decode
    row at the slot's next position (idle slots stay idle)."""
    R, chunk = PAGED["R"], PAGED["chunk"]
    plans = [(inp["paged_tokens"], np.broadcast_to(
        np.arange(chunk, dtype=np.int32), (R, chunk)).copy(), Q_LEN, TABLE)]
    live = Q_LEN > 0
    for i in range(DECODES):
        pos = np.where(live, Q_LEN + i, 0)[:, None].astype(np.int32)
        plans.append((np.where(live[:, None], inp["paged_decode"][i], 0
                               ).astype(np.int32), pos,
                      live.astype(np.int32), TABLE))
    return plans


def _engine_requests(vocab, rate):
    """Six requests of mixed lengths, all at t=0 or staggered by 2 ms."""
    rng = np.random.RandomState(5)
    specs = [(rng.randint(1, vocab, size=(int(rng.randint(3, 12)),)
                          ).astype(np.int32), int(rng.randint(2, 7)))
             for _ in range(6)]
    return [Request(rid=i, prompt=p, max_new=n,
                    arrival=0.002 * i if rate else 0.0)
            for i, (p, n) in enumerate(specs)]


def _virtual_clock(step=1e-3):
    """Deterministic time source: each call advances ``step`` seconds."""
    state = {"t": 0.0}

    def tick():
        state["t"] += step
        return state["t"]
    return tick


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

def _worker_mesh(name, axes, outdir):
    """Every case of one mesh on this rank."""
    _, tcfg = _cfgs(name)
    inp = _inputs(tcfg)
    rank = M.process_rank()
    out = {}
    # collectives: rank r holds x * (1 + r)
    x = torch.from_numpy(inp["coll"])
    mine = x * (1 + rank)
    for axis in COLL_AXES:
        n, i = axes.size(axis), M.axis_index(axes, axis)
        out[f"coll/{_key(axis)}"] = dict(
            index=i, psum=M.psum(mine, axes, axis),
            pmax=M.pmax(mine, axes, axis),
            all_gather=M.all_gather(x.chunk(n, 1)[i], axes, axis, dim=1),
            psum_scatter=M.psum_scatter(mine, axes, axis, dim=0))
    # rms_norm over the x-sharded residual layout, forward and backward
    xs, g, dy = (M.shard(torch.from_numpy(t), axes, s) for t, s in zip(
        inp["norm"], ((None, None, "x"), ("x",), (None, None, "x"))))
    xs, g = xs.clone().requires_grad_(), g.clone().requires_grad_()
    y = PP.rms_norm(xs, g, axes, tcfg.d_model)
    y.backward(dy)
    out["norm"] = [t.detach() for t in (y, xs.grad, g.grad)]
    # the shards of the model drawn here are slices of the one-card model
    if name != "dup":
        own = ST.init_model(tcfg, axes, seed=0, device="cpu")
        one = dict(ST.init_model(tcfg, seed=0, device="cpu"
                                 ).named_parameters())
        out["shards_equal"] = {
            n: torch.equal(p, M.shard(one[n], axes, param_spec(n)))
            for n, p in own.named_parameters()}
    model = convert.params_from_jax(_load_tree(outdir / f"{name}.npz"), tcfg,
                                    "cpu", axes, rank)
    # the paged step over the chunk and the decode rows
    fn, ct = ST.make_paged_step(tcfg, axes)(
        axes.batch_shards * PAGED["pages_per_shard"], PAGED["page"])
    pools = ST.zeros_caches(ct, "cpu")
    out["paged"] = []
    for plan in _paged_plans(inp):
        tokens, *rest = map(torch.from_numpy, plan)
        logits, pools = fn(model, tokens, pools, *rest)
        out["paged"].append(logits)
    # prefill, then decode steps
    B, T, S = FIXED["B"], FIXED["T"], FIXED["S"]
    pre, ct = ST.make_prefill_step(tcfg, axes)(B, T, S)
    dec, _ = ST.make_decode_step(tcfg, axes)(B, S)
    caches = ST.zeros_caches(ct, "cpu")
    logits, caches = pre(model, caches, torch.from_numpy(inp["prompts"]))
    out["fixed"] = [logits]
    for i in range(DECODES):
        logits, caches = dec(model, caches,
                             torch.from_numpy(inp["fixed_decode"][i]), T + i)
        out["fixed"].append(logits)
    # the engine at rate 0 and above 0. Each rank's clock runs at its own
    # rate (rank 0's as the one-rank engine's), so only rank 0's reading,
    # shared with every rank, makes the ranks admit alike
    for rate in (0, 1):
        eng = PagedEngine(tcfg, axes, model, ServeConfig(**ENGINE))
        reqs = _engine_requests(tcfg.vocab_size, rate)
        eng.run(reqs, time_fn=_virtual_clock(1e-3 * (1 + 3 * rank)))
        out[f"engine{rate}"] = dict(ids=[r.generated for r in reqs],
                                    plan=eng.plan_hash.hexdigest())
    if name == "tp":
        args = serve.build_parser().parse_args(
            ["--arch", ARCH, "--mode", "fixed", "--device", "cpu",
             "--batch", "2", "--prompt-len", "5", "--gen", "3"])
        res = serve.run_fixed(args, ST.init_model(tcfg, axes, seed=0,
                                                  device="cpu"))
        out["run_fixed"] = dict(ids=res.ids, plan=res.plan_sha256,
                                comm=res.comm)
    return out


def _rank_worker(outdir: pathlib.Path):
    """One rank: every mesh of MESHES in turn in one world of 4, saved to
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
# the JAX side, on the same mesh shapes
# ---------------------------------------------------------------------- #

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _torchrun(args):
    """``args`` under ``torch.distributed.run`` on WORLD ranks, started in
    a session of its own (so that a timeout stops the launcher and every
    rank together)."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), *args], env=_env(), cwd=ROOT,
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


def _jax_mesh(name):
    mesh = LM.make_smoke_mesh(MESHES[name][0])
    return mesh, LM.bind_4d(mesh)


def _jax_collectives(mesh, x):
    def f(x):
        r = JM.axis_index(NAMES)
        mine = x * (1 + r).astype(x.dtype)
        out = {}
        for axis in COLL_AXES:
            n = math.prod(mesh.shape[a] for a in JM._names(axis))
            i = JM.axis_index(axis)
            w = x.shape[1] // n
            blk = jax.lax.dynamic_slice_in_dim(x, i * w, w, axis=1)
            out[_key(axis)] = dict(
                index=i, psum=JM.psum(mine, axis), pmax=JM.pmax(mine, axis),
                all_gather=JM.all_gather(blk, axis, dim=1),
                psum_scatter=JM.psum_scatter(mine, axis, dim=0))
        return jax.tree.map(lambda v: v[None], out)
    g = shard_map(f, mesh=mesh, in_specs=P(), out_specs=P(NAMES),
                  check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(g)(jnp.asarray(x)))


def _jax_norm(mesh, axes, d, x, g, dy):
    def f(x, g, dy):
        y, pull = jax.vjp(lambda x, g: JPP.rms_norm(x, g, axes, d), x, g)
        return (y, *pull(dy))
    spec = P(None, None, "x")
    sm = shard_map(f, mesh=mesh, in_specs=(spec, P("x"), spec),
                   out_specs=(spec, spec, P("x")), check_vma=False)
    return [np.asarray(t) for t in jax.jit(sm)(*map(jnp.asarray,
                                                    (x, g, dy)))]


def _jax_paged(jcfg, mesh, axes, params, inp):
    build, _ = JST.make_paged_step(jcfg, mesh, axes, dtype=jnp.float32)
    fn, ct = build(axes.batch_shards * PAGED["pages_per_shard"],
                   PAGED["page"])
    pools = JST.zeros_caches(mesh, ct)
    out = []
    for plan in _paged_plans(inp):
        logits, pools = fn(params, pools, *map(jnp.asarray, plan))
        out.append(np.asarray(logits))
    return out


def _jax_fixed(jcfg, mesh, axes, params, inp):
    B, T, S = FIXED["B"], FIXED["T"], FIXED["S"]
    pbuild, _ = JST.make_prefill_step(jcfg, mesh, axes, dtype=jnp.float32)
    pre, _, ct = pbuild(B, T, S)
    dbuild, _ = JST.make_decode_step(jcfg, mesh, axes, dtype=jnp.float32)
    dec, _ = dbuild(B, S)
    caches = JST.zeros_caches(mesh, ct)
    logits, caches = pre(params, caches,
                         {"tokens": jnp.asarray(inp["prompts"])})
    out = [np.asarray(logits)]
    for i in range(DECODES):
        logits, caches = dec(params, caches,
                             jnp.asarray(inp["fixed_decode"][i]),
                             jnp.int32(T + i))
        out.append(np.asarray(logits))
    return out


def _one_rank_tree(tree):
    """The one-rank leaves of the same function: the duplicated-KV
    layout's ``wkv_dup`` (d, 2 nkv hd) split into ``wk`` and ``wv`` (a y
    rank's kept head j is the head its query heads read under GQA)."""
    out = {k: _one_rank_tree(v) if isinstance(v, dict) else v
           for k, v in tree.items()}
    if "wkv_dup" in out:
        wk, wv = np.split(out.pop("wkv_dup"), 2, axis=-1)
        out["wk"], out["wv"] = wk, wv
    return out


def _one_rank_engine(tree, tcfg, rate):
    model = convert.params_from_jax(_one_rank_tree(tree), tcfg, "cpu")
    eng = PagedEngine(tcfg, MeshAxes(), model, ServeConfig(**ENGINE))
    reqs = _engine_requests(tcfg.vocab_size, rate)
    eng.run(reqs, time_fn=_virtual_clock())
    return [r.generated for r in reqs]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX weights per mesh saved, the 4-rank worker launched; while it
    runs, the JAX package computes every case on the same mesh shapes and
    the port's one-rank engine serves the same requests. Returns (ranks'
    results, JAX's results)."""
    outdir = tmp_path_factory.mktemp("mesh_ranks")
    jax_out = {}
    for name in MESHES:
        jcfg, _ = _cfgs(name)
        mesh, axes = _jax_mesh(name)
        params, _ = JST.init_model(jcfg, axes, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
        tree = jax.tree.map(np.asarray, params)
        _save_tree(tree, outdir / f"{name}.npz")
        jax_out[name] = dict(mesh=mesh, axes=axes, params=params, tree=tree)
    proc = _torchrun([__file__, str(outdir)])
    try:
        for name, j in jax_out.items():
            jcfg, tcfg = _cfgs(name)
            inp = _inputs(tcfg)
            mesh, axes = j["mesh"], j["axes"]
            j["coll"] = _jax_collectives(mesh, inp["coll"])
            j["norm"] = _jax_norm(mesh, axes, tcfg.d_model, *inp["norm"])
            j["paged"] = _jax_paged(jcfg, mesh, axes, j["params"], inp)
            j["fixed"] = _jax_fixed(jcfg, mesh, axes, j["params"], inp)
            j["engine"] = [_one_rank_engine(j["tree"], tcfg, rate)
                           for rate in (0, 1)]
    finally:
        _wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out


def _block(a, axes, rank, spec):
    """Rank ``rank``'s block of the global numpy array ``a``."""
    return M.shard(torch.from_numpy(np.array(a)), axes, spec,
                   rank).numpy()


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(MESHES))
def test_collectives_match_jax(world, name):
    """psum, pmax, all_gather, psum_scatter and axis_index over every
    single axis and tuple, each rank against JAX's device of its
    coordinates: first-name-major throughout, sums bitwise equal on every
    rank."""
    ranks, jax_out = world
    j = jax_out[name]["coll"]
    for axis in COLL_AXES:
        k = _key(axis)
        for r, res in enumerate(ranks):
            got = res[name][f"coll/{k}"]
            assert got["index"] == int(j[k]["index"][r]), (k, r)
            for op in ("psum", "pmax", "all_gather", "psum_scatter"):
                np.testing.assert_allclose(got[op].numpy(), j[k][op][r],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{k} {op} rank {r}")
        # the members of one group (every coordinate outside ``axis``
        # shared) hold the same bits
        axes = MeshAxes(MESHES[name][0])
        outside = [i for i, a in enumerate(NAMES) if a not in JM._names(axis)]
        groups = {}
        for r in range(WORLD):
            c = axes.coords(r)
            groups.setdefault(tuple(c[i] for i in outside), []).append(r)
        for members in groups.values():
            for op in ("psum", "pmax", "all_gather"):
                first = ranks[members[0]][name][f"coll/{k}"][op]
                assert all(torch.equal(ranks[r][name][f"coll/{k}"][op],
                                       first) for r in members), (k, op)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rms_norm_matches_jax(world, name):
    """``parallel.rms_norm`` on the x-sharded residual layout, forward and
    backward, against the reference's ``parallel.rms_norm``. At g_x = 2
    the forward's sum of squares is psum'd over x between K3's stats and
    apply passes; normalizing each half-row by itself differs by O(1)."""
    ranks, jax_out = world
    axes = MeshAxes(MESHES[name][0])
    y, dx, dg = jax_out[name]["norm"]
    for r, res in enumerate(ranks):
        got = res[name]["norm"]
        for g, w, spec in zip(got, (y, dx, dg), ((None, None, "x"),
                                                 (None, None, "x"), ("x",))):
            np.testing.assert_allclose(g.numpy(), _block(w, axes, r, spec),
                                       **NORM_TOL)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_param_specs_match_jax(name):
    """``partition.param_spec`` of every port parameter equals the
    PartitionSpec of its JAX leaf (a stacked leaf's leading layer dim
    dropped), and each parameter's local shape is its JAX leaf's shape
    sharded by that spec."""
    jcfg, tcfg = _cfgs(name)
    _, jaxes = _jax_mesh(name)
    axes = MeshAxes(MESHES[name][0])
    structs, specs = JST.init_model(jcfg, jaxes, abstract=True,
                                    dtype=jnp.float32)
    pspecs = spec_tree_to_pspecs(specs)
    model = ST.init_model(tcfg, axes, device="cpu")
    paths = convert.jax_paths(model)
    leaves = set()
    for n, p in model.named_parameters():
        spec, struct = pspecs, structs
        for k in paths[n].split("/"):
            spec, struct = spec[k], struct[k]
        spec, shape = tuple(spec), struct.shape
        if n.startswith("layers."):
            assert spec[0] is None
            spec, shape = spec[1:], shape[1:]
        spec += (None,) * (len(shape) - len(spec))
        want = tuple(s if s is None or isinstance(s, str) or len(s) > 1
                     else s[0] for s in spec)
        assert param_spec(n) == want, (n, param_spec(n), want)
        local = tuple(s // axes.size(a) for s, a in zip(shape, want))
        assert tuple(p.shape) == local, (n, tuple(p.shape), local)
        leaves.add(paths[n])
    assert len(leaves) == len(jax.tree.leaves(structs))


def test_shards_are_slices_of_the_one_card_model(world):
    """Each rank's parameters, drawn from seed 0 on the mesh, are bitwise
    the blocks of the one-card model of the same seed (the duplicated-KV
    mesh draws another set of leaves, so it has no one-card model)."""
    ranks, _ = world
    for name in ("tp", "dz"):
        for r, res in enumerate(ranks):
            bad = [n for n, ok in res[name]["shards_equal"].items() if not ok]
            assert not bad, (name, r, bad)
            assert len(res[name]["shards_equal"]) > 10


@pytest.mark.parametrize("name", sorted(MESHES))
def test_paged_step_matches_jax(world, name):
    """A prefill chunk (full, partial and idle slots) and 3 decode rows:
    each rank's logits (its batch shard's rows, its y shard of the vocab)
    against JAX's paged step on the same mesh."""
    ranks, jax_out = world
    axes = MeshAxes(MESHES[name][0])
    spec = (("data", "z"), None, "y")
    for r, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(res[name]["paged"],
                                               jax_out[name]["paged"])):
            live = _block(Q_LEN, axes, r, (("data", "z"),)) > 0
            np.testing.assert_allclose(
                got.numpy()[live], _block(want, axes, r, spec)[live],
                **LOGIT_TOL, err_msg=f"{name} rank {r} step {step}")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_prefill_and_decode_match_jax(world, name):
    """Prefill of 4 x 8 and 3 decode steps of the fixed-batch path: each
    rank's logits against JAX's prefill and decode steps on the mesh."""
    ranks, jax_out = world
    axes = MeshAxes(MESHES[name][0])
    spec = (("data", "z"), None, "y")
    for r, res in enumerate(ranks):
        for step, (got, want) in enumerate(zip(res[name]["fixed"],
                                               jax_out[name]["fixed"])):
            np.testing.assert_allclose(
                got.numpy(), _block(want, axes, r, spec), **LOGIT_TOL,
                err_msg=f"{name} rank {r} step {step}")


@pytest.mark.parametrize("rate", [0, 1])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_engine_serves_the_one_rank_ids(world, name, rate):
    """Six requests (all at t=0, or staggered with a pool small enough to
    preempt on one shard): every rank serves the ids of the port's
    one-rank engine, and every rank ran the same plans, though each rank's
    own clock runs at another rate (rank r's advances 1 + 3r ms a call):
    the ranks admit by rank 0's clock."""
    ranks, jax_out = world
    want = jax_out[name]["engine"][rate]
    for r, res in enumerate(ranks):
        assert res[name][f"engine{rate}"]["ids"] == want, r
    assert len({res[name][f"engine{rate}"]["plan"] for res in ranks}) == 1


def test_run_fixed_on_the_mesh_serves_the_one_rank_ids(world):
    """``serve.run_fixed`` on (1,2,2,1): the ids of the one-rank run of
    the same seed, the same token batches on every rank, collectives
    counted."""
    ranks, _ = world
    args = serve.build_parser().parse_args(
        ["--arch", ARCH, "--mode", "fixed", "--device", "cpu", "--batch",
         "2", "--prompt-len", "5", "--gen", "3"])
    one = serve.run_fixed(args)
    for res in ranks:
        got = res["tp"]["run_fixed"]
        assert np.array_equal(got["ids"], one.ids)
        assert got["comm"]["all_reduce"]["calls"] > 0
    assert len({res["tp"]["run_fixed"]["plan"] for res in ranks}) == 1


def test_serve_cli_on_four_ranks():
    """``launch/serve.py --mesh 1,2,2,1 --backend gloo --device cpu`` on 4
    ranks: rank 0 alone prints; its last line before SERVE OK is the
    ``{"serve": ...}`` report: the one-rank run's ids, the same plans and
    its own parameter shards on every rank, collectives over x and y
    counted, no kernel launched (the CPU runs the plain versions)."""
    proc = _torchrun(["-m", "repro_torch.launch.serve", *CLI_FLAGS,
                      "--mesh", "1,2,2,1", "--backend", "gloo"])
    args = serve.build_parser().parse_args(CLI_FLAGS)
    _, stats, reqs = serve.run_continuous(args)
    lines = _wait(proc).strip().splitlines()
    assert lines[-1] == "SERVE OK"
    assert sum(ln.startswith("served ") for ln in lines) == 1
    rep = json.loads(lines[-2])["serve"]
    assert rep["ids"] == [r.generated for r in reqs]
    assert rep["mesh"] == "1,2,2,1" and len(rep["ranks"]) == WORLD
    assert len({r["plan_sha256"] for r in rep["ranks"]}) == 1
    assert len({r["param_sha256"] for r in rep["ranks"]}) == WORLD
    for r in rep["ranks"]:
        assert r["n_steps"] > 0 and r["launches"]["rmsnorm_stats"] == 0
        assert r["comm_axes"]["x"]["calls"] > 0
        assert r["comm_axes"]["y"]["calls"] > 0
        # rank 0's clock, shared once an iteration of the engine's loop
        assert r["comm"]["broadcast"]["calls"] >= r["n_steps"]
    assert rep["tokens_per_s"] > 0 and rep["latency_p99_ms"] > 0


def test_serve_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        serve.main([*CLI_FLAGS, "--mesh", "1,2,2,1"])


def _jax_axes(sizes):
    """The JAX package's MeshAxes of a mesh shape (no devices needed)."""
    return JM.MeshAxes(data=("data",), sizes=tuple(zip(NAMES, sizes)))


@pytest.mark.parametrize("sizes,kw,match", [
    ((1, 3, 1, 1), {}, "d_model 256 % gx 3"),
    ((1, 1, 3, 1), {}, "heads 4 % gy 3"),
    ((1, 1, 8, 1), {}, "heads 4 % gy 8"),
    ((1, 1, 2, 1), dict(n_heads=6, n_kv_heads=3, head_dim=64),
     "kv heads 3 vs gy 2")])
def test_meshes_the_reference_refuses_are_refused_in_its_words(sizes, kw,
                                                               match):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    assert jcfg.axes_ok(_jax_axes(sizes)) == match
    assert cfg.axes_ok(MeshAxes(sizes)) == match
    with pytest.raises(ValueError, match=match):
        ST.init_model(cfg, MeshAxes(sizes), device="cpu")


@pytest.mark.parametrize("sizes,d_model,match", [
    ((1, 1, 4, 1), 255, "weight n=510 not divisible by out*z=4"),
    ((1, 1, 4, 1), 253, "weight n=506 not divisible by out*z=4"),
    ((1, 2, 1, 1), 255, "d_model 255 % gx 2")])
def test_mamba_meshes_the_reference_refuses_are_refused_in_its_words(
        sizes, d_model, match):
    """Jamba's Mamba layers run on the tensor axes; a mesh whose y (times
    z) does not divide the inner width d_inner = 2 d_model, or whose x
    does not divide d_model, is refused with the reference's message (its
    ``axes_ok``, else its ``tp_linear_init``)."""
    kw = dict(d_model=d_model, head_dim=64)
    jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b").reduced(),
                               moe=None, **kw)
    cfg = dataclasses.replace(
        get_config("jamba-v0.1-52b-dense-ffn").reduced(), **kw)
    jaxes = _jax_axes(sizes)
    want = jcfg.axes_ok(jaxes)
    if want is None:
        with pytest.raises(ValueError) as err:
            JST.init_model(jcfg, jaxes, abstract=True, dtype=jnp.float32)
        want = str(err.value)
    assert want == match
    with pytest.raises(ValueError, match=re.escape(match)):
        ST.init_model(cfg, MeshAxes(sizes), device="cpu")


def test_training_on_the_tensor_axes_takes_the_overlapped_schedule():
    """``TrainOptions(overlap=OverlapConfig.all_on())`` on the tensor axes
    builds the step (it raised before; ``tests/test_torch_overlap.py``
    trains it on four meshes), and on a mesh of one rank a step under it
    gives the blocking step's loss, grad norm and parameter bits."""
    from repro_torch.core.overlap import OverlapConfig
    from repro_torch.optim.adamw import AdamWConfig, init_state
    cfg = get_config(ARCH).reduced()
    on = ST.TrainOptions(dtype=torch.float32,
                         overlap=OverlapConfig.all_on(ar_chunks=2))
    assert callable(ST.make_train_step(cfg, MeshAxes((1, 2, 1, 1)),
                                       AdamWConfig(), on))
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    runs = []
    for opts in (ST.TrainOptions(dtype=torch.float32), on):
        model = ST.init_model(cfg, device="cpu")
        step = ST.make_train_step(cfg, MeshAxes(), AdamWConfig(), opts)
        m = step(model, init_state(dict(model.named_parameters())),
                 {"tokens": toks, "labels": toks})
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     ST.param_sha256(model)))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("opts,item", [
    (dict(gradsync=GradSyncConfig(zero3=True)), r"init_model\(zero3=True\)")])
def test_training_on_the_tensor_axes_is_refused(opts, item):
    """Training on the tensor axes runs the blocking or the overlapped
    schedule (``tests/test_torch_mesh_train.py``,
    ``tests/test_torch_overlap.py``), the bucketed sync and ZeRO-1
    (``tests/test_torch_gradsync.py``) and ZeRO-3
    (``tests/test_torch_zero3.py``). A ZeRO-3 step refuses a model whose
    parameters are not sharded, naming how to make one, before any
    collective."""
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(ARCH).reduced()
    axes = MeshAxes((1, 2, 1, 1))
    assert callable(ST.make_train_step(cfg, axes, AdamWConfig(),
                                       ST.TrainOptions()))
    step = ST.make_train_step(cfg, axes, AdamWConfig(),
                              ST.TrainOptions(dtype=torch.float32, **opts))
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=item):
        step(ST.init_model(cfg, axes, device="cpu"), None,
             {"tokens": toks, "labels": toks})


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
