"""Jamba's hybrid decoder on the port's 4D mesh, and long-context decode
with the KV cache's sequence dim sharded over data, held against the JAX
package on the CPU.

One ``torch.distributed.run --nproc-per-node 4`` launch of this file's
``__main__`` runs four gloo ranks; within that world each rank runs four
meshes in turn:

  * (1,2,2,1) and (2,1,1,2) with the reduced ``jamba-v0.1-52b-dense-ffn``
    (the Mamba layer's inner channels over y): one Mamba layer's prefill
    and decode outputs and states against ``mamba_apply`` under
    ``shard_map``, then ``make_prefill_step`` + ``make_decode_step``
    logits and caches against JAX's steps on the same mesh; on (1,2,2,1)
    also under ``OverlapConfig.all_on()``, bitwise the blocking run and
    held to JAX's overlapped steps; each rank's parameters are slices of
    the one-card model of the same seed;
  * (2,1,2,1) and (4,1,1,1): ``make_decode_step(seqshard=True)`` for the
    reduced ``qwen3-1.7b`` and Jamba, 3 steps from zero caches and 3
    steps across a shard boundary from seeded caches, against JAX's
    seqshard step and the port's unsharded decode of the same caches
    (the reference's ``rtol=2e-3, atol=1e-4``,
    ``tests/test_archs_smoke.py``); after each step only the shard that
    owns the position has a changed K/V row; and
    ``attention.decode_core_seqsharded`` against the reference's at the
    function level, with and without a window of 8 across a boundary.

Each rank's outputs are held against the JAX package run on the same mesh
shape in this process (8 forced host devices), on weights carried across
by ``convert.params_from_jax(..., axes, rank)``. On the CPU the port's
wrappers run their kernels' plain versions (K5's with its log-sum-exp).
Inputs are made with numpy from seeds. Tolerances: ``LOGIT_TOL`` and
``LAYER_TOL`` as ``tests/test_torch_hybrid.py`` holds one card (float32
sums taken in another order; on a mesh also over x and y through gloo).
"""
import dataclasses
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core.compat import shard_map
from repro.core.overlap import OverlapConfig as JOverlap
from repro.core.partition import spec_tree_to_pspecs
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.layers import attention as jattn
from repro.layers import mamba as jmamba
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import param_spec
from repro_torch.launch import steps as ST
from repro_torch.layers.attention import SEQ_CACHE_SPEC, \
    decode_core_seqsharded
from repro_torch.layers.mamba import Mamba, mamba_state_spec

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAMBA = "jamba-v0.1-52b-dense-ffn"
QWEN = "qwen3-1.7b"
WORLD = 4
HYBRID_MESHES = {"tp": (1, 2, 2, 1), "dz": (2, 1, 1, 2)}
SEQ_MESHES = {"dy": (2, 1, 2, 1), "d4": (4, 1, 1, 1)}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_hybrid.py's
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
# the port's seq-sharded decode against its unsharded decode: the
# reference's own bound for the same comparison
SEQ_TOL = dict(rtol=2e-3, atol=1e-4)
FIXED = dict(B=4, T=8, S=12)     # prefill 4 x 8 into 12 positions
DECODES = 3
MAMBA_LAYERS = (0, 6)
LAYER_ROWS = dict(B=4, T=16)     # one Mamba layer's prefill rows
# seq-sharded decode: S_local = 32 rows a shard, so S = 32 g_data; the
# second run starts from caches holding random keys below SEQ_P0 and
# crosses the boundary of shards 0 and 1 (positions 31, 32, 33)
SEQ_LOCAL = 32
SEQ_P0 = 31
SEQ_STEPS = 3
# decode_core_seqsharded at the function level: 4/2 heads, hd 64, one
# query at each position (the first four cross shard 0's end)
CORE = dict(nq=4, nkv=2, hd=64, positions=(30, 31, 32, 35, 70))
CORE_WINDOWS = (0, 8)
BATCH = (("data", "z"), None, None)


def _cfgs(arch):
    if arch == JAMBA:
        jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b"),
                                   moe=None, name=JAMBA)
    else:
        jcfg = jax_get_config(arch)
    return jcfg.reduced(), get_config(arch).reduced()


def _seq_cases():
    return [(arch, name) for arch in (QWEN, JAMBA) for name in SEQ_MESHES]


def _mesh_sizes(name):
    return {**HYBRID_MESHES, **SEQ_MESHES}[name]


# ---------------------------------------------------------------------- #
# inputs, from numpy seeds
# ---------------------------------------------------------------------- #

def _hybrid_inputs(cfg):
    rng = np.random.RandomState(0)
    B, T = FIXED["B"], FIXED["T"]
    lb, lt = LAYER_ROWS["B"], LAYER_ROWS["T"]
    return dict(
        layer_h=rng.randn(lb, lt, cfg.d_model).astype(np.float32),
        layer_dec=rng.randn(DECODES, lb, 1, cfg.d_model).astype(np.float32),
        prompts=rng.randint(1, cfg.vocab_size, (B, T)).astype(np.int32),
        decode=rng.randint(1, cfg.vocab_size,
                           (DECODES, B, 1)).astype(np.int32))


def _seq_tokens(cfg):
    rng = np.random.RandomState(3)
    return rng.randint(1, cfg.vocab_size,
                       (2, SEQ_STEPS, 1, 1)).astype(np.int32)


def _seq_caches(ct, seed):
    """Global numpy caches of the JAX cache tree ``ct``: K/V random below
    SEQ_P0 and zero from it on, Mamba states random."""
    rng = np.random.RandomState(seed)

    def one(path, t):
        st, _ = t
        name = path[-1].key
        v = rng.randn(*st.shape).astype(st.dtype)
        if name in ("k", "v"):
            v[:, :, SEQ_P0:] = 0        # (n_periods, B, S, heads, hd)
        elif name == "conv":
            v *= 0.5
        else:
            v *= 0.1
        return v
    return jax.tree_util.tree_map_with_path(
        one, ct, is_leaf=lambda t: isinstance(t, tuple) and len(t) == 2
        and isinstance(t[0], jax.ShapeDtypeStruct))


def _core_inputs(S):
    rng = np.random.RandomState(7)
    c = CORE
    return dict(q=rng.randn(len(c["positions"]), 1, 1, c["nq"], c["hd"]
                            ).astype(np.float32),
                k=rng.randn(1, S, c["nkv"], c["hd"]).astype(np.float32),
                v=rng.randn(1, S, c["nkv"], c["hd"]).astype(np.float32))


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

def _caches_copy(caches):
    return [{k: v.clone() for k, v in layer.items()} for layer in caches]


def _worker_hybrid(name, axes, outdir):
    """Jamba on (1,2,2,1) or (2,1,1,2): one Mamba layer, then serving."""
    _, tcfg = _cfgs(JAMBA)
    inp = _hybrid_inputs(tcfg)
    rank = M.process_rank()
    out = {}
    if name == "tp":
        own = ST.init_model(tcfg, axes, seed=0, device="cpu")
        one = dict(ST.init_model(tcfg, seed=0, device="cpu"
                                 ).named_parameters())
        out["shards_equal"] = {
            n: torch.equal(p, M.shard(one[n], axes, param_spec(n)))
            for n, p in own.named_parameters()}
    model = convert.params_from_jax(_load_tree(outdir / f"{JAMBA}.npz"),
                                    tcfg, "cpu", axes, rank)
    # one Mamba layer: prefill from zeros, then decode rows
    for layer in MAMBA_LAYERS:
        mixer = model.layers[layer].mixer
        assert isinstance(mixer, Mamba)
        state = ST.zeros_caches(mamba_state_spec(tcfg, axes,
                                                 LAYER_ROWS["B"]), "cpu")
        res = []
        with torch.inference_mode():
            for h in [inp["layer_h"], *inp["layer_dec"]]:
                h = M.shard(torch.from_numpy(h), axes,
                            BATCH[:2] + ("x",))
                mode = "prefill" if len(res) == 0 else "decode"
                o = mixer(h, mode=mode, state=state)
                res.append((o, {k: v.clone() for k, v in state.items()}))
        out[f"mamba{layer}"] = res
    # prefill, then decode steps, blocking and (on tp) overlapped
    B, T, S = FIXED["B"], FIXED["T"], FIXED["S"]
    schedules = [OverlapConfig()] + ([OverlapConfig.all_on()]
                                     if name == "tp" else [])
    for i, ov in enumerate(schedules):
        pre, ct = ST.make_prefill_step(tcfg, axes, overlap=ov)(B, T, S)
        dec, _ = ST.make_decode_step(tcfg, axes, overlap=ov)(B, S)
        caches = ST.zeros_caches(ct, "cpu")
        logits, caches = pre(model, caches, torch.from_numpy(inp["prompts"]))
        steps = [(logits, _caches_copy(caches))]
        for j in range(DECODES):
            logits, caches = dec(model, caches,
                                 torch.from_numpy(inp["decode"][j]), T + j)
            steps.append((logits, _caches_copy(caches)))
        out["overlap" if i else "fixed"] = steps
    return out


def _owner_ok(before, after, pos, axes):
    """Only the shard owning ``pos`` has a changed K/V row, and only at
    pos's local row."""
    shard = M.axis_index(axes, "data")
    for b, a in zip(before, after):
        if "k" not in b:
            continue
        S_local = b["k"].shape[1]
        local = pos - shard * S_local
        for key in ("k", "v"):
            rows = (a[key] != b[key]).flatten(2).any(-1).any(0)
            want = torch.zeros_like(rows)
            if 0 <= local < S_local:
                want[local] = True
            if not torch.equal(rows, want):
                return False
    return True


def _worker_seq(name, axes, outdir):
    """``make_decode_step(seqshard=True)`` for both archs, then the core
    at the function level."""
    rank = M.process_rank()
    out = {}
    S = SEQ_LOCAL * axes.dp
    for arch in (QWEN, JAMBA):
        _, tcfg = _cfgs(arch)
        model = convert.params_from_jax(_load_tree(outdir / f"{arch}.npz"),
                                        tcfg, "cpu", axes, rank)
        step, ct = ST.make_decode_step(tcfg, axes, seqshard=True)(1, S)
        toks = _seq_tokens(tcfg)
        for run, start in enumerate((0, SEQ_P0)):
            if run == 0:
                caches = ST.zeros_caches(ct, "cpu")
            else:
                caches = convert.caches_from_jax(
                    _load_tree(outdir / f"seqcache_{arch}_{name}.npz"),
                    tcfg, "cpu", axes, rank, seqshard=True)
            res = []
            for j in range(SEQ_STEPS):
                before = _caches_copy(caches)
                logits, caches = step(model, caches,
                                      torch.from_numpy(toks[run, j]),
                                      start + j)
                res.append((ST.gather_logits(logits, axes, seqshard=True),
                            _owner_ok(before, caches, start + j, axes)))
            out[f"{arch}/{run}"] = res
    # decode_core_seqsharded on this rank's shard of the keys and heads
    inp = _core_inputs(S)
    k, v = (M.shard(torch.from_numpy(inp[n]), axes, SEQ_CACHE_SPEC)
            for n in ("k", "v"))
    for window in CORE_WINDOWS:
        got = []
        for q, pos in zip(inp["q"], CORE["positions"]):
            q = M.shard(torch.from_numpy(q), axes, (None, None, "y", None))
            got.append(decode_core_seqsharded(q, k, v, pos, axes,
                                              window=window))
        out[f"core/{window}"] = got
    return out


def _rank_worker(outdir: pathlib.Path):
    """One rank: every mesh in turn in one world of 4, saved to
    rank<r>.pt."""
    from repro_torch.launch.mesh import close_mesh, init_mesh
    out = {}
    try:
        names = [*HYBRID_MESHES, *SEQ_MESHES]
        for i, name in enumerate(names):
            axes = MeshAxes(_mesh_sizes(name))
            if i == 0:
                init_mesh(axes, device="cpu")
            else:
                M.init_groups(axes)
            work = _worker_hybrid if name in HYBRID_MESHES else _worker_seq
            out[name] = work(name, axes, outdir)
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
    mesh = LM.make_smoke_mesh(_mesh_sizes(name))
    return mesh, LM.bind_4d(mesh)


def _is_spec(t):
    return (isinstance(t, tuple) and len(t) == 2
            and isinstance(t[0], jax.ShapeDtypeStruct))


def _jax_mamba(jcfg, mesh, axes, specs, params, inp, layer):
    """One Mamba layer under shard_map: its prefill, then the decode rows
    from its state; per call (out, state), global numpy."""
    tcfg = _cfgs(JAMBA)[1]
    s, i, p = tcfg.layer_slots()[layer]
    jp = jax.tree.map(lambda a: a[p],
                      params["segments"][f"seg{s}"][f"pos{i}"]["mixer"])
    psp = jax.tree.map(lambda sp: P(*tuple(sp)[1:]), spec_tree_to_pspecs(
        specs)["segments"][f"seg{s}"][f"pos{i}"]["mixer"],
        is_leaf=lambda t: isinstance(t, P))
    st = jmamba.mamba_state_spec(jcfg, axes, LAYER_ROWS["B"],
                                 dtype=jnp.float32)
    sspec = jax.tree.map(lambda t: t[1], st, is_leaf=_is_spec)
    hspec = axes.pspec(axes.batch_axes(), None, axes.x)
    out = []
    for mode in ("prefill", "decode"):
        def f(p, h, state, mode=mode):
            return jmamba.mamba_apply(p, h, jcfg, axes, mode=mode,
                                      state=state)
        fn = jax.jit(shard_map(
            f, mesh=mesh, in_specs=(psp, hspec, sspec),
            out_specs=(hspec, sspec), check_vma=False))
        if mode == "prefill":
            state = jax.tree.map(lambda t: jnp.zeros(t[0].shape, t[0].dtype),
                                 st, is_leaf=_is_spec)
            o, state = fn(jp, jnp.asarray(inp["layer_h"]), state)
            out.append((o, state))
        else:
            for h in inp["layer_dec"]:
                o, state = fn(jp, jnp.asarray(h), state)
                out.append((o, state))
    return [(np.asarray(o), jax.tree.map(np.asarray, s)) for o, s in out]


def _jax_fixed(jcfg, mesh, axes, params, inp, overlap=JOverlap()):
    B, T, S = FIXED["B"], FIXED["T"], FIXED["S"]
    pbuild, _ = JST.make_prefill_step(jcfg, mesh, axes, dtype=jnp.float32,
                                      overlap=overlap)
    pre, _, ct = pbuild(B, T, S)
    dbuild, _ = JST.make_decode_step(jcfg, mesh, axes, dtype=jnp.float32,
                                     overlap=overlap)
    dec, _ = dbuild(B, S)
    caches = JST.zeros_caches(mesh, ct)
    logits, caches = pre(params, caches,
                         {"tokens": jnp.asarray(inp["prompts"])})
    out = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
    for i in range(DECODES):
        logits, caches = dec(params, caches, jnp.asarray(inp["decode"][i]),
                             jnp.int32(T + i))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, caches)))
    return out


def _jax_seq(jcfg, mesh, axes, params, toks, caches0, S):
    """JAX's seqshard decode: from zeros, then from ``caches0``; per run
    the logits of each step (1, 1, V)."""
    build, _ = JST.make_decode_step(jcfg, mesh, axes, seqshard=True,
                                    dtype=jnp.float32)
    step, ct = build(1, S)
    out = []
    for run, start in enumerate((0, SEQ_P0)):
        if run == 0:
            caches = JST.zeros_caches(mesh, ct)
        else:
            caches = jax.tree.map(
                lambda t, v: jax.device_put(jnp.asarray(v),
                                            NamedSharding(mesh, t[1])),
                ct, caches0, is_leaf=_is_spec)
        res = []
        for j in range(SEQ_STEPS):
            logits, caches = step(params, caches, jnp.asarray(toks[run, j]),
                                  jnp.int32(start + j))
            res.append(np.asarray(logits))
        out.append(res)
    return out


def _port_unsharded(tcfg, tree, toks, caches0, S):
    """The port's one-rank decode (mode "decode") of the same steps and
    caches."""
    model = convert.params_from_jax(tree, tcfg, "cpu")
    step, ct = ST.make_decode_step(tcfg, MeshAxes())(1, S)
    out = []
    for run, start in enumerate((0, SEQ_P0)):
        caches = (ST.zeros_caches(ct, "cpu") if run == 0
                  else convert.caches_from_jax(caches0, tcfg))
        res = []
        for j in range(SEQ_STEPS):
            logits, caches = step(model, caches,
                                  torch.from_numpy(toks[run, j]), start + j)
            res.append(logits.numpy())
        out.append(res)
    return out


def _jax_core(mesh, axes, inp, window):
    spec_q = P(None, None, "y", None)
    spec_k = P(None, "data", "y", None)

    def f(q, k, v, pos):
        return jattn.decode_core_seqsharded(q, k, v, pos, axes,
                                            window=window)
    fn = jax.jit(shard_map(f, mesh=mesh,
                           in_specs=(spec_q, spec_k, spec_k, P()),
                           out_specs=spec_q, check_vma=False))
    return [np.asarray(fn(jnp.asarray(q), jnp.asarray(inp["k"]),
                          jnp.asarray(inp["v"]), jnp.int32(pos)))
            for q, pos in zip(inp["q"], CORE["positions"])]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX weights per arch and the seeded seq-sharded caches saved, the
    4-rank worker launched; while it runs, the JAX package computes every
    case on the same mesh shapes and the port its one-rank decodes.
    Returns (ranks' results, JAX's and the one-rank port's results)."""
    outdir = tmp_path_factory.mktemp("mesh_hybrid_ranks")
    ref = {}
    trees = {}
    for arch in (QWEN, JAMBA):
        jcfg, _ = _cfgs(arch)
        _, axes = _jax_mesh("tp")
        params, specs = JST.init_model(jcfg, axes, jax.random.PRNGKey(0),
                                       dtype=jnp.float32)
        trees[arch] = jax.tree.map(np.asarray, params)
        _save_tree(trees[arch], outdir / f"{arch}.npz")
        ref[arch] = dict(params=params, specs=specs)
    for arch, name in _seq_cases():
        jcfg, _ = _cfgs(arch)
        mesh, axes = _jax_mesh(name)
        _, ct = JST.make_decode_step(jcfg, mesh, axes, seqshard=True,
                                     dtype=jnp.float32)[0](
            1, SEQ_LOCAL * mesh.shape["data"])
        caches = _seq_caches(ct, seed=11)
        _save_tree(caches, outdir / f"seqcache_{arch}_{name}.npz")
        ref[(arch, name, "caches")] = caches
    proc = _torchrun([__file__, str(outdir)])
    try:
        jcfg, tcfg = _cfgs(JAMBA)
        inp = _hybrid_inputs(tcfg)
        params, specs = ref[JAMBA]["params"], ref[JAMBA]["specs"]
        for name in HYBRID_MESHES:
            mesh, axes = _jax_mesh(name)
            for layer in MAMBA_LAYERS:
                ref[(name, layer)] = _jax_mamba(jcfg, mesh, axes, specs,
                                                params, inp, layer)
            ref[(name, "fixed")] = _jax_fixed(jcfg, mesh, axes, params, inp)
        mesh, axes = _jax_mesh("tp")
        ref[("tp", "overlap")] = _jax_fixed(jcfg, mesh, axes, params, inp,
                                            JOverlap.all_on())
        for arch, name in _seq_cases():
            jcfg, tcfg = _cfgs(arch)
            mesh, axes = _jax_mesh(name)
            S = SEQ_LOCAL * mesh.shape["data"]
            toks = _seq_tokens(tcfg)
            caches0 = ref[(arch, name, "caches")]
            ref[(arch, name)] = _jax_seq(jcfg, mesh, axes,
                                         ref[arch]["params"], toks, caches0,
                                         S)
            ref[(arch, name, "one")] = _port_unsharded(tcfg, trees[arch],
                                                       toks, caches0, S)
        for name in SEQ_MESHES:
            mesh, axes = _jax_mesh(name)
            inp = _core_inputs(SEQ_LOCAL * mesh.shape["data"])
            for window in CORE_WINDOWS:
                ref[(name, "core", window)] = _jax_core(mesh, axes, inp,
                                                        window)
    finally:
        _wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, ref


def _block(a, axes, rank, spec):
    """Rank ``rank``'s block of the global numpy array ``a``."""
    return M.shard(torch.from_numpy(np.array(a)), axes, spec,
                   rank).numpy()


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #

def test_jamba_shards_are_slices_of_the_one_card_model(world):
    """``init_model`` of the reduced Jamba on (1,2,2,1): each rank's
    parameters are bitwise the blocks of the one-card model of the same
    seed (the per-channel Mamba leaves drawn whole, then sliced over y)."""
    ranks, _ = world
    for r, res in enumerate(ranks):
        eq = res["tp"]["shards_equal"]
        assert not [n for n, ok in eq.items() if not ok], r
        assert any(n.endswith("mixer.conv_w") for n in eq)


@pytest.mark.parametrize("layer", MAMBA_LAYERS)
@pytest.mark.parametrize("name", sorted(HYBRID_MESHES))
def test_mamba_layer_on_the_mesh_matches_jax(world, name, layer):
    """One Mamba layer's prefill (4 x 16 rows) and 3 decode rows: each
    rank's output (its batch shard, its x slice) and its states (its y
    channels) against ``mamba_apply`` under ``shard_map``."""
    ranks, ref = world
    axes = MeshAxes(HYBRID_MESHES[name])
    specs = {"conv": (("data", "z"), None, "y"),
             "ssm": (("data", "z"), "y", None)}
    for r, res in enumerate(ranks):
        for step, ((o, st), (jo, jst)) in enumerate(zip(
                res[name][f"mamba{layer}"], ref[(name, layer)])):
            np.testing.assert_allclose(
                o.numpy(), _block(jo, axes, r, BATCH[:2] + ("x",)),
                **LAYER_TOL, err_msg=f"{name} rank {r} step {step}")
            for k, spec in specs.items():
                np.testing.assert_allclose(
                    st[k].numpy(), _block(jst[k], axes, r, spec),
                    **LAYER_TOL, err_msg=f"{name} rank {r} {k} {step}")


def _check_fixed(got_steps, want_steps, name, r, tcfg):
    axes = MeshAxes(_mesh_sizes(name))
    for step, ((lg, caches), (jl, jc)) in enumerate(zip(got_steps,
                                                        want_steps)):
        np.testing.assert_allclose(
            lg.numpy(), _block(jl, axes, r, (("data", "z"), None, "y")),
            **LOGIT_TOL, err_msg=f"{name} rank {r} step {step}")
        want = convert.caches_from_jax(jc, tcfg, "cpu", axes, r)
        for layer, (g, w) in enumerate(zip(caches, want)):
            for k in w:
                np.testing.assert_allclose(
                    g[k].numpy(), w[k].numpy(), **LOGIT_TOL,
                    err_msg=f"{name} rank {r} step {step} {layer} {k}")


@pytest.mark.parametrize("name", sorted(HYBRID_MESHES))
def test_hybrid_prefill_and_decode_match_jax(world, name):
    """Prefill of 4 x 8 and 3 decode steps of the reduced Jamba: each
    rank's logits and every layer's cache (K/V, conv and scan states)
    against JAX's prefill and decode steps on the same mesh."""
    ranks, ref = world
    tcfg = _cfgs(JAMBA)[1]
    for r, res in enumerate(ranks):
        _check_fixed(res[name]["fixed"], ref[(name, "fixed")], name, r, tcfg)


def test_hybrid_overlapped_schedule_is_the_blocking_run(world):
    """Under ``OverlapConfig.all_on()`` on (1,2,2,1) (the x/y all-reduces
    of every Mamba, attention and MLP product as rings): each rank's
    logits and caches bitwise the blocking run's, and held to JAX's
    overlapped steps."""
    ranks, ref = world
    tcfg = _cfgs(JAMBA)[1]
    for r, res in enumerate(ranks):
        for (lo, co), (lb, cb) in zip(res["tp"]["overlap"],
                                      res["tp"]["fixed"]):
            assert torch.equal(lo, lb), r
            assert all(torch.equal(a[k], b[k]) for a, b in zip(co, cb)
                       for k in a), r
        _check_fixed(res["tp"]["overlap"], ref[("tp", "overlap")], "tp", r,
                     tcfg)


@pytest.mark.parametrize("arch,name", _seq_cases())
def test_seqshard_decode_matches_jax_and_the_unsharded_decode(world, arch,
                                                              name):
    """``make_decode_step(seqshard=True)``: 3 steps from zero caches (only
    shard 0 holds keys) and 3 across the boundary of shards 0 and 1 from
    seeded caches. Every rank's logits, gathered over y, against JAX's
    seqshard step (``LOGIT_TOL``) and the port's unsharded decode of the
    same caches (``SEQ_TOL``); after each step only the shard that owns
    the position has changed, at that row."""
    ranks, ref = world
    for r, res in enumerate(ranks):
        for run in (0, 1):
            for j, (lg, owner_ok) in enumerate(res[name][f"{arch}/{run}"]):
                msg = f"{arch} {name} rank {r} run {run} step {j}"
                assert owner_ok, msg
                np.testing.assert_allclose(
                    lg.numpy(), ref[(arch, name)][run][j], **LOGIT_TOL,
                    err_msg=msg)
                np.testing.assert_allclose(
                    lg.numpy(), ref[(arch, name, "one")][run][j],
                    **SEQ_TOL, err_msg=msg)


@pytest.mark.parametrize("window", CORE_WINDOWS)
@pytest.mark.parametrize("name", sorted(SEQ_MESHES))
def test_decode_core_seqsharded_matches_jax(world, name, window):
    """The seq-sharded core alone (K5's plain version with its lse, the
    pmax and the one psum over data) against the reference's
    ``decode_core_seqsharded``: queries at positions about shard 0's end,
    a window of 8 across it, a shard wholly past the query."""
    ranks, ref = world
    axes = MeshAxes(SEQ_MESHES[name])
    for r, res in enumerate(ranks):
        for got, want in zip(res[name][f"core/{window}"],
                             ref[(name, "core", window)]):
            np.testing.assert_allclose(
                got.numpy(), _block(want, axes, r, (None, None, "y", None)),
                **LAYER_TOL, err_msg=f"{name} rank {r}")


def test_seqshard_cache_specs_shard_positions_over_data():
    """The seq-sharded cache's shapes: K/V (1, S / g_data, local kv heads,
    hd) with S rounded to g_data pages of 32, Mamba states replicated over
    data and sharded over y; tokens are not batch-sharded."""
    from repro_torch.models.decoder import decoder_cache_specs
    tcfg = _cfgs(JAMBA)[1]
    axes = MeshAxes((2, 1, 2, 1))
    specs = decoder_cache_specs(tcfg, axes, 1, 100, seqshard=True)
    di = tcfg.mamba.expand * tcfg.d_model
    hd = tcfg.head_dim_
    for mixer, spec in zip(tcfg.mixers(), specs):
        if mixer == "attn":
            assert spec["k"][0] == (1, 64, tcfg.n_kv_heads // 2, hd)
        else:
            assert spec["conv"][0] == (1, tcfg.mamba.d_conv - 1, di // 2)
            assert spec["ssm"][0] == (1, di // 2, tcfg.mamba.d_state)
    assert decoder_cache_specs(tcfg, axes, 2, 100)[4]["k"][0] == (
        1, 128, tcfg.n_kv_heads // 2, hd)


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
