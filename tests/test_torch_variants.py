"""The dense config variants held against the JAX package on the CPU:
``gpt-paper-20b`` (the paper's GPT: LayerNorm, GELU, an ungated MLP, MHA,
an untied head), ``stablelm-1.6b`` (LayerNorm, 25% rotary, gated SiLU,
MHA) and ``nemotron-4-15b`` (LayerNorm, squared ReLU, ungated, 50%
rotary, GQA), each at ``ArchConfig.reduced()`` (d 256, 4 heads, hd 64).

In this process: every config field the port shares with the reference,
and the parameter count, active count, ``comm_layers`` and ``reduced()``;
``parallel.layer_norm`` on one device in float32 and bfloat16 (y, dx, dg,
db); the three MLP variants against ``mlp_apply``; ``lm_loss`` and every
gradient leaf of each arch, and ``gpt-paper-20b``'s 3-step trajectory;
StableLM's continuous serving and Nemotron's fixed prefill and decode;
the bucket plan and the ZeRO-3 leaf plan with their fingerprints; a
checkpoint read in the reference, ``b`` leaves and all; the decay set.

One ``torch.distributed.run --nproc-per-node 8`` launch of this file's
``__main__`` runs eight gloo ranks: ``layer_norm`` at x = 2 on
(1,2,2,2), ``gpt-paper-20b`` on (1,2,2,2) under the blocking and the
overlapped schedule (each gradient block, the first step's loss and
calls), then ZeRO-3 on (2,1,1,1) (ranks 2-7 idle) for 3 steps. The JAX
side computes on 8 forced host devices while the ranks run. The port runs
its kernels' plain versions on the CPU. Tolerances are those of
``tests/test_torch_training.py`` and ``tests/test_torch_serving.py``
(float32: the frameworks sum in other orders), and in bfloat16 those of
``tests/test_torch_kernels.py``.
"""
import dataclasses
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.core import gradsync as JGS
from repro.core import parallel as JPP
from repro.core.compat import shard_map
from repro.launch import steps as JST
from repro.layers import mlp as JMLP
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import gradsync as GS
from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core.gradsync import GradSyncConfig
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import param_spec
from repro_torch.launch import steps as ST
from repro_torch.layers.mlp import MLP
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_mesh_train as MT  # noqa: E402

sys.path.insert(0, str(MT.ROOT))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

GPT, STABLELM, NEMOTRON = "gpt-paper-20b", "stablelm-1.6b", "nemotron-4-15b"
ARCHS = (GPT, STABLELM, NEMOTRON)
WORLD = 8
MESH = (1, 2, 2, 2)
ZERO3_MESH = (2, 1, 1, 1)
SCHEDULES = {"blocking": OverlapConfig(), "overlapped": OverlapConfig.all_on()}
FN_TOL = dict(rtol=1e-5, atol=1e-5)      # test_torch_training.py, float32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)    # test_torch_kernels.py, bfloat16
LOSS_RTOL = MT.LOSS_RTOL
GRAD_REL = MT.GRAD_REL
TRAJ_RTOL = MT.TRAJ_RTOL
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)   # test_torch_serving.py
OPT_CFG = MT.OPT_CFG
JAX_THREADS = 4
LN_SHAPE = (4, 8, 32)                     # layer_norm's x: (B, T, d)
Z3 = GradSyncConfig(zero3=True, bucket_mb=0.25)


def _cfgs(arch):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


# layer_norm's cases: (torch dtype, jnp dtype, the rows' spread); rows of
# spread 0.01 have a variance of 1e-4, where eps 1e-5 moves the result
LN_CASES = {"float32": (torch.float32, jnp.float32, 2.0),
            "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0),
            "float32-small-variance": (torch.float32, jnp.float32, 0.01)}


# ---------------------------------------------------------------------- #
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------- #

def _ln_inputs(spread):
    rng = np.random.RandomState(3)
    B, T, d = LN_SHAPE
    return (rng.randn(B, T, d).astype(np.float32) * spread + 0.5,
            (1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32),
            rng.randn(B, T, d).astype(np.float32))


def _loss_batch(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (4, 16)).astype(np.int32)
            for _ in range(2)]


def _traj_batch(vocab):
    """conftest.train_smoke's batch: B 8, S 32."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (8, 32)).astype(np.int32)
            for _ in range(2)]


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _ln_close(got, want, tol, what):
    """Within ``tol``, atol scaled by the output's largest entry: dx grows
    as 1/sqrt(var + eps), and it is a difference of nearly equal terms."""
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"],
        atol=tol["atol"] * max(1.0, float(np.abs(want).max())),
        err_msg=what)


def _port_layer_norm(x, g, b, dy, axes, dtype):
    """y, dx, dg, db of the port's layer_norm on this rank's x blocks."""
    spec = (None, None, "x")
    xs = M.shard(torch.from_numpy(x), axes, spec).to(dtype).requires_grad_()
    gs, bs = (M.shard(torch.from_numpy(t), axes, ("x",)).to(dtype)
              .requires_grad_() for t in (g, b))
    y = PP.layer_norm(xs, gs, bs, axes, x.shape[-1])
    y.backward(M.shard(torch.from_numpy(dy), axes, spec).to(dtype))
    return [t.detach().float() for t in (y, xs.grad, gs.grad, bs.grad)]


def _mesh_run(tcfg, axes, tree, ov, rank):
    """Under ``ov``: the loss and this rank's gradient blocks of one
    microbatch after the step's reductions; the first train step's
    metrics and its calls by axis (all of them, and the ring hops)."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    batch = MT._torch_batch(_loss_batch(tcfg.vocab_size), axes)
    tokens, labels = (M.batch_shard(batch[k], axes)
                      for k in ("tokens", "labels"))
    with D.overlap_bound(model, ov):
        loss, _ = D.lm_loss(model, tokens, labels, remat=True)
        loss.backward()
    grads = {k: g.clone() for k, g in ST.sync_grads(
        {n: p.grad for n, p in model.named_parameters()}, axes).items()}
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(dtype=torch.float32,
                                              overlap=ov))
    M.reset_comm()
    m = {k: float(v) for k, v in step(
        model, state, MT._torch_batch(_traj_batch(tcfg.vocab_size),
                                      axes)).items()}
    calls = ({a: c["calls"] for a, c in M.COMM_AXES.items()},
             {a: c["calls"] for a, c in M.HOPS.items()})
    return dict(loss=float(loss.detach()), grads=grads, step=m, calls=calls)


def _zero3_run(tcfg, axes, tree, rank, steps=3):
    """ZeRO-3's metrics over ``steps`` steps of the trajectory batch."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    ST.shard_model(model)
    opts = ST.TrainOptions(dtype=torch.float32, gradsync=Z3)
    tools = ST.make_gradsync_tools(tcfg, axes, dict(model.named_parameters()),
                                   opts)
    state = tools.init(model.shards)
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**OPT_CFG), opts,
                              tools=tools)
    batch = MT._torch_batch(_traj_batch(tcfg.vocab_size), axes)
    return [{k: float(v) for k, v in step(model, state, batch).items()}
            for _ in range(steps)]


def _rank_worker(outdir: pathlib.Path):
    from repro_torch.launch.mesh import close_mesh, init_mesh
    _, tcfg = _cfgs(GPT)
    tree = MT._load_tree(outdir / "gpt.npz")
    out = {}
    try:
        axes = MeshAxes(MESH)
        init_mesh(axes, device="cpu")
        rank = M.process_rank()
        out["ln"] = {name: _port_layer_norm(*_ln_inputs(spread), axes,
                                            dtype)
                     for name, (dtype, _, spread) in LN_CASES.items()}
        for name, ov in SCHEDULES.items():
            out[name] = _mesh_run(tcfg, axes, tree, ov, rank)
        axes = MeshAxes(ZERO3_MESH)
        M.init_groups(axes)
        if rank < axes.world:
            out["zero3"] = _zero3_run(tcfg, axes, tree, rank)
        torch.distributed.barrier()
    finally:
        close_mesh()
    torch.save(out, outdir / f"rank{rank}.pt")


# ---------------------------------------------------------------------- #
# the JAX side
# ---------------------------------------------------------------------- #

def _jax_layer_norm(sizes, name):
    """The reference's layer_norm and its custom_vjp on ``sizes`` (x
    sharding the features) at ``LN_CASES[name]``: global y, dx, dg, db
    (the gain's and bias's gradients each x rank's own features)."""
    mesh, axes = MT._jax_mesh(sizes)
    _, dtype, spread = LN_CASES[name]
    x, g, b, dy = (jnp.asarray(t, dtype) for t in _ln_inputs(spread))
    xs, gs = P(None, None, "x"), P("x")

    def step(x, g, b, dy):
        y, pull = jax.vjp(lambda *a: JPP.layer_norm(*a, axes, LN_SHAPE[-1]),
                          x, g, b)
        return y, pull(dy)
    f = shard_map(step, mesh=mesh, in_specs=(xs, gs, gs, xs),
                  out_specs=(xs, (xs, gs, gs)), check_vma=False)
    y, grads = jax.jit(f)(x, g, b, dy)
    return [np.asarray(t, np.float32) for t in (y, *grads)]


def _jax_trees():
    return {arch: MT._init_tree(_cfgs(arch)[0], (1, 1, 1, 1))
            for arch in ARCHS}


@pytest.fixture(scope="module")
def trees():
    return _jax_trees()


@pytest.fixture(scope="module")
def world(tmp_path_factory, trees):
    """The 8-rank worker launched on ``gpt-paper-20b``'s JAX weights;
    while it runs, JAX computes the one-device loss, gradients and
    trajectory of each arch and layer_norm on one and on two x devices.
    Returns (ranks' results, JAX's results)."""
    outdir = tmp_path_factory.mktemp("variants_ranks")
    MT._save_tree(trees[GPT], outdir / "gpt.npz")
    proc = MT._torchrun([__file__, str(outdir)])
    try:
        tasks = []
        for arch in ARCHS:
            jcfg, tcfg = _cfgs(arch)
            tasks.append(((arch, "grads"), MT._jax_grads,
                          (jcfg, (1, 1, 1, 1), trees[arch],
                           *_loss_batch(tcfg.vocab_size))))
        jcfg, tcfg = _cfgs(GPT)
        tasks.append(((GPT, "traj"), MT._jax_trajectory,
                      (jcfg, (1, 1, 1, 1), trees[GPT],
                       _traj_batch(tcfg.vocab_size))))
        for name in LN_CASES:
            for sizes in ((1, 1, 1, 1), (1, 2, 1, 1)):
                tasks.append((("ln", name, sizes[1]), _jax_layer_norm,
                              (sizes, name)))
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            done = {key: pool.submit(fn, *args) for key, fn, args in tasks}
            jax_out = {key: f.result() for key, f in done.items()}
    finally:
        MT._wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out


def _one_device_grad(jgrads, name, path):
    """The one-device JAX gradient of the port parameter ``name`` (its
    device dim dropped, a stacked leaf's layer taken)."""
    return MT._layer(MT._leaf(jgrads, path)[0], name)


# ---------------------------------------------------------------------- #
# 1. the configs
# ---------------------------------------------------------------------- #

def _jax_dense_ffn():
    """The reference's Jamba with its experts replaced by the dense MLP,
    as ``configs/jamba_v0_1_52b.DENSE_FFN`` makes it (its citation says
    so: "source" is not compared)."""
    cfg = jax_get_config("jamba-v0.1-52b")
    return dataclasses.replace(cfg, name=cfg.name + "-dense-ffn", moe=None)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "jamba-v0.1-52b",
                                  "jamba-v0.1-52b-dense-ffn", *ARCHS,
                                  "deepseek-v2-lite-16b"])
def test_config_matches_the_reference(arch):
    """Every field the port's ArchConfig shares with the reference's is
    equal, and so are the parameter counts (the MLP charged (mult + 1) d
    d_ff: 20.17 B for gpt-paper-20b), comm_layers (MLA and MoE too) and
    reduced(), for every ported arch."""
    ours = get_config(arch)
    theirs = (_jax_dense_ffn() if arch.endswith("-dense-ffn")
              else jax_get_config(arch))
    skip = ("moe", "mamba", "mla") + (
        ("source",) if arch.endswith("-dense-ffn") else ())
    shared = [f.name for f in dataclasses.fields(ours) if f.name not in skip]
    for small in (False, True):
        a, b = (ours.reduced(), theirs.reduced()) if small else (ours,
                                                                 theirs)
        for f in shared:
            assert getattr(a, f) == getattr(b, f), (arch, small, f)
        for f in ("moe", "mamba", "mla"):
            got, want = getattr(a, f), getattr(b, f)
            assert (got is None) == (want is None), (arch, f)
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert [dataclasses.astuple(x) for x in a.comm_layers()] == [
            dataclasses.astuple(x) for x in b.comm_layers()]
    if arch == GPT:
        assert ours.param_count() == 20_166_213_632


def test_danube_stays_refused_naming_head_dim_120():
    with pytest.raises(NotImplementedError, match="head_dim 120"):
        get_config("h2o-danube-3-4b")


@pytest.mark.parametrize("arch", ARCHS)
def test_the_variants_build_a_decoder(arch):
    """Each config builds a Decoder: LayerNorm's g and b in every norm, no
    gate leaf in an ungated MLP."""
    cfg = get_config(arch).reduced()
    names = dict(D.Decoder(cfg, MeshAxes(), gen=torch.Generator())
                 .named_parameters())
    assert {"final_norm.g", "final_norm.b", "layers.0.norm1.b",
            "layers.1.norm2.b"} <= set(names)
    assert ("layers.0.ffn.wg" in names) == cfg.gated_mlp
    assert ("lm_head" in names) != cfg.tie_embeddings


# ---------------------------------------------------------------------- #
# 2. layer_norm
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(LN_CASES))
def test_layer_norm_matches_the_reference_on_one_device(world, name):
    """y, dx, dg and db against the reference's custom_vjp on one device
    (``tests/test_parallel.py::test_layer_norm_matches``'s function); dx
    comes back in dy's dtype; rows of small variance pin eps (1e-5). The
    tolerance's atol scales with each output's largest entry."""
    _, jax_out = world
    dtype, _, spread = LN_CASES[name]
    got = _port_layer_norm(*_ln_inputs(spread), MeshAxes(), dtype)
    tol = FN_TOL if dtype == torch.float32 else BF16_TOL
    for what, g, w in zip(("y", "dx", "dg", "db"), got,
                          jax_out["ln", name, 1]):
        _ln_close(g.numpy(), w, tol, what)


@pytest.mark.parametrize("name", sorted(LN_CASES))
def test_layer_norm_on_two_x_ranks_matches_the_reference(world, name):
    """Each rank of (1,2,2,2) holds its x half of the features: its y,
    dx, dg and db are the blocks of the reference's on two x devices (the
    mean and the centred variance psum'd over x, the backward's two means
    likewise)."""
    ranks, jax_out = world
    axes = MeshAxes(MESH)
    tol = FN_TOL if LN_CASES[name][0] == torch.float32 else BF16_TOL
    want = jax_out["ln", name, 2]
    for r in range(WORLD):
        for what, g, w, spec in zip(("y", "dx", "dg", "db"),
                                    ranks[r]["ln"][name], want,
                                    [(None, None, "x")] * 2 + [("x",)] * 2):
            _ln_close(g.numpy(), MT._block(w, axes, r, spec), tol,
                      f"rank {r} {what}")


# ---------------------------------------------------------------------- #
# 3. the MLP
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("act,gated", [("gelu", False),
                                       ("squared_relu", False),
                                       ("gelu", True)])
def test_mlp_matches_the_reference(act, gated):
    """The port's MLP against ``mlp_apply`` on one device: the output and
    the gradients of h, wi, wo (and wg) for a random cotangent. GELU is
    the tanh form, ``jax.nn.gelu``'s default."""
    rng = np.random.RandomState(7)
    d, f = 24, 40
    h = rng.randn(2, 5, d).astype(np.float32)
    ws = {"wi": rng.randn(d, f) / np.sqrt(d), "wo": rng.randn(f, d)
          / np.sqrt(f)}
    if gated:
        ws["wg"] = rng.randn(d, f) / np.sqrt(d)
    ws = {k: v.astype(np.float32) for k, v in ws.items()}
    ct = rng.randn(2, 5, d).astype(np.float32)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))

    def step(h, p, ct):
        out, pull = jax.vjp(lambda h, p: JMLP.mlp_apply(
            p, h, act, axes, gated=gated), h, p)
        return out, pull(ct)
    specs = {k: P() for k in ws}
    f_ = shard_map(step, mesh=mesh, in_specs=(P(), specs, P()),
                   out_specs=(P(), (P(), specs)), check_vma=False)
    jout, (jdh, jdw) = jax.jit(f_)(h, ws, ct)
    mlp = MLP(d, f, MeshAxes(), gen=torch.Generator(), act=act, gated=gated)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in ws.items()})
    th = torch.from_numpy(h).requires_grad_()
    out = mlp(th)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FN_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **FN_TOL)
    for k, p in mlp.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jdw[k]),
                                   **FN_TOL, err_msg=k)


# ---------------------------------------------------------------------- #
# 4. one device: the loss, every gradient, the trajectory
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_match_jax(world, trees, arch):
    """``lm_loss`` within LOSS_RTOL and every gradient leaf, the norms'
    b leaves among them, within GRAD_REL of its largest entry."""
    _, jax_out = world
    _, tcfg = _cfgs(arch)
    jloss, jgrads = jax_out[arch, "grads"]
    model = convert.params_from_jax(trees[arch], tcfg, "cpu")
    tokens, labels = map(torch.from_numpy, _loss_batch(tcfg.vocab_size))
    loss, _ = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    paths = convert.jax_paths(model)
    assert any(n.endswith(".b") for n in paths)
    for name, p in model.named_parameters():
        jg = _one_device_grad(jgrads, name, paths[name])
        assert p.grad.shape == jg.shape, name
        err = np.abs(p.grad.numpy() - jg).max()
        assert err <= GRAD_REL * np.abs(jg).max(), (name, err)


def test_gpt_three_step_trajectory_matches_jax(world, trees):
    """conftest.train_smoke's settings (B 8, S 32, overdecompose 2, lr
    1e-3, warmup 1, float32): the loss and grad norm of each step."""
    _, jax_out = world
    _, tcfg = _cfgs(GPT)
    model = convert.params_from_jax(trees[GPT], tcfg, "cpu")
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(dtype=torch.float32))
    batch = MT._torch_batch(_traj_batch(tcfg.vocab_size), MeshAxes())
    for i, (jloss, jgn) in enumerate(jax_out[GPT, "traj"]):
        m = step(model, state, batch)
        assert abs(float(m["loss"]) - jloss) <= TRAJ_RTOL * abs(jloss), i
        assert abs(float(m["grad_norm"]) - jgn) <= TRAJ_RTOL * jgn, i


# ---------------------------------------------------------------------- #
# 5. gpt-paper-20b on (1,2,2,2), blocking and overlapped
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_gpt_mesh_gradient_blocks_are_the_one_device_gradient(world,
                                                              schedule):
    """Every rank's block of every gradient (the norms' b leaves among
    them), after the step's reductions, against the same block of the
    one-device JAX gradient; the microbatch's loss equal to one device's.
    """
    ranks, jax_out = world
    _, tcfg = _cfgs(GPT)
    axes = MeshAxes(MESH)
    jloss, jgrads = jax_out[GPT, "grads"]
    paths = {n: convert.jax_path(n, tcfg) for n in ranks[0][schedule][
        "grads"]}
    for r in range(WORLD):
        res = ranks[r][schedule]
        assert abs(res["loss"] - jloss) <= LOSS_RTOL * abs(jloss), r
        for name, g in res["grads"].items():
            full = _one_device_grad(jgrads, name, paths[name])
            want = MT._block(full, axes, r, param_spec(name))
            err = np.abs(g.numpy() - want).max()
            assert err <= GRAD_REL * np.abs(full).max(), (r, name, err)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_gpt_mesh_first_step_matches_one_device(world, schedule):
    """The first train step on (1,2,2,2): its loss and grad norm those of
    the one-device JAX step, and its calls by axis the count
    ``chip_smoke.py`` holds the card's run to (``mesh_train_collectives``
    blocking; ``mesh_train_hops`` overlapped)."""
    ranks, jax_out = world
    _, tcfg = _cfgs(GPT)
    axes = MeshAxes(MESH)
    jloss, jgn = jax_out[GPT, "traj"][0]
    for r in range(WORLD):
        m = ranks[r][schedule]["step"]
        assert abs(m["loss"] - jloss) <= LOSS_RTOL * abs(jloss), r
        assert abs(m["grad_norm"] - jgn) <= TRAJ_RTOL * jgn, r
        by_axis, hops = ranks[r][schedule]["calls"]
        if schedule == "blocking":
            assert not hops
            assert by_axis == chip_smoke.mesh_train_collectives(tcfg, axes,
                                                                2)
        else:
            want_hops, blocking = chip_smoke.mesh_train_hops(tcfg, axes, 2)
            rest = {a: c - hops.get(a, 0) for a, c in by_axis.items()}
            assert hops == want_hops
            assert {a: c for a, c in rest.items() if c} == blocking


def test_gpt_zero3_steps_match_one_device(world):
    """ZeRO-3 on (2,1,1,1): the final norm's g and b come from the
    gathered copies (a LayerNorm's bias read from the module's own
    meta shard would fail), so 3 steps match the one-device JAX
    trajectory."""
    ranks, jax_out = world
    for r in range(ZERO3_MESH[0]):
        for i, (m, (jloss, jgn)) in enumerate(zip(ranks[r]["zero3"],
                                                  jax_out[GPT, "traj"])):
            assert abs(m["loss"] - jloss) <= TRAJ_RTOL * abs(jloss), (r, i)
            assert abs(m["grad_norm"] - jgn) <= TRAJ_RTOL * jgn, (r, i)
    assert all("zero3" not in ranks[r] for r in range(2, WORLD))


# ---------------------------------------------------------------------- #
# 6. serving
# ---------------------------------------------------------------------- #

def _virtual_clock():
    state = {"t": 0.0}

    def tick():
        state["t"] += 1e-3
        return state["t"]
    return tick


def test_stablelm_paged_step_matches_jax(trees):
    """One prefill chunk (full, partial and idle slots) and 3 decode steps
    through ``paged_step``: logits within LOGIT_TOL, greedy ids equal."""
    jcfg, tcfg = _cfgs(STABLELM)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    params = jax.tree.map(jnp.asarray, trees[STABLELM])
    model = convert.params_from_jax(trees[STABLELM], tcfg, "cpu")
    page, n_pages = 4, 8
    jfn, jct = JST.make_paged_step(jcfg, mesh, axes,
                                   dtype=jnp.float32)[0](n_pages, page)
    jpools = JST.zeros_caches(mesh, jct)
    tfn, tct = ST.make_paged_step(tcfg, MeshAxes())(n_pages, page)
    tpools = ST.zeros_caches(tct, "cpu")
    rng = np.random.RandomState(2)
    table = np.array([[3, 1, 6, 0], [2, 5, 4, 0], [0, 0, 0, 0]], np.int32)
    q_len = np.array([8, 5, 0], np.int32)
    tokens = np.zeros((3, 8), np.int32)
    tokens[0], tokens[1, :5] = (rng.randint(1, tcfg.vocab_size, 8),
                                rng.randint(1, tcfg.vocab_size, 5))
    positions = np.broadcast_to(np.arange(8, dtype=np.int32), (3, 8)).copy()
    for step in range(4):
        jl, jpools = jfn(params, jpools, *map(jnp.asarray, (
            tokens, positions, q_len, table)))
        tl, tpools = tfn(model, torch.from_numpy(tokens), tpools,
                         torch.from_numpy(positions),
                         torch.from_numpy(q_len), torch.from_numpy(table))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, **LOGIT_TOL,
                                   err_msg=f"step {step}")
        ids = jl[:, 0].argmax(-1).astype(np.int32)
        assert np.array_equal(tl[:, 0].argmax(-1).numpy(), ids), step
        last = positions[np.arange(3), np.maximum(q_len - 1, 0)]
        live = q_len > 0
        tokens = np.where(live, ids, 0)[:, None].astype(np.int32)
        positions = np.where(live, last + 1, 0)[:, None].astype(np.int32)
        q_len = live.astype(np.int32)


def test_stablelm_engine_tokens_match_jax(trees):
    """Five requests of mixed lengths, staggered arrivals, a pool small
    enough to preempt: the port's continuous-batching engine generates the
    JAX engine's greedy tokens."""
    from repro.launch.serving import PagedEngine as JaxEngine
    from repro.launch.serving import Request as JaxRequest
    from repro.launch.serving import ServeConfig as JaxServeConfig
    from repro_torch.launch.serving import PagedEngine, Request, ServeConfig
    jcfg, tcfg = _cfgs(STABLELM)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    knobs = dict(slots=4, page_size=4, pages_per_shard=10, chunk=8)
    rng = np.random.RandomState(5)
    specs = [(rng.randint(1, jcfg.vocab_size, size=(int(rng.randint(3, 12)),)
                          ).astype(np.int32), int(rng.randint(2, 7)))
             for _ in range(5)]
    jeng = JaxEngine(jcfg, mesh, axes,
                     jax.tree.map(jnp.asarray, trees[STABLELM]),
                     JaxServeConfig(**knobs), dtype=jnp.float32)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=n, arrival=0.002 * i)
             for i, (p, n) in enumerate(specs)]
    jeng.run(jreqs, time_fn=_virtual_clock())
    model = convert.params_from_jax(trees[STABLELM], tcfg, "cpu")
    teng = PagedEngine(tcfg, MeshAxes(), model, ServeConfig(**knobs))
    treqs = [Request(rid=i, prompt=p, max_new=n, arrival=0.002 * i)
             for i, (p, n) in enumerate(specs)]
    teng.run(treqs, time_fn=_virtual_clock())
    for jr, tr in zip(jreqs, treqs):
        assert tr.state == "done" and tr.generated == jr.generated, tr.rid


def test_nemotron_fixed_prefill_and_decode_match_jax(trees):
    """Prefill of 4 prompts of 12 tokens, then 4 decode steps fed JAX's
    greedy ids: logits within LOGIT_TOL and the port's greedy ids
    JAX's."""
    jcfg, tcfg = _cfgs(NEMOTRON)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    params = jax.tree.map(jnp.asarray, trees[NEMOTRON])
    B, T, GEN = 4, 12, 5
    S = T + GEN
    tokens = np.random.RandomState(5).randint(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    jpre, _, ct = JST.make_prefill_step(jcfg, mesh, axes,
                                        dtype=jnp.float32)[0](B, T, S)
    jdec, _ = JST.make_decode_step(jcfg, mesh, axes,
                                   dtype=jnp.float32)[0](B, S)
    jcaches = JST.zeros_caches(mesh, ct)
    model = convert.params_from_jax(trees[NEMOTRON], tcfg, "cpu")
    pre, tct = ST.make_prefill_step(tcfg, MeshAxes())(B, T, S)
    dec, _ = ST.make_decode_step(tcfg, MeshAxes())(B, S)
    caches = ST.zeros_caches(tct, "cpu")
    jl, jcaches = jpre(params, jcaches, {"tokens": jnp.asarray(tokens)})
    tl, caches = pre(model, caches, torch.from_numpy(tokens))
    for i in range(GEN):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, **LOGIT_TOL,
                                   err_msg=f"step {i}")
        ids = jl[:, -1].argmax(-1).astype(np.int32)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), ids), i
        if i + 1 < GEN:
            jl, jcaches = jdec(params, jcaches, jnp.asarray(ids[:, None]),
                               jnp.int32(T + i))
            tl, caches = dec(model, caches, torch.from_numpy(ids[:, None]),
                             T + i)


# ---------------------------------------------------------------------- #
# 7. plans and checkpoints
# ---------------------------------------------------------------------- #

def _plan_pair(arch, sizes, zero3):
    jcfg, tcfg = _cfgs(arch)
    _, jaxes = MT._jax_mesh(sizes)
    structs, specs = JST.init_model(jcfg, jaxes, abstract=True,
                                    dtype=jnp.float32)
    axes = MeshAxes(sizes)
    model = ST.init_model(tcfg, axes, device="cpu", zero3=zero3)
    if zero3:
        jplan = JST._zero3_plan(structs, specs, jaxes)
        gs = Z3
    else:
        jplan = JGS.make_plan(structs, specs, jaxes, int(0.25 * 2 ** 20),
                              no_decay=JOPT._no_decay)
        gs = GradSyncConfig(zero=True, bucket_mb=0.25)
    plan = ST.train_plan(dict(model.named_parameters()), tcfg, axes, gs)
    flat, _ = jax.tree_util.tree_flatten_with_path(structs)
    return jplan, plan, ["/".join(str(k.key) for k in p) for p, _ in flat]


@pytest.mark.parametrize("zero3", [False, True], ids=["buckets", "leaves"])
@pytest.mark.parametrize("sizes", [(2, 2, 2, 1), (2, 1, 1, 2)], ids=str)
@pytest.mark.parametrize("arch", [STABLELM, GPT])
def test_plans_match_the_reference(arch, sizes, zero3):
    """The bucket plan (ZeRO-1) and the ZeRO-3 leaf plan walk the JAX
    tree's leaves, the norms' b among them, in its order: the same
    buckets, groups and gids, and the reference's plan_fingerprint."""
    jplan, plan, paths = _plan_pair(arch, sizes, zero3)
    assert [lf.path for lf in plan.leaves] == paths
    assert any(p.endswith("/b") for p in paths)
    assert plan.dp == jplan.dp and plan.n_leaves == jplan.n_leaves
    assert len(plan.buckets) == len(jplan.buckets)
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert (b.size, b.padded, b.z_reduced, b.y_reduce, b.stack) == (
            jb.size, jb.padded, jb.z_reduced, jb.y_reduce, jb.stack)
        assert [dataclasses.astuple(x) for x in b.segments] == [
            dataclasses.astuple(x) for x in jb.segments]
        assert [(g.decay, g.norm_names) for g in b.groups] == [
            (g.decay, g.norm_names) for g in jb.groups]
        np.testing.assert_array_equal(b.gid, jb.gid)
    assert GS.plan_fingerprint(plan) == JGS.plan_fingerprint(jplan)


def test_a_checkpoint_carries_the_b_leaves_both_ways(tmp_path, trees):
    """After two port train steps (the biases moved off 0) the port's
    ``.npz`` verifies and restores in the reference, every leaf, the
    norms' b among them, equal to the port's; and it restores back into
    the port on (1,2,1,1) as each rank's blocks."""
    jcfg, tcfg = _cfgs(GPT)
    model = convert.params_from_jax(trees[GPT], tcfg, "cpu")
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(dtype=torch.float32))
    batch = MT._torch_batch(_traj_batch(tcfg.vocab_size), MeshAxes())
    for _ in range(2):      # the warm-up's first step has lr 0
        step(model, state, batch)
    path = str(tmp_path / "gpt.npz")
    ckpt.save(path, convert.params_to_jax(model),
              convert.opt_state_to_jax(state, model), step=2,
              pspecs=convert.jax_specs(model))
    structs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           trees[GPT])
    assert jckpt.verify(path)["leaves"] == 4 * len(
        jax.tree.leaves(structs)) + 1
    jparams, saved = jckpt.restore(path, structs)
    assert saved == 2
    paths = convert.jax_paths(model)
    params = dict(model.named_parameters())
    assert float(params["layers.0.norm1.b"].detach().abs().max()) > 0
    for n, p in params.items():
        np.testing.assert_array_equal(
            MT._layer(np.asarray(MT._leaf(jparams, paths[n])), n),
            p.detach().numpy(), err_msg=n)
    axes = MeshAxes((1, 2, 1, 1))
    other = ST.init_model(tcfg, axes, device="cpu")
    full, _ = ckpt.restore(path, convert.jax_structs(other))
    for rank in range(axes.world):
        convert.load_params_from_jax(other, full, rank=rank)
        for n, p in other.named_parameters():
            assert torch.equal(p, M.shard(params[n].detach(), axes,
                                          param_spec(n), rank)), (rank, n)


def test_gpt_decay_set_matches_jax(trees):
    """Weight decay on the JAX paths: the embedding and the untied head
    decay; the layers' leaves (tag "pos") and final_norm's g and b do
    not."""
    _, tcfg = _cfgs(GPT)
    flat, _ = jax.tree_util.tree_flatten_with_path(trees[GPT])
    jax_decay = {"/".join(str(k.key) for k in path) for path, _ in flat
                 if not JOPT._no_decay(path)}
    model = convert.params_from_jax(trees[GPT], tcfg, "cpu")
    exempt = ST.no_decay_names(model)
    port_decay = {convert.jax_path(n, tcfg)
                  for n, _ in model.named_parameters() if n not in exempt}
    assert port_decay == jax_decay == {"embed", "lm_head"}


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
