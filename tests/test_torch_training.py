"""The port's training slice held against the JAX package on the CPU.

Each autograd Function of ``repro_torch.core.parallel`` against the JAX
``custom_vjp`` it ports (outputs and cotangents), ``lm_loss`` and every
parameter's gradient, and a 3-step trajectory of the train step. The JAX
side runs inside ``shard_map`` on a (1, 1, 1, 1) smoke mesh, as the JAX
tests run it; weights cross with ``convert.params_from_jax`` and inputs
are made with numpy from a seed. The port runs its kernels' plain versions
on the CPU. Tolerances are float32 ones; each differs from 0 only because
the two frameworks sum in another order.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core import parallel as JPP
from repro.core.compat import shard_map
from repro.core.partition import spec_tree_to_pspecs
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.layers import attention as jattn
from repro.models import decoder as JD
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import parallel as PP
from repro_torch.core.mesh import MeshAxes
from repro_torch.launch import steps as ST
from repro_torch.layers import attention as A
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCH = "qwen3-1.7b"
VARIANTS = {"reduced": {}, "gqa": {"n_kv_heads": 2}}
FN_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5          # lm_loss, relative
GRAD_REL = 1e-4           # per leaf: max|dg| <= GRAD_REL * max|g_leaf|
TRAJ_RTOL = 1e-4          # loss and grad_norm at each step, relative


@pytest.fixture(scope="module")
def jax_mesh():
    mesh = LM.make_smoke_mesh((1, 1, 1, 1))
    return mesh, LM.bind_4d(mesh)


# ---------------------------------------------------------------------- #
# each autograd Function against the JAX custom_vjp
# ---------------------------------------------------------------------- #

def _jax_vjp(jax_mesh, fn, primals, ct):
    """fn(axes, *primals) and its cotangents for ``ct``, under shard_map
    on the smoke mesh with every array replicated."""
    mesh, axes = jax_mesh

    def step(ct, *xs):
        out, pull = jax.vjp(lambda *a: fn(axes, *a), *xs)
        return out, pull(ct)
    n = len(primals)
    f = shard_map(step, mesh=mesh, in_specs=(P(),) * (n + 1),
                  out_specs=(P(), (P(),) * n), check_vma=False)
    out, grads = jax.jit(f)(jnp.asarray(ct), *map(jnp.asarray, primals))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_vjp(fn, primals, ct):
    ts = [torch.from_numpy(p).requires_grad_() for p in primals]
    out = fn(MeshAxes(), *ts)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _fn_case(name, rng):
    """(port fn, JAX fn, primals, cotangent) of one Function."""
    B, S, d, n, V = 2, 5, 24, 40, 48
    f32 = np.float32
    toks = rng.randint(0, V, (B, S)).astype(np.int32)
    if name in ("tp_matmul", "tp_matmul_t"):
        sh = ("x", "y") if name == "tp_matmul" else ("y", "x")
        return (lambda ax, x, w: PP.tp_matmul(x, w, ax, *sh),
                lambda ax, x, w: JPP.tp_matmul(x, w, ax, *sh),
                [rng.randn(B, S, d).astype(f32),
                 (rng.randn(d, n) / np.sqrt(d)).astype(f32)],
                rng.randn(B, S, n).astype(f32))
    if name == "embedding_lookup":
        return (lambda ax, t: PP.embedding_lookup(torch.from_numpy(toks), t,
                                                  ax),
                lambda ax, t: JPP.embedding_lookup(jnp.asarray(toks), t, ax),
                [rng.randn(V, d).astype(f32)],
                rng.randn(B, S, d).astype(f32))
    if name == "tied_lm_logits":
        return (lambda ax, h, t: PP.tied_lm_logits(h, t, ax),
                lambda ax, h, t: JPP.tied_lm_logits(h, t, ax),
                [rng.randn(B, S, d).astype(f32),
                 (0.1 * rng.randn(V, d)).astype(f32)],
                rng.randn(B, S, V).astype(f32))
    if name == "vocab_parallel_xent":
        # padded vocab: columns past 40 are masked; labels stay below it
        labels = rng.randint(0, 40, (B, S)).astype(np.int32)
        return (lambda ax, lg: PP.vocab_parallel_xent(
                    lg, torch.from_numpy(labels), ax, 40),
                lambda ax, lg: JPP.vocab_parallel_xent(
                    lg, jnp.asarray(labels), ax, 40),
                [(3 * rng.randn(B, S, V)).astype(f32)],
                rng.randn(B, S).astype(f32))
    if name == "rms_norm":
        return (lambda ax, x, g: PP.rms_norm(x, g, ax, d),
                lambda ax, x, g: JPP.rms_norm(x, g, ax, d),
                [rng.randn(B, S, d).astype(f32),
                 (1 + 0.1 * rng.randn(d)).astype(f32)],
                rng.randn(B, S, d).astype(f32))
    if name == "qk_norm":
        # the port's _plain_rms (K3 + rms_norm's backward) against JAX's
        # jnp _plain_rms under autodiff
        return (lambda ax, x, g: A._plain_rms(x, g, ax),
                lambda ax, x, g: jattn._plain_rms(x, g),
                [rng.randn(B, S, 4, 16).astype(f32),
                 (1 + 0.1 * rng.randn(16)).astype(f32)],
                rng.randn(B, S, 4, 16).astype(f32))
    if name == "ar_bwd_identity":
        return (lambda ax, x: PP.ar_bwd_identity(x, ax, "y"),
                lambda ax, x: JPP.ar_bwd_identity(x, ax.y),
                [rng.randn(B, S).astype(f32)], rng.randn(B, S).astype(f32))
    raise KeyError(name)


FUNCTIONS = ["tp_matmul", "tp_matmul_t", "embedding_lookup",
             "tied_lm_logits", "vocab_parallel_xent", "rms_norm", "qk_norm",
             "ar_bwd_identity"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_matches_jax_custom_vjp(name, jax_mesh):
    ours, theirs, primals, ct = _fn_case(name, np.random.RandomState(0))
    out, grads = _torch_vjp(ours, primals, ct)
    jout, jgrads = _jax_vjp(jax_mesh, theirs, primals, ct)
    np.testing.assert_allclose(out, jout, **FN_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, **FN_TOL)


def test_embedding_gradient_sums_repeated_tokens():
    """The table's gradient sums each token's cotangent in fp32: a token
    seen twice gets both rows' cotangents, an unseen row gets exactly 0."""
    table = torch.zeros(6, 3, requires_grad=True)
    toks = torch.tensor([[1, 4, 1]])
    ct = torch.arange(9, dtype=torch.float32).reshape(1, 3, 3)
    PP.embedding_lookup(toks, table, MeshAxes()).backward(ct)
    want = torch.zeros(6, 3)
    want[1] = ct[0, 0] + ct[0, 2]
    want[4] = ct[0, 1]
    assert torch.equal(table.grad, want)


@pytest.mark.parametrize("V,n_tok", [(5, 300), (48, 1000)])
def test_embedding_gradient_sums_in_token_order(V, n_tok, jax_mesh):
    """Tokens repeat many times at a small vocab. The table's gradient
    equals, bitwise, a loop that adds each token's cotangent to its row in
    token order from zero (no order that changes from run to run), and
    matches the JAX custom_vjp's ``.at[].add``."""
    rng = np.random.RandomState(V)
    toks = rng.randint(0, V, (2, n_tok // 2)).astype(np.int32)
    table = rng.randn(V, 24).astype(np.float32)
    ct = rng.randn(2, n_tok // 2, 24).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_()
    PP.embedding_lookup(torch.from_numpy(toks), t, MeshAxes()).backward(
        torch.from_numpy(ct))
    want = torch.zeros(V, 24)
    for tok, row in zip(toks.reshape(-1), torch.from_numpy(ct).reshape(
            -1, 24)):
        want[tok] += row
    assert torch.equal(t.grad, want)
    _, (jgrad,) = _jax_vjp(jax_mesh, lambda ax, tab: JPP.embedding_lookup(
        jnp.asarray(toks), tab, ax), [table], ct)
    np.testing.assert_allclose(t.grad.numpy(), jgrad, **FN_TOL)


def test_segment_sum_drops_nothing_and_handles_no_tokens():
    """Every id's rows in token order, whatever the ids' order; an empty
    index gives zeros."""
    idx = torch.tensor([3, 0, 3, 3, 1, 0])
    rows = torch.arange(18, dtype=torch.float32).reshape(6, 3) / 7
    got = PP.segment_sum(idx, rows, 5)
    want = torch.zeros(5, 3)
    for i, r in zip(idx, rows):
        want[i] += r
    assert torch.equal(got, want)
    assert torch.equal(PP.segment_sum(idx[:0], rows[:0], 2),
                       torch.zeros(2, 3))


# ---------------------------------------------------------------------- #
# lm_loss and every parameter's gradient
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request, jax_mesh):
    """(jax cfg, numpy params, port cfg) with the JAX package's weights."""
    kw = VARIANTS[request.param]
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    params, _ = JST.init_model(jcfg, jax_mesh[1], jax.random.PRNGKey(0),
                               dtype=jnp.float32)
    return jcfg, jax.tree.map(np.asarray, params), tcfg


def _batch(vocab, B=4, S=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, S)).astype(np.int32),
            rng.randint(0, vocab, (B, S)).astype(np.int32))


def _jax_loss_and_grads(jcfg, tree, tokens, labels, jax_mesh, xent_chunks):
    mesh, axes = jax_mesh

    def step(params, tokens, labels):
        def f(p):
            return JD.lm_loss(p, jcfg, axes, tokens, labels, remat=True,
                              xent_chunks=xent_chunks)
        (loss, _), grads = jax.value_and_grad(f, has_aux=True)(params)
        return loss, grads
    specs = jax.tree.map(lambda _: P(), tree)
    f = shard_map(step, mesh=mesh, in_specs=(specs, P(), P()),
                  out_specs=(P(), specs), check_vma=False)
    loss, grads = jax.jit(f)(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(tokens), jnp.asarray(labels))
    return float(loss), jax.tree.map(np.asarray, grads)


def _jax_leaf(tree, path: str, name: str):
    """The JAX leaf a port parameter comes from (layer i of a stack)."""
    leaf = tree
    for k in path.split("/"):
        leaf = leaf[k]
    return leaf[int(name.split(".")[1])] if name.startswith("layers.") \
        else leaf


@pytest.mark.parametrize("xent_chunks", [1, 4])
def test_lm_loss_and_every_gradient_match_jax(models, jax_mesh,
                                              xent_chunks):
    jcfg, tree, tcfg = models
    tokens, labels = _batch(tcfg.vocab_size)
    jloss, jgrads = _jax_loss_and_grads(jcfg, tree, tokens, labels,
                                        jax_mesh, xent_chunks)
    model = convert.params_from_jax(tree, tcfg, "cpu")
    loss, metrics = D.lm_loss(model, torch.from_numpy(tokens),
                              torch.from_numpy(labels), remat=True,
                              xent_chunks=xent_chunks)
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    assert float(metrics["aux"]) == 0.0
    paths = convert.jax_paths(model)
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        jg = _jax_leaf(jgrads, paths[name], name)
        assert g.shape == jg.shape, name
        err = np.abs(g - jg).max()
        assert err <= GRAD_REL * np.abs(jg).max(), (name, err)


def test_remat_changes_no_gradient(models):
    """Rematerialized blocks recompute the same values: with and without
    remat the loss and every gradient agree bitwise."""
    _, tree, tcfg = models
    tokens, labels = map(torch.from_numpy, _batch(tcfg.vocab_size, seed=1))
    grads = []
    for remat in (False, True):
        model = convert.params_from_jax(tree, tcfg, "cpu")
        loss, _ = D.lm_loss(model, tokens, labels, remat=remat)
        loss.backward()
        grads.append([float(loss.detach())]
                     + [p.grad for p in model.parameters()])
    assert grads[0][0] == grads[1][0]
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1:], grads[1][1:]))


# ---------------------------------------------------------------------- #
# the train step: a 3-step trajectory and the decay set
# ---------------------------------------------------------------------- #

OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=50)


def _jax_trajectory(jcfg, tree, batch, jax_mesh, steps, **topts):
    """conftest.train_smoke's step on the smoke mesh: (loss, grad_norm)
    per step; ``topts``: more TrainOptions (remat_policy)."""
    mesh, axes = jax_mesh
    _, specs = JST.init_model(jcfg, axes, abstract=True, dtype=jnp.float32)
    params = JST.device_put_tree(mesh, jax.tree.map(jnp.asarray, tree),
                                 spec_tree_to_pspecs(specs))
    state = JOPT.init_state(params)
    step_fn, _, _ = JST.make_train_step(
        jcfg, mesh, axes, JOPT.AdamWConfig(**OPT_CFG),
        JST.TrainOptions(overdecompose=2, dtype=jnp.float32, **topts))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        params, state, m = step_fn(params, state, jb)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def test_three_step_trajectory_matches_make_train_step(models, jax_mesh):
    """The batch of conftest.train_smoke (B 8, S 32, overdecompose 2,
    lr 1e-3, warmup 1, f32): loss and grad_norm at each of 3 steps."""
    jcfg, tree, tcfg = models
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, tcfg.vocab_size, (8, 32)
                                   ).astype(np.int32),
             "labels": rng.randint(0, tcfg.vocab_size, (8, 32)
                                   ).astype(np.int32)}
    want = _jax_trajectory(jcfg, tree, batch, jax_mesh, 3)
    model = convert.params_from_jax(tree, tcfg, "cpu")
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(overdecompose=2,
                                              dtype=torch.float32))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i, (jloss, jgn) in enumerate(want):
        m = step(model, state, tb)
        assert abs(float(m["loss"]) - jloss) <= TRAJ_RTOL * abs(jloss), i
        assert abs(float(m["grad_norm"]) - jgn) <= TRAJ_RTOL * jgn, i
        assert m["lr"] == pytest.approx(float(JOPT.lr_at(
            JOPT.AdamWConfig(**OPT_CFG), i)), rel=1e-7)
    assert want[2][0] < want[0][0]
    assert state["step"] == 3


def test_remat_dots_is_full_bitwise_and_matches_jax_dots(models, jax_mesh,
                                                         monkeypatch):
    """Remat policy "dots" keeps each K1 product of a block's forward for
    its recompute: the loss and every gradient are bitwise "full"'s, with
    7 of the 28 products a layer fewer; its 3-step trajectory matches the
    JAX step's under "dots" (``dots_with_no_batch_dims_saveable``) within
    the trajectory bounds."""
    from repro_torch.kernels import ops
    _, tree, tcfg = models
    tokens, labels = map(torch.from_numpy, _batch(tcfg.vocab_size, seed=1))
    plain, calls = ops.block_matmul_plain, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)
    monkeypatch.setattr(ops, "block_matmul_plain", counted)
    runs = {}
    for policy in ("full", "dots"):
        model = convert.params_from_jax(tree, tcfg, "cpu")
        calls[0] = 0
        loss, _ = D.lm_loss(model, tokens, labels, remat=True,
                            remat_policy=policy)
        loss.backward()
        runs[policy] = (float(loss.detach()), calls[0],
                        [p.grad for p in model.parameters()])
    (lf, cf, gf), (ld, cd, gd) = runs["full"], runs["dots"]
    assert lf == ld and all(torch.equal(a, b) for a, b in zip(gf, gd))
    L = tcfg.n_layers
    assert (cf, cd) == (28 * L + 3, 21 * L + 3)
    monkeypatch.undo()
    jcfg = models[0]
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, tcfg.vocab_size, (8, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    want = _jax_trajectory(jcfg, tree, batch, jax_mesh, 3,
                           remat_policy="dots")
    model = convert.params_from_jax(tree, tcfg, "cpu")
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(overdecompose=2,
                                              dtype=torch.float32,
                                              remat_policy="dots"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i, (jloss, jgn) in enumerate(want):
        m = step(model, state, tb)
        assert abs(float(m["loss"]) - jloss) <= TRAJ_RTOL * abs(jloss), i
        assert abs(float(m["grad_norm"]) - jgn) <= TRAJ_RTOL * jgn, i


def test_decay_set_matches_jax(models):
    """Weight decay is decided on the JAX path of each parameter: every
    layer leaf lives under segments/seg0/pos0/, which the JAX rule exempts
    through its tag "pos", so only the embedding decays."""
    _, tree, tcfg = models
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    jax_decay = {"/".join(str(k.key) for k in path) for path, _ in flat
                 if not JOPT._no_decay(path)}
    model = convert.params_from_jax(tree, tcfg, "cpu")
    exempt = ST.no_decay_names(model)
    port_decay = {convert.jax_path(n, model.cfg)
                  for n, _ in model.named_parameters()
                  if n not in exempt}
    assert port_decay == jax_decay == {"embed"}


def test_bf16_step_accumulates_in_fp32(models):
    """In bfloat16 the microbatch gradients sum in a separate fp32
    accumulator; the step runs and gives finite metrics."""
    _, tree, tcfg = models
    model = convert.params_from_jax(tree, tcfg, "cpu").to(torch.bfloat16)
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(overdecompose=2,
                                              dtype=torch.bfloat16))
    toks, labels = map(torch.from_numpy, _batch(tcfg.vocab_size))
    m = step(model, state, {"tokens": toks, "labels": labels})
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert all(p.grad is None for p in model.parameters())
    assert all(s["master"].dtype == torch.float32
               for s in state["opt"].values())
