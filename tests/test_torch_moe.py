"""MoE and the expert axis held against the JAX package on the CPU.

In this process, on seeded numpy inputs:
  * the router's bookkeeping: ``topk_gates`` (softmax and sigmoid scores)
    and ``aux_losses`` against the reference's ``_topk_gates`` and
    ``_aux_losses``; the capacity dispatch (``slot``, ``owner``,
    ``filled`` and the gate of each place) bitwise against the reference's
    construction (``tests/test_expert_parallel.py``'s verbatim
    ``_dispatch``), with queues that overflow and drop;
  * the ``MoE`` layer against ``moe_apply`` on one device: output, aux
    loss and every gradient, DeepSeek's (shared experts, top-2 of 4) and
    Jamba's (no shared expert) reduced configs, the weights carried
    across;
  * ``partition.expert_reduce_grads`` spec-aware, as the reference's
    ``test_expert_reduce_grads_is_spec_aware`` pins it;
  * ``comm_layers`` of DeepSeek-V2-Lite and Jamba, field by field;
  * ``jamba-v0.1-52b`` reduced with its experts (4 top-2 in layers 1, 3,
    5 and 7): fixed-batch prefill and greedy decode against the
    reference's ``make_prefill_step``/``make_decode_step``, logits within
    ``tests/test_torch_hybrid.py``'s tolerance (rtol = atol = 1e-4) and
    every greedy id equal; at decode each expert holds the reference's
    floor of 4 places.

One ``torch.distributed.run --nproc-per-node 4`` launch of this file's
``__main__`` runs four gloo ranks: ``tp_batched_matmul`` (the expert
bank's up and down projections) on (1,2,1,2) under the blocking schedule
and each of the batched rings (``OverlapConfig.batched_matmul``, the
z rings; ``all_reduce``, the x rings), forward and backward, held to the
reference's ``tp_batched_matmul`` on the same mesh of forced host
devices, which JAX computes while the ranks run; then
``collective_matmul.ring_a2a_expert`` against the blocking round trip
``collective_matmul.a2a_expert`` on the expert axis (1,1,1,1,1,4),
forward and backward, bitwise.

Tolerances: the layer's output and the batched matmul in float32 are
those of ``tests/test_torch_training.py`` (rtol = atol = 1e-5: the
frameworks sum in other orders), its weight gradients
``tests/test_torch_mesh_train.py``'s per leaf (max |dg| <= 1e-4 max |g|);
the router's gates within 2 ulp (XLA's CPU ``exp``
and PyTorch's differ in the last bit, so the same logits give gates a
rounding apart; the routed experts and every dispatch index are equal),
the aux loss within rtol 1e-6 (its means over tokens sum in other
orders).
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

from repro.configs import get_config as jax_get_config
from repro.core import mesh as JM
from repro.core import parallel as JPP
from repro.core.compat import shard_map
from repro.core.overlap import OverlapConfig as JOverlapConfig
from repro.core.partition import ParamSpec, unbox
from repro.core.partition import expert_reduce_grads as jax_expert_reduce
from repro.launch import steps as ST_J
from repro.layers import moe as JMOE
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import collective_matmul as CMM
from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core import partition as PT
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.layers import moe as MOE

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_expert_parallel as JEP  # noqa: E402
import test_torch_hybrid as TH  # noqa: E402
import test_torch_mesh_train as MT  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DSV2, JAMBA = "deepseek-v2-lite-16b", "jamba-v0.1-52b"
WORLD = 4
BMM_MESH = (1, 2, 1, 2)             # x 2 (the activation all-reduces), z 2
A2A_MESH = (1, 1, 1, 1, 1, 4)       # the expert axis alone, 3 shifts
# the batched schedules: blocking, the z rings, the x rings, both
SCHEDULES = {
    "blocking": {},
    "z_rings": dict(batched_matmul=True),
    "x_rings": dict(all_reduce=True),
    "both": dict(batched_matmul=True, all_reduce=True, z_chunks=2)}
FN_TOL = dict(rtol=1e-5, atol=1e-5)   # test_torch_training.py, float32
GATE_TOL = dict(rtol=2.4e-7, atol=0)  # 2 ulp of float32
AUX_RTOL = 1e-6
GRAD_REL = MT.GRAD_REL                # per leaf, test_torch_mesh_train.py
E, C, D, F = 4, 6, 16, 24           # the batched matmul's shapes


# ---------------------------------------------------------------------- #
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------- #

def _bmm_inputs():
    rng = np.random.RandomState(11)
    f32 = np.float32
    return dict(x=rng.randn(E, C, D).astype(f32),
                w_up=(rng.randn(E, D, F) / 4).astype(f32),
                dy_up=rng.randn(E, C, F).astype(f32),
                h=rng.randn(E, C, F).astype(f32),
                w_down=(rng.randn(E, F, D) / 5).astype(f32),
                dy_down=rng.randn(E, C, D).astype(f32))


# (in_shard, out_shard, x, w, dy) of each projection, and the specs of x,
# w and dy on the mesh (the bank's E over y, of size 1 here)
PROJ = {"up": ("x", None, "x", "w_up", "dy_up",
               (None, None, "x"), (None, "x", "z"), (None, None, None)),
        "down": (None, "x", "h", "w_down", "dy_down",
                 (None, None, None), (None, None, ("x", "z")),
                 (None, None, "x"))}


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _port_bmm(axes, inputs, proj, ov):
    """This rank's (y, dx, dw) blocks of the port's tp_batched_matmul."""
    in_s, out_s, xn, wn, dyn, xs, ws, ys = PROJ[proj]
    x = M.shard(torch.from_numpy(inputs[xn]), axes, xs).clone()
    w = M.shard(torch.from_numpy(inputs[wn]), axes, ws).clone()
    x.requires_grad_()
    w.requires_grad_()
    y = PP.tp_batched_matmul(x, w, axes.with_overlap(OverlapConfig(**ov)),
                             in_s, out_s)
    y.backward(M.shard(torch.from_numpy(inputs[dyn]), axes, ys).clone())
    return [t.detach().clone() for t in (y, x.grad, w.grad)]


def _port_a2a(axes, rank):
    """ring_a2a_expert and the blocking a2a_expert on the same rank inputs
    (a tp_batched_matmul FFN over this rank's experts): out, d buf, d w."""
    gen = torch.Generator().manual_seed(100 + rank)
    p, e_local, cap, d = axes.gexpert, 2, 3, 8
    buf = torch.randn((p, e_local, cap, d), generator=gen)
    w = torch.randn((e_local, d, d), generator=gen)
    dout = torch.randn((p, e_local, cap, d), generator=gen)
    out = {}
    for name, trip in (("ring", CMM.ring_a2a_expert),
                       ("blocking", CMM.a2a_expert)):
        b, ww = buf.clone().requires_grad_(), w.clone().requires_grad_()
        y = trip(b, axes, "expert",
                 lambda blk: PP.tp_batched_matmul(blk, ww, axes, None, None))
        y.backward(dout)
        out[name] = [t.detach().clone() for t in (y, b.grad, ww.grad)]
    M.reset_comm()
    trip = CMM.ring_a2a_expert(buf, axes, "expert", lambda blk: blk)
    out["hops"] = {k: v["calls"] for k, v in M.COMM.items()}
    out["identity"] = torch.equal(trip, buf)
    return out


def _rank_worker(outdir: pathlib.Path):
    from repro_torch.launch.mesh import close_mesh, init_mesh
    inputs = dict(np.load(outdir / "bmm.npz"))
    out = {}
    try:
        axes = MeshAxes(BMM_MESH)
        init_mesh(axes, device="cpu")
        rank = M.process_rank()
        out["bmm"] = {(proj, name): _port_bmm(axes, inputs, proj, ov)
                      for proj in PROJ for name, ov in SCHEDULES.items()}
        axes = MeshAxes(A2A_MESH)
        M.init_groups(axes)
        out["a2a"] = _port_a2a(axes, rank)
        torch.distributed.barrier()
    finally:
        close_mesh()
    torch.save(out, outdir / f"rank{rank}.pt")


# ---------------------------------------------------------------------- #
# the JAX side
# ---------------------------------------------------------------------- #

def _jax_bmm(inputs, proj, ov):
    """The reference's tp_batched_matmul on BMM_MESH under ``ov``: the
    global y, dx and dw."""
    mesh, axes = MT._jax_mesh(BMM_MESH)
    axes = axes.with_overlap(JOverlapConfig(**ov))
    in_s, out_s, xn, wn, dyn, xs, ws, ys = PROJ[proj]
    x, w, dy = (jnp.asarray(inputs[k]) for k in (xn, wn, dyn))

    def step(x, w, dy):
        y, pull = jax.vjp(lambda a, b: JPP.tp_batched_matmul(
            a, b, axes, in_s, out_s), x, w)
        return (y, *pull(dy))
    f = shard_map(step, mesh=mesh, in_specs=(P(*xs), P(*ws), P(*ys)),
                  out_specs=(P(*ys), P(*xs), P(*ws)), check_vma=False)
    return [np.asarray(t) for t in jax.jit(f)(x, w, dy)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank worker; while it runs, JAX computes the batched matmul
    of each projection under each schedule."""
    outdir = tmp_path_factory.mktemp("moe_ranks")
    inputs = _bmm_inputs()
    np.savez(outdir / "bmm.npz", **inputs)
    proc = MT._torchrun([__file__, str(outdir)], nproc=WORLD)
    try:
        with ThreadPoolExecutor(4) as pool:
            done = {(proj, name): pool.submit(_jax_bmm, inputs, proj, ov)
                    for proj in PROJ for name, ov in SCHEDULES.items()}
            jax_out = {k: f.result() for k, f in done.items()}
    finally:
        MT._wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out


# ---------------------------------------------------------------------- #
# 1. the router's bookkeeping
# ---------------------------------------------------------------------- #

def _mcs(score_fn, n_experts=64, top_k=6):
    ours = dataclasses.replace(get_config(DSV2).moe, n_experts=n_experts,
                               top_k=top_k, score_fn=score_fn)
    theirs = dataclasses.replace(jax_get_config(DSV2).moe,
                                 n_experts=n_experts, top_k=top_k,
                                 score_fn=score_fn)
    return ours, theirs


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("T,n_experts,top_k", [(37, 64, 6), (300, 16, 2),
                                               (64, 4, 2)])
def test_topk_gates_and_aux_losses_match_the_reference(score_fn, T,
                                                       n_experts, top_k):
    logits = (np.random.RandomState(T).randn(T, n_experts) * 2).astype(
        np.float32)
    ours, theirs = _mcs(score_fn, n_experts, top_k)
    gates, idx = MOE.topk_gates(torch.from_numpy(logits), ours)
    jgates, jidx = JMOE._topk_gates(jnp.asarray(logits), theirs)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **GATE_TOL)
    aux = MOE.aux_losses(torch.from_numpy(logits), idx, ours)
    jaux = JMOE._aux_losses(jnp.asarray(logits), jidx, theirs)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


# (n_tok, top_k, E, G_y, y rank, capacity): a block of the experts whose
# queues overflow (capacity below the tokens routed there), and ones
# that fit
DISPATCH = {"overflow y0": (40, 2, 8, 2, 0, 4),
            "overflow y1": (40, 2, 8, 2, 1, 5),
            "fits": (24, 6, 64, 1, 0, 64),
            "floor 4 at decode": (3, 2, 16, 1, 0, 4)}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_indices_are_the_references_bitwise(case):
    """slot's fit, owner, filled and each place's gate equal the
    reference's construction, including the (token, slot) pairs that
    overflow their queue and drop (the highest token indices of it)."""
    n_tok, k, n_exp, gy, yr, cap = DISPATCH[case]
    rng = np.random.RandomState(len(case))
    idx = np.stack([rng.permutation(n_exp)[:k] for _ in range(n_tok)]
                   ).astype(np.int32)
    if case.startswith("overflow"):
        idx[::2, 0] = yr * (n_exp // gy)      # crowd one expert
    gates = rng.rand(n_tok, k).astype(np.float32)
    e_block = n_exp // gy
    slot, owner, filled, dropped = MOE.dispatch_indices(
        torch.from_numpy(idx), yr * e_block, e_block, cap)
    gate_of = MOE.slot_gates(torch.from_numpy(gates), slot, e_block * cap)
    jowner, jfilled, jgate, jfits = JEP._dispatch(
        jnp.asarray(idx - yr * e_block), jnp.asarray(gates), e_block, cap,
        n_tok, k)
    assert np.array_equal(owner.numpy(), np.asarray(jowner))
    assert np.array_equal(filled.numpy(), np.asarray(jfilled))
    assert np.array_equal(gate_of.numpy(), np.asarray(jgate))
    fits = (slot < e_block * cap).numpy()
    assert np.array_equal(fits, np.asarray(jfits))
    local = (idx >= yr * e_block) & (idx < (yr + 1) * e_block)
    assert int(dropped) == int(local.sum() - fits.sum())
    if case.startswith("overflow"):
        assert int(dropped) > 0
    else:
        assert int(dropped) == 0


def test_capacity_is_the_references():
    mc = get_config(DSV2).moe
    assert MOE.capacity_of(mc, 1024) == 120 and MOE.capacity_of(mc, 8) == 4
    jamba = get_config(JAMBA).moe
    assert MOE.capacity_of(jamba, 2048) == 320
    assert MOE.capacity_of(jamba, 4) == 4


# ---------------------------------------------------------------------- #
# 2. the layer against moe_apply on one device
# ---------------------------------------------------------------------- #

def _jax_moe(jcfg, p, h, dout):
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))

    def f(p, h, dout):
        (out, aux), pull = jax.vjp(
            lambda p, h: JMOE.moe_apply(p, h, jcfg, axes), p, h)
        return out, aux, pull((dout, jnp.ones((), jnp.float32)))
    g = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()),
                  out_specs=(P(), P(), P()), check_vma=False)
    out, aux, (dp, dh) = jax.jit(g)(p, h, dout)
    return (np.asarray(out), float(aux), jax.tree.map(np.asarray, dp),
            np.asarray(dh))


@pytest.mark.parametrize("arch", [DSV2, JAMBA])
def test_moe_layer_matches_moe_apply(arch):
    """Output, aux and the gradients of the router, the expert bank, the
    shared expert and the input, the weights carried across; 4 experts
    top-2 of the reduced config, at capacity factor 0.5, where slots
    drop."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.5)) for c in (
        jax_get_config(arch).reduced(), get_config(arch).reduced()))
    _, axes = MT._jax_mesh((1, 1, 1, 1))
    jp, _ = unbox(JMOE.moe_init(jax.random.PRNGKey(3), jcfg, axes,
                                dtype=jnp.float32))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.RandomState(4)
    h = rng.randn(2, 24, jcfg.d_model).astype(np.float32)
    dout = rng.randn(2, 24, jcfg.d_model).astype(np.float32)
    want, jaux, jdp, jdh = _jax_moe(jcfg, jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(h), jnp.asarray(dout))
    layer = MOE.MoE(tcfg, MeshAxes(), gen=torch.Generator())
    flat = convert._flat_tree(tree)
    with torch.no_grad():
        for n, prm in layer.named_parameters():
            prm.copy_(torch.from_numpy(np.asarray(flat[n.replace(".", "/")])))
    ht = torch.from_numpy(h).requires_grad_()
    out, aux = layer(ht)
    (out * torch.from_numpy(dout)).sum().add(aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **FN_TOL)
    np.testing.assert_allclose(float(aux), jaux, rtol=AUX_RTOL)
    np.testing.assert_allclose(ht.grad.numpy(), jdh, **FN_TOL)
    jflat = convert._flat_tree(jdp)
    for n, prm in layer.named_parameters():
        want_g = jflat[n.replace(".", "/")]
        err = np.abs(prm.grad.numpy() - want_g).max()
        assert err <= GRAD_REL * np.abs(want_g).max(), (n, err)
    assert MOE.dropped(layer) > 0


# ---------------------------------------------------------------------- #
# 3. the gradient reductions and the comm model's layers
# ---------------------------------------------------------------------- #

def test_expert_reduce_grads_is_spec_aware():
    """As the reference's test of the same name pins it: the dense
    leaves are summed over the expert axis, the expert bank is not; the
    port's leaf specs and the reference's agree on which is which."""
    axes = MeshAxes((1, 1, 1, 1, 1, 2))
    calls = []
    real = M.psum

    def counted(v, axes, axis):
        calls.append(axis)
        return v + 1.0
    grads = {"layers.1.ffn.w_router": torch.ones(3),
             "layers.1.ffn.w_up": torch.ones(3),
             "layers.1.ffn.w_down": torch.ones(3),
             "layers.1.ffn.shared.wi": torch.ones(3),
             "layers.0.mixer.kv_norm": torch.ones(3)}
    M.psum = counted
    try:
        out = PT.expert_reduce_grads(grads, axes)
    finally:
        M.psum = real
    assert calls == ["expert"] * 3
    for n, g in out.items():
        bank = n.rsplit(".", 1)[-1] in ("w_up", "w_down")
        assert torch.equal(g, torch.full((3,), 1.0 if bank else 2.0)), n
    # the reference, on its own specs of the same leaves
    jaxes = JM.MeshAxes(expert="expert", sizes=(("expert", 2),))
    specs = {n: ParamSpec(P(*PT.param_spec(n)), True) for n in grads}
    synced = []

    def psum_fn(g, ax):
        synced.append(ax)
        return g + 1.0
    jout = jax_expert_reduce({n: jnp.ones(3) for n in grads}, specs, jaxes,
                             psum_fn)
    for n in grads:
        assert np.array_equal(np.asarray(jout[n]), out[n].numpy()), n


@pytest.mark.parametrize("arch", [DSV2, JAMBA])
def test_comm_layers_of_mla_and_moe_match_the_reference(arch):
    """Every LayerShape field by field, the expert markers and a2a_width
    included, at full width and reduced."""
    for small in (False, True):
        ours, theirs = get_config(arch), jax_get_config(arch)
        if small:
            ours, theirs = ours.reduced(), theirs.reduced()
        got, want = ours.comm_layers(), theirs.comm_layers()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(ours.tp_constraints(64)) == \
            dataclasses.asdict(theirs.tp_constraints(64))
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()


def _reference_grads_on(sizes, init, apply, cfg):
    """The reference's gradients of sum(out**2) (+ aux) on the mesh
    ``sizes`` (data, x, y, z), every device's block stacked (world,
    ...), for the parameters ``init`` draws on one device (global) and
    an input replicated over y."""
    from repro.launch import mesh as LM
    mesh, axes = MT._jax_mesh(sizes)
    one = LM.bind_4d(LM.make_smoke_mesh((1, 1, 1, 1), MT.NAMES[:4]))
    p, _ = unbox(init(one, False))
    _, sp = unbox(init(axes, True))
    pspec = jax.tree.map(lambda s: s.spec, sp,
                         is_leaf=lambda s: hasattr(s, "spec"))
    h = jnp.asarray(np.random.RandomState(0).randn(
        2, 8, cfg.d_model).astype(np.float32))

    def f(p, h):
        g = jax.grad(lambda p, h: apply(p, h, axes), argnums=(0, 1))(p, h)
        return jax.tree.map(lambda x: x[None], g)
    names = MT.NAMES[:4]
    g = shard_map(f, mesh=mesh, in_specs=(pspec, P()),
                  out_specs=jax.tree.map(lambda _: P(names), (p, h)),
                  check_vma=False)
    return jax.jit(g)(p, h)


def test_reference_moe_gradients_hold_one_y_rank_of_experts():
    """The reference fault at G_y > 1 that the port does not copy: on
    (1,1,2,1) each y rank's router gradient and input gradient hold only
    its own experts' share (``moe_apply`` psums neither the gates' nor
    the dispatched tokens' gradients over y), more than 10% of max|g|
    off the one-device ones. The port sums both over y
    (``parallel.bwd_psum``; ``tests/test_torch_mla.py`` holds its
    (1,1,2,1,1,2) gradients to one device)."""
    cfg = jax_get_config(DSV2).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))

    def init(axes, abstract):
        return JMOE.moe_init(jax.random.PRNGKey(3), cfg, axes,
                             dtype=jnp.float32, abstract=abstract)

    def apply(p, h, axes):
        out, aux = JMOE.moe_apply(p, h, cfg, axes)
        return jnp.sum(out * out) + aux
    (g1, dh1) = _reference_grads_on((1, 1, 1, 1), init, apply, cfg)
    (g2, dh2) = _reference_grads_on((1, 1, 2, 1), init, apply, cfg)
    r1 = np.asarray(g1["w_router"][0])
    for yr in range(2):
        r = np.asarray(g2["w_router"][yr])
        assert np.abs(r - r1).max() > 0.1 * np.abs(r1).max(), yr
        dh = np.asarray(dh2[yr])
        assert np.abs(dh - dh1[0]).max() > 0.1 * np.abs(dh1[0]).max(), yr


# ---------------------------------------------------------------------- #
# 4. Jamba served with its experts
# ---------------------------------------------------------------------- #

def test_jamba_with_experts_serves_as_the_reference():
    """Prefill of 3 prompts of 10 tokens, then 4 decode steps fed the
    reference's greedy ids: logits within the serving tolerance and the
    port's greedy ids the reference's."""
    jcfg, tcfg = jax_get_config(JAMBA).reduced(), get_config(JAMBA).reduced()
    assert tcfg.ffns().count("moe") == 4
    mesh = MT._jax_mesh((1, 1, 1, 1))
    params, _ = ST_J.init_model(jcfg, mesh[1], jax.random.PRNGKey(2),
                                dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    model = convert.params_from_jax(tree, tcfg, "cpu")
    B, T, GEN = 3, 10, 5
    tokens = np.random.RandomState(6).randint(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    want = TH._jax_fixed(jcfg, mesh, params, tokens, GEN)
    pre_fn, ct = ST.make_prefill_step(tcfg, MeshAxes())(B, T, T + GEN)
    dec_fn, _ = ST.make_decode_step(tcfg, MeshAxes())(B, T + GEN)
    caches = ST.zeros_caches(ct, "cpu")
    logits, caches = pre_fn(model, caches, torch.from_numpy(tokens))
    for i, (jl, _, ids) in enumerate(want):
        np.testing.assert_allclose(logits.numpy(), jl, **TH.LOGIT_TOL,
                                   err_msg=f"step {i}")
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), ids), i
        if i + 1 < GEN:
            logits, caches = dec_fn(model, caches,
                                    torch.from_numpy(ids[:, None]), T + i)


def test_serve_fixed_cli_serves_jamba_with_experts(capsys):
    serve.main(["--arch", JAMBA, "--mode", "fixed", "--device", "cpu",
                "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill 2x6" in out and "SERVE OK" in out


# ---------------------------------------------------------------------- #
# 4. the ranks: the batched matmul and its rings, the expert ring
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("proj", sorted(PROJ))
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_tp_batched_matmul_matches_the_reference_on_the_mesh(world, proj,
                                                            name):
    """Each rank's y, dx and dw blocks against the reference's
    tp_batched_matmul on the same mesh under the same schedule."""
    ranks, jax_out = world
    axes = MeshAxes(BMM_MESH)
    specs = [PROJ[proj][i] for i in (7, 5, 6)]
    for r in range(WORLD):
        for got, want, spec in zip(ranks[r]["bmm"][proj, name],
                                   jax_out[proj, name], specs):
            np.testing.assert_allclose(
                got.numpy(), MT._block(want, axes, r, spec), **FN_TOL,
                err_msg=f"rank {r}")


def test_ring_a2a_expert_is_the_blocking_round_trip_bitwise(world):
    """Out, the buffer's and the weights' gradients of the ring bitwise
    the blocking all-to-all round trip's, on every rank of the expert
    axis of 4 (3 shifts each way); the ring's hops are ppermutes only,
    and with an identity FFN it returns the buffer."""
    ranks, _ = world
    for r in range(WORLD):
        a2a = ranks[r]["a2a"]
        for got, want in zip(a2a["ring"], a2a["blocking"]):
            assert torch.equal(got, want), r
        assert a2a["identity"]
        assert set(a2a["hops"]) == {"ppermute"}
        assert a2a["hops"]["ppermute"] == 2 * (A2A_MESH[-1] - 1)


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
