"""The port's overlapped schedule (``core/overlap.py``: the z rings of the
collective matmuls, the x/y activation all-reduce rings, the embedding's
ring gather and the seq ring of ``seq_attn``) held against the JAX
package's overlapped step and against the port's own blocking schedule on
the CPU.

One ``torch.distributed.run --nproc-per-node 8`` launch of this file's
``__main__`` runs eight gloo ranks; within that world each rank runs four
meshes in turn, the reduced ``qwen3-1.7b`` on each: ``p2`` (1,2,2,2),
every ring of two ranks (the exchange fast path); ``z4`` (1,2,1,4), a z
ring of four; ``x4`` (1,4,2,1), the x all-reduce as a reduce-scatter ring
and an all-gather ring of four; ``seq4`` (1,1,1,2,4), a seq ring of four
beside a z ring of two. While the ranks run, the JAX package computes its
overlapped step on the same mesh shapes in this process (8 forced host
devices; on ``seq4`` with ``ring_attention`` off, as the reference's ring
``seq_attn`` fails in this environment, ROADMAP.md §3) and the one-device
gradient. On the CPU the port's wrappers run their kernels' plain
versions.

Held on each mesh: the loss and every gradient block of one microbatch
under ``OverlapConfig.all_on()`` against JAX's overlapped step and the
port's blocking step (rtol 2e-5, atol 1e-5, ``tests/test_overlap.py``'s
tolerance) and against the one-device gradient; the same with z_chunks /
ar_chunks of 2 and 3 (rounded down by ``effective_chunks``) and the
weight-gather cache; a 3-step trajectory against both; ``OverlapConfig()``
and all-off knobs bitwise the blocking schedule; the ring collectives, the
embedding's ring gather and the p == 2 exchange bitwise their blocking
counterparts; the ring ``seq_attn`` against the blocking one and
``attn_core``; the hops and blocking calls of a step by axis against
``chip_smoke.mesh_train_hops``; the seq replicas bitwise equal. Apart
from that launch, ``serve.py --overlap`` on four ranks of (1,2,1,2) in
both modes serves the one-rank run's ids.
"""
import dataclasses
import json
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
from repro.core.compat import shard_map
from repro.core.overlap import OverlapConfig as JaxOverlapConfig
from repro.core.partition import spec_tree_to_pspecs
from repro.core.partition import z_reduce_grads as jax_z_reduce_grads
from repro.launch import steps as JST
from repro.models import decoder as JD
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.core import parallel as PP
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import param_spec
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attn_core
from repro_torch.launch import steps as ST
from repro_torch.layers import attention as A
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_mesh_train as MT  # noqa: E402

sys.path.insert(0, str(MT.ROOT))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCH = MT.ARCH
WORLD = MT.WORLD
# name -> (mesh sizes, the chunked schedule's (z_chunks, ar_chunks,
# cache_weight_gather))
MESHES = {"p2": ((1, 2, 2, 2), (2, 3, False)),
          "z4": ((1, 2, 1, 4), (3, 2, True)),
          "x4": ((1, 4, 2, 1), (2, 3, False)),
          "seq4": ((1, 1, 1, 2, 4), (2, 2, False))}
ON = OverlapConfig.all_on()
RTOL, ATOL = 2e-5, 1e-5     # tests/test_overlap.py's, float32
GRAD_REL = MT.GRAD_REL      # against the one-device gradient
OPT_CFG = MT.OPT_CFG
JAX_THREADS = 4
SEQ_CASE = dict(B=2, T=32, nq=4, nkv=2, hd=16)
SEQ_WINDOWS = (0, 8)


def _cfgs(variant="qk"):
    kw = {} if variant == "qk" else {"qk_norm": False}
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _chunked(name):
    zc, ac, cache = MESHES[name][1]
    return OverlapConfig.all_on(z_chunks=zc, ar_chunks=ac,
                                cache_weight_gather=cache)


def _jax_overlap(name):
    """The reference's schedule on ``name``: all on, the seq ring off on
    the seq mesh."""
    ov = JaxOverlapConfig.all_on()
    if len(MESHES[name][0]) == 5:
        ov = dataclasses.replace(ov, ring_attention=False)
    return ov


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _grads(tcfg, axes, tree, batch, rank, ov):
    """The loss and this rank's gradient blocks of one microbatch after
    the step's reductions, under ``ov``."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    tokens, labels = (M.seq_shard(M.batch_shard(batch[k], axes), axes)
                      for k in ("tokens", "labels"))
    with D.overlap_bound(model, ov):
        loss, _ = D.lm_loss(model, tokens, labels, remat=True)
        loss.backward()
    grads = ST.sync_grads({n: p.grad for n, p in model.named_parameters()},
                          axes)
    return float(loss.detach()), {k: g.clone() for k, g in grads.items()}


def _trajectory(tcfg, axes, tree, batch, rank, ov, steps=3):
    """conftest.train_smoke's steps under ``ov``: the metrics of each, the
    parameters' hash, and the first step's calls by axis (all of them, and
    the hops alone)."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(dtype=torch.float32,
                                              overlap=ov))
    out, calls = [], None
    for i in range(steps):
        M.reset_comm()
        out.append({k: float(v) for k, v in step(model, state,
                                                 batch).items()})
        if i == 0:
            calls = ({a: c["calls"] for a, c in M.COMM_AXES.items()},
                     {a: c["calls"] for a, c in M.HOPS.items()})
    return out, ST.param_sha256(model), calls


def _collectives(axes, rank):
    """Each ring collective against its blocking counterpart on every axis
    above one rank: (name, axis, ring result, blocking result, hops,
    blocking calls). Integer values sum exactly in any order."""
    gen = torch.Generator().manual_seed(100 + rank)
    out = []
    for ax in ("x", "y", "z", "seq"):
        p = axes.size(ax)
        if p == 1:
            continue
        v = torch.randn(3, 4 * p, generator=gen)
        exact = torch.randint(-64, 64, (3, 4 * p), generator=gen).float()
        cases = [("all_gather", v, lambda t: M.ring_all_gather(
                      t, axes, ax, dim=1),
                  lambda t: M.all_gather(t, axes, ax, dim=1)),
                 ("all_reduce", exact, lambda t: M.ring_all_reduce(
                     t, axes, ax, dim=1),
                  lambda t: M.psum(t, axes, ax)),
                 ("reduce_scatter", exact, lambda t: M.ring_reduce_scatter(
                     t, axes, ax, dim=1),
                  lambda t: M.psum_scatter(t, axes, ax, dim=1))]
        if p == 2:      # the exchange: any values
            cases.append(("exchange", v, lambda t: M.ring_all_reduce(
                t, axes, ax, dim=1), lambda t: M.psum(t, axes, ax)))
        else:           # out_w % p != 0: the blocking psum
            cases.append(("fallback", v[:, :p + 1],
                          lambda t: M.ring_all_reduce(t, axes, ax, dim=1),
                          lambda t: M.psum(t, axes, ax)))
        for name, t, ring, block in cases:
            M.reset_comm()
            got = ring(t)
            hops = M.HOPS.get(ax, {}).get("calls", 0)
            calls = M.COMM_AXES.get(ax, {}).get("calls", 0) - hops
            out.append((name, ax, got, block(t), hops, calls))
    return out


def _blocking_by_hand(axes, rank):
    """tp_matmul (normal and transposed) and the tied head under
    ``OverlapConfig()``, forward and backward, beside the blocking schedule
    written out from the mesh's collectives and K1: (name, got, want)."""
    gen = torch.Generator().manual_seed(200 + rank)
    out = []
    axes = axes.with_overlap(OverlapConfig())
    for name, in_ax, out_ax, k, n in (("normal", "x", "y", 16, 24),
                                      ("transposed", "y", "x", 16, 24)):
        x = torch.randn(2, 3, k, generator=gen)
        w = torch.randn(k, n, generator=gen)
        dy = torch.randn(2, 3, n * axes.gz, generator=gen)
        wl = w.clone().requires_grad_()
        xl = x.clone().requires_grad_()
        y = PP.tp_matmul(xl, wl, axes, in_ax, out_ax)
        y.backward(dy)
        wf = M.all_gather(w, axes, "z", dim=1)
        want_y = M.psum(ops.matmul(x.reshape(-1, k), wf).reshape(2, 3, -1),
                        axes, in_ax)
        want_dx = M.psum(ops.matmul(dy.reshape(-1, dy.shape[-1]), wf.t()
                                    ).reshape(2, 3, k), axes, out_ax)
        want_dw = M.psum_scatter(ops.matmul(
            x.reshape(-1, k).t(), dy.reshape(-1, dy.shape[-1]),
            out_dtype=torch.float32), axes, "z", dim=1)
        out += [(f"{name} y", y.detach(), want_y),
                (f"{name} dx", xl.grad, want_dx),
                (f"{name} dw", wl.grad, want_dw)]
    d = 8 * axes.gz
    h = torch.randn(2, 3, d, generator=gen).requires_grad_()
    table = torch.randn(40, 8, generator=gen).requires_grad_()
    dlg = torch.randn(2, 3, 40, generator=gen)
    logits = PP.tied_lm_logits(h, table, axes)
    logits.backward(dlg)
    tf = M.all_gather(table.detach(), axes, "z", dim=1)
    hd = h.detach()
    want_l = M.psum(ops.matmul(hd.reshape(-1, d), tf.t()).reshape(2, 3, 40),
                    axes, "x")
    want_dh = M.psum(ops.matmul(dlg.reshape(-1, 40), tf).reshape(2, 3, d),
                     axes, "y")
    want_dt = M.psum_scatter(ops.matmul(dlg.reshape(-1, 40).t(),
                                        hd.reshape(-1, d),
                                        out_dtype=torch.float32), axes, "z",
                             dim=1)
    return out + [("tied logits", logits.detach(), want_l),
                  ("tied dh", h.grad, want_dh),
                  ("tied dtable", table.grad, want_dt)]


def _embedding(axes, tree, tcfg, batch, rank):
    """The embedding's output and table gradient with its table gathered
    by the ring and by the blocking all-gather."""
    out = []
    for ov in (OverlapConfig(embed_gather=True), OverlapConfig()):
        model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
        tokens = M.seq_shard(M.batch_shard(batch["tokens"], axes), axes)
        emb = PP.embedding_lookup(tokens, model.embed, axes.with_overlap(ov))
        emb.backward(torch.ones_like(emb))
        out.append((emb.detach(), model.embed.grad.clone()))
    return out


def _seq_attention(axes, rank):
    """Ring and blocking ``seq_attn`` on this rank's stripe of global q, k,
    v, and ``attn_core`` on the whole unstriped sequence: outputs and the
    gradients of q, k, v (this rank's stripe of the global gradients)."""
    c = SEQ_CASE
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(c["B"], c["T"], c["nq"], c["hd"], generator=gen)
    k, v = (torch.randn(c["B"], c["T"], c["nkv"], c["hd"], generator=gen)
            for _ in range(2))
    dout = torch.randn(q.shape, generator=gen)
    p = axes.gseq
    res = {}
    for window in SEQ_WINDOWS:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = attn_core(*leaves, causal=True, window=window)
        ref.backward(dout)
        mine = {"attn_core": (M.seq_shard(M.stripe_seq(ref.detach(), p),
                                          axes),
                              *(M.seq_shard(M.stripe_seq(t.grad, p), axes)
                                for t in leaves))}
        for name, ov in (("ring", OverlapConfig(ring_attention=True)),
                         ("blocking", OverlapConfig())):
            ls = [M.seq_shard(M.stripe_seq(t, p), axes).clone()
                  .requires_grad_() for t in (q, k, v)]
            o = A.seq_attn(*ls, axes.with_overlap(ov), window=window)
            o.backward(M.seq_shard(M.stripe_seq(dout, p), axes))
            mine[name] = (o.detach(), *(t.grad for t in ls))
        res[window] = mine
    return res


def _worker_mesh(name, axes, outdir):
    rank = M.process_rank()
    trees = {v: MT._load_tree(outdir / f"{name}-{v}.npz")
             for v in ("qk", "noqk")}
    _, tcfg = _cfgs()
    _, ncfg = _cfgs("noqk")
    inp = MT._inputs(tcfg.vocab_size)
    batch = MT._torch_batch(inp["loss"], axes)
    traj = MT._torch_batch(inp["traj"], axes)
    out = {"grads": {}, "traj": {}}
    for key, ov in (("on", ON), ("chunked", _chunked(name)),
                    ("blocking", OverlapConfig())):
        out["grads"][key] = _grads(tcfg, axes, trees["qk"], batch, rank, ov)
    # all-off knobs and the blocking schedule: the same step
    for key, ov in (("on", ON), ("blocking", OverlapConfig()),
                    ("knobs", OverlapConfig(z_chunks=3, ar_chunks=2))):
        out["traj"][key] = _trajectory(ncfg, axes, trees["noqk"], traj, rank,
                                       ov)
    out["collectives"] = _collectives(axes, rank)
    out["by_hand"] = _blocking_by_hand(axes, rank)
    out["embedding"] = _embedding(axes, trees["qk"], tcfg, batch, rank)
    if axes.gseq > 1:
        out["seq_attn"] = _seq_attention(axes, rank)
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

def _jax_grads(jcfg, sizes, tree, tokens, labels, ov):
    """JAX's loss and every device's gradient blocks after the step's
    reductions under the overlap ``ov``, stacked (world, ...) in the
    port's rank order (``test_torch_mesh_train._jax_grads`` with the
    schedule bound on the axes, as ``make_train_step`` binds it)."""
    mesh, axes = MT._jax_mesh(sizes)
    axes = axes.with_overlap(ov)
    names = MT.NAMES[:len(sizes)]
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


def _jax_trajectory(jcfg, sizes, tree, batch, ov, steps=3):
    """conftest.train_smoke's step under the overlap ``ov``: (loss,
    grad_norm) per step."""
    mesh, axes = MT._jax_mesh(sizes)
    _, specs = JST.init_model(jcfg, axes, abstract=True, dtype=jnp.float32)
    params = JST.device_put_tree(mesh, jax.tree.map(jnp.asarray, tree),
                                 spec_tree_to_pspecs(specs))
    state = JOPT.init_state(params)
    step_fn, _, _ = JST.make_train_step(
        jcfg, mesh, axes, JOPT.AdamWConfig(**OPT_CFG),
        JST.TrainOptions(dtype=jnp.float32, overlap=ov))
    jb = JST.stripe_batch(dict(zip(("tokens", "labels"),
                                   map(jnp.asarray, batch))), axes)
    out = []
    for _ in range(steps):
        params, state, m = step_fn(params, state, jb)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX weights per mesh saved, the 8-rank worker launched; while it
    runs, the JAX package computes its overlapped step on every mesh and
    the one-device gradient. Returns (ranks' results, JAX's results)."""
    outdir = tmp_path_factory.mktemp("overlap_ranks")
    trees = {}
    for name, (sizes, _) in MESHES.items():
        for v in ("qk", "noqk"):
            trees[name, v] = MT._init_tree(_cfgs(v)[0], sizes)
            MT._save_tree(trees[name, v], outdir / f"{name}-{v}.npz")
    proc = MT._torchrun([__file__, str(outdir)])
    try:
        jcfg, _ = _cfgs()
        ncfg, tcfg = _cfgs("noqk")
        inp = MT._inputs(tcfg.vocab_size)
        tasks = [("one", MT._jax_grads, (jcfg, (1, 1, 1, 1),
                                         MT._one_device_tree(
                                             trees["p2", "qk"]),
                                         *inp["loss"]))]
        for name, (sizes, _) in MESHES.items():
            ov = _jax_overlap(name)
            tasks += [((name, "grads"), _jax_grads,
                       (jcfg, sizes, trees[name, "qk"], *inp["loss"], ov)),
                      ((name, "traj"), _jax_trajectory,
                       (ncfg, sizes, trees[name, "noqk"], inp["traj"], ov))]
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            done = {key: pool.submit(fn, *args) for key, fn, args in tasks}
            jax_out = {key: f.result() for key, f in done.items()}
    finally:
        MT._wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=str(what))


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(MESHES))
def test_overlapped_gradients_match_jax_overlapped_on_the_same_mesh(
        world, name):
    """One microbatch under ``OverlapConfig.all_on()``: every rank's loss
    and each gradient block after the step's reductions against the block
    of JAX's overlapped step on the same mesh (the qk-norm gains excepted
    at g_y > 1, where the reference keeps only its y rank's heads;
    ROADMAP.md §3). On ``seq4`` JAX runs its seq attention blocking."""
    ranks, jax_out = world
    jloss, jgrads = jax_out[name, "grads"]
    _, tcfg = _cfgs()
    axes = MeshAxes(MESHES[name][0])
    checked = 0
    for r, res in enumerate(ranks):
        loss, grads = res[name]["grads"]["on"]
        _close(loss, jloss, (name, r, "loss"))
        for n, g in grads.items():
            if MT._qk_norm(n) and axes.gy > 1:
                continue
            jg = MT._layer(MT._leaf(jgrads, convert.jax_path(n, tcfg))[r], n)
            assert g.shape == jg.shape, (n, r)
            _close(g.numpy(), jg, (name, n, r))
            checked += 1
    assert checked >= WORLD * 10


@pytest.mark.parametrize("schedule", ["on", "chunked"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_overlapped_gradients_match_the_blocking_step(world, name,
                                                      schedule):
    """Every leaf, qk-norm gains included: the loss and each rank's
    gradient blocks under ``all_on()`` and under the mesh's chunked
    schedule (z_chunks / ar_chunks of 2 and 3, rounded down to a divisor;
    on ``z4`` with the weight-gather cache) against the port's blocking
    step, and against the one-device gradient."""
    ranks, jax_out = world
    _, one = jax_out["one"]
    _, tcfg = _cfgs()
    axes = MeshAxes(MESHES[name][0])
    for r, res in enumerate(ranks):
        loss, grads = res[name]["grads"][schedule]
        bloss, bgrads = res[name]["grads"]["blocking"]
        _close(loss, bloss, (name, r, "loss"))
        assert set(grads) == set(bgrads)
        for n, g in grads.items():
            _close(g.numpy(), bgrads[n].numpy(), (name, schedule, n, r))
            whole = MT._layer(MT._one_device_leaf(
                one, convert.jax_path(n, tcfg)), n)
            jg = MT._block(whole, axes, r, param_spec(n))
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_REL * np.abs(jg).max(), (name, n, r, err)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_overlapped_trajectory_matches_jax_and_the_blocking_step(world,
                                                                  name):
    """Three steps of conftest.train_smoke's settings with qk_norm=False
    under ``all_on()``: every rank's loss and grad_norm against JAX's
    overlapped make_train_step on the same mesh and against the port's
    blocking step, within rtol 2e-5."""
    ranks, jax_out = world
    want = jax_out[name, "traj"]
    assert want[2][0] < want[0][0]
    for r, res in enumerate(ranks):
        got, _, _ = res[name]["traj"]["on"]
        block, _, _ = res[name]["traj"]["blocking"]
        for i, ((jloss, jgn), m, b) in enumerate(zip(want, got, block)):
            for ref in ((jloss, jgn), (b["loss"], b["grad_norm"])):
                assert abs(m["loss"] - ref[0]) <= RTOL * abs(ref[0]), (r, i)
                assert abs(m["grad_norm"] - ref[1]) <= RTOL * ref[1], (r, i)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_all_off_overlap_is_the_blocking_schedule_bit_for_bit(world, name):
    """``OverlapConfig()``: tp_matmul (both layouts) and the tied head,
    forward and backward, bitwise the blocking schedule written out from
    the mesh's collectives and K1; and a 3-step run with the ring knobs
    set but every ring off (z_chunks 3, ar_chunks 2) ends with the
    blocking run's bits, losses and hashes."""
    ranks, _ = world
    for res in ranks:
        for what, got, want in res[name]["by_hand"]:
            assert torch.equal(got, want), (name, what)
        knobs, sha_k, calls_k = res[name]["traj"]["knobs"]
        block, sha_b, calls_b = res[name]["traj"]["blocking"]
        assert knobs == block and sha_k == sha_b
        assert calls_k == calls_b and calls_b[1] == {}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ring_collectives_are_bitwise_their_blocking_counterparts(world,
                                                                   name):
    """On every axis above one rank: ``ring_all_gather`` == ``all_gather``
    (any values), ``ring_all_reduce`` == ``psum`` and
    ``ring_reduce_scatter`` == ``psum_scatter`` on exactly summable values,
    the p == 2 exchange == ``psum`` on any values; a reduced dim that does
    not split over p > 2 falls back to one blocking psum and no hop. A
    ring of p takes p - 1 hops (2 (p - 1) for the all-reduce, 1 for the
    exchange)."""
    ranks, _ = world
    axes = MeshAxes(MESHES[name][0])
    seen = set()
    for res in ranks:
        for what, ax, got, want, hops, calls in res[name]["collectives"]:
            assert torch.equal(got, want), (name, what, ax)
            p = axes.size(ax)
            expect = {"all_gather": p - 1, "reduce_scatter": p - 1,
                      "all_reduce": 1 if p == 2 else 2 * (p - 1),
                      "exchange": 1, "fallback": 0}[what]
            assert (hops, calls) == (expect, int(what == "fallback")), \
                (name, what, ax, hops, calls)
            seen.add((what, ax))
    assert {ax for _, ax in seen} == {a for a in ("x", "y", "z", "seq")
                                      if axes.size(a) > 1}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_embedding_ring_gather_is_bitwise_the_blocking_one(world, name):
    """``embed_gather``: the embedding's output and its table's gradient
    bitwise those of the blocking all-gather."""
    ranks, _ = world
    for res in ranks:
        (ring, dring), (block, dblock) = res[name]["embedding"]
        assert torch.equal(ring, block) and torch.equal(dring, dblock)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_step_hops_and_blocking_calls_are_the_code_count(world, name):
    """The first step's calls on every rank, by axis: the ring hops and the
    blocking calls left equal ``chip_smoke.mesh_train_hops`` at the
    reduced depth (the count phase 13 holds the card's run to), and the
    blocking schedule's equal ``chip_smoke.mesh_train_collectives``
    wherever that count covers the mesh (no seq axis)."""
    ranks, _ = world
    axes = MeshAxes(MESHES[name][0])
    _, ncfg = _cfgs("noqk")
    hops, blocking = chip_smoke.mesh_train_hops(ncfg, axes, 2)
    for res in ranks:
        _, _, (by_axis, got_hops) = res[name]["traj"]["on"]
        assert got_hops == hops, (name, got_hops, hops)
        rest = {a: c - got_hops.get(a, 0) for a, c in by_axis.items()}
        assert {a: c for a, c in rest.items() if c} == blocking, \
            (name, rest, blocking)
        if axes.gseq == 1:
            _, _, (block_axis, _) = res[name]["traj"]["blocking"]
            assert block_axis == chip_smoke.mesh_train_collectives(
                ncfg, axes, 2)


def test_seq_replicas_end_bitwise_equal(world):
    """After three overlapped steps on ``seq4``, the ranks that differ
    only in their seq coordinate hold bitwise-equal parameters, and the
    two z blocks differ."""
    ranks, _ = world
    axes = MeshAxes(MESHES["seq4"][0])
    groups = {}
    for r in range(WORLD):
        groups.setdefault(axes.coords(r)[1:4], set()).add(
            ranks[r]["seq4"]["traj"]["on"][1])
    assert len(groups) == 2 and all(len(s) == 1 for s in groups.values())
    assert len(set.union(*groups.values())) == 2


@pytest.mark.parametrize("window", SEQ_WINDOWS)
def test_ring_seq_attn_matches_blocking_and_attn_core(world, window):
    """The ring ``seq_attn`` on ``seq4`` (p = 4): each rank's output and
    the gradients of its stripe of q, k and v against the blocking
    ``seq_attn`` and against ``attn_core`` on the whole unstriped
    sequence, causal and windowed, within rtol 2e-5 / atol 1e-5."""
    ranks, _ = world
    for r, res in enumerate(ranks):
        case = res["seq4"]["seq_attn"][window]
        for ref in ("blocking", "attn_core"):
            for what, got, want in zip(("out", "dq", "dk", "dv"),
                                       case["ring"], case[ref]):
                _close(got.numpy(), want.numpy(), (r, ref, what))


SERVE_FLAGS = {
    "continuous": ["--arch", ARCH, "--device", "cpu", "--requests", "6",
                   "--prompt-len", "8", "--gen", "4", "--slots", "4",
                   "--page-size", "4", "--pages", "16", "--chunk", "4"],
    "fixed": ["--arch", ARCH, "--device", "cpu", "--mode", "fixed",
              "--batch", "4", "--prompt-len", "8", "--gen", "4"]}


@pytest.mark.parametrize("mode", sorted(SERVE_FLAGS))
def test_serve_cli_with_overlap_on_the_mesh(mode):
    """``serve.py --mesh 1,2,1,2 --overlap --z-chunks 2 --ar-chunks 2`` on
    four ranks (z rings of the weights, x all-reduce rings): the one-rank
    run's greedy ids, ring hops over x and z on every rank."""
    flags = SERVE_FLAGS[mode]
    proc = MT._torchrun(["-m", "repro_torch.launch.serve", *flags,
                         "--mesh", "1,2,1,2", "--backend", "gloo",
                         "--overlap", "--z-chunks", "2", "--ar-chunks", "2"],
                        nproc=4)
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(flags)
    if mode == "fixed":
        want = serve.run_fixed(args).ids.tolist()
    else:
        want = [r.generated for r in serve.run_continuous(args)[2]]
    lines = MT._wait(proc).strip().splitlines()
    assert lines[-1] == "SERVE OK"
    rep = json.loads(lines[-2])["serve"]
    assert rep["overlap"] and rep["ids"] == want
    for r in rep["ranks"]:
        hops = r["comm"]["ppermute"]["calls"]
        assert hops > 0 and r["comm_axes"]["x"]["calls"] > 0
        assert r["comm_axes"]["z"]["calls"] > 0


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
