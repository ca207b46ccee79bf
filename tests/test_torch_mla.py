"""DeepSeek's MLA and the MoE decoder held against the JAX package on the
CPU, and trained on expert meshes.

In this process, on seeded numpy inputs, on ``deepseek-v2-lite-16b``
reduced (d 256, 4 heads; MLA's latent 64, q/k 48 = 32 + 16 rotary, v 32;
layer 0 dense, layer 1 MoE of 4 experts top-2 and one shared expert):
  * ``apply_rope_interleaved_neox`` against the reference's;
  * the ``MLA`` layer's ``"train"`` branch against ``mla_apply``: output
    and every gradient (its serving modes: ``tests/test_torch_mla_serving.
    py``);
  * the model: ``lm_loss``, its aux part and every gradient leaf against
    the reference's on (1,1,1,1), and a 3-step trajectory against the
    reference's train step;
  * ``train.py --calib`` on the reduced config: the predicted step
    bitwise the reference's price of its ``comm_layers``.

One ``torch.distributed.run --nproc-per-node 4`` launch of this file's
``__main__`` trains on expert meshes: (1,1,1,1,1,2) (ranks 2-3 idle) and
(1,1,2,1,1,2) (y and expert both 2), each under the blocking all-to-all
and with ``OverlapConfig(expert_a2a=True, batched_matmul=True)``; then
serves reduced ``deepseek-v2-lite-16b`` and ``deepseek-v3-671b`` (fixed
batch: a prefill of 4 x 8 and 3 decode steps of given tokens) on
(1,2,2,1) and (1,1,2,2), each step's gathered logits held to one
device's (rtol = atol = 1e-4), and takes one V3 step's gradients
(``lm_loss(mtp_weight=0.3)``, the MTP module's among them) on (1,1,2,1),
each rank's blocks held to one device's (``tests/test_torch_mla_serving.
py`` holds one device to the reference). Each
rank's loss and gradient blocks after the step's reductions are held to
the one-device ones, at a capacity factor (2.0) where nothing drops (with
the batch split over the expert axis each source rank has its own
capacity, so where a queue overflows the drops differ from one device's;
the drop count is asserted 0) and without the load-balance term of the
aux loss (a function of the whole batch's routing, which a split batch
computes per shard, in the reference too; the z-loss stays). The ring's
losses and gradients are the blocking run's, bitwise, over 3 steps.

Tolerances: float32, those of ``tests/test_torch_training.py`` and
``tests/test_torch_mesh_train.py`` (the frameworks and the meshes sum in
other orders): outputs rtol = atol = 1e-5, the loss rtol 1e-5, each
gradient leaf max |dg| <= 1e-4 max |g|, the trajectory's loss and grad
norm rtol 1e-4.
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
from repro.core.compat import shard_map
from repro.core.partition import unbox
from repro.layers import attention as JA
from repro.layers import rotary as JR
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.layers import attention as A
from repro_torch.layers import moe as MOE
from repro_torch.layers.rotary import apply_rope_interleaved_neox
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_mesh_train as MT  # noqa: E402
import test_torch_telemetry as TT  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCH = "deepseek-v2-lite-16b"
V3 = "deepseek-v3-671b"
WORLD = 4
MESHES = {"expert": (1, 1, 1, 1, 1, 2), "y_expert": (1, 1, 2, 1, 1, 2)}
SCHEDULES = {"blocking": OverlapConfig(),
             "ring": OverlapConfig(expert_a2a=True, batched_matmul=True)}
NO_DROP = 2.0          # capacity factor: an expert's queue holds every token
SERVE_MESHES = {"x_y": (1, 2, 2, 1), "y_z": (1, 1, 2, 2)}
V3_MESH = (1, 1, 2, 1)
MTP_WEIGHT = 0.3
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
FN_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL, GRAD_REL, TRAJ_RTOL = MT.LOSS_RTOL, MT.GRAD_REL, MT.TRAJ_RTOL


def _cfgs(capacity_factor=None, arch=ARCH):
    """The reduced config on both sides; with ``capacity_factor``, the
    expert meshes' config: that factor, and no load-balance term (its
    product of two means over the tokens is not a mean over the batch
    shards, so a batch split over expert ranks computes another aux than
    one device does; the z-loss, a mean of per-token terms, stays)."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if capacity_factor is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor, aux_loss_coef=0.0))
            for c in (jcfg, tcfg))
    return jcfg, tcfg


def _batches(vocab):
    """The loss batch (B 4, T 16) and the trajectory's (B 8, T 32)."""
    rng = np.random.RandomState(21)
    loss = [rng.randint(0, vocab, (4, 16)).astype(np.int32)
            for _ in range(2)]
    rng = np.random.RandomState(0)
    traj = [rng.randint(0, vocab, (8, 32)).astype(np.int32)
            for _ in range(2)]
    return loss, traj


def _layer(a, name, cfg):
    """A stacked JAX leaf's entry for the port parameter ``name``."""
    return a[cfg.layer_slots()[int(name.split(".")[1])][2]] \
        if name.startswith("layers.") else a


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _mesh_run(tcfg, axes, tree, ov, rank):
    """This rank's loss and gradient blocks after the step's reductions,
    its dropped (token, slot) pairs, then a 3-step trajectory."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    back = convert.params_to_jax(model)          # gathered over the mesh
    same = all(np.array_equal(v, MT._leaf(back, k.replace(".", "/")))
               for k, v in convert._flatten(tree).items())
    loss_b, traj_b = _batches(tcfg.vocab_size)
    batch = MT._torch_batch(loss_b, axes)
    tokens, labels = (M.batch_shard(batch[k], axes)
                      for k in ("tokens", "labels"))
    with D.overlap_bound(model, ov):
        loss, metrics = D.lm_loss(model, tokens, labels, remat=True)
        loss.backward()
    grads = {k: g.clone() for k, g in ST.sync_grads(
        {n: p.grad for n, p in model.named_parameters()}, axes).items()}
    out = dict(loss=float(loss.detach()), aux=float(metrics["aux"]),
               grads=grads, dropped=MOE.dropped(model), to_jax=same)
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**MT.OPT_CFG),
                              ST.TrainOptions(dtype=torch.float32,
                                              overlap=ov))
    tb = MT._torch_batch(traj_b, axes)
    out["traj"] = [{k: float(v) for k, v in step(model, state, tb).items()}
                   for _ in range(3)]
    out["sha"] = ST.param_sha256(model)
    return out


def _fixed_logits(tcfg, axes, tree, rank):
    """Fixed-batch serving of ``_serve_tokens``: a prefill of the first 8
    tokens, then 3 decode steps fed the next ones; each step's logits
    gathered over y and the batch axes (the whole batch's)."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    tokens = torch.from_numpy(_serve_tokens(tcfg.vocab_size))
    (B, L), T = tokens.shape, 8
    pre, ct = ST.make_prefill_step(tcfg, axes)(B, T, L)
    dec, _ = ST.make_decode_step(tcfg, axes)(B, L)
    logits, caches = pre(model, ST.zeros_caches(ct, "cpu"), tokens[:, :T])
    out = [ST.gather_logits(logits, axes)]
    for i in range(T, L):
        logits, caches = dec(model, caches, tokens[:, i:i + 1], i)
        out.append(ST.gather_logits(logits, axes))
    assert MOE.dropped(model) == 0
    return out


def _serve_tokens(vocab):
    return np.random.RandomState(31).randint(0, vocab, (4, 11)).astype(
        np.int32)


def _v3_grads(tcfg, axes, tree, rank):
    """This rank's gradient blocks of one V3 step (``lm_loss`` with its
    MTP term) after the step's reductions."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    tokens, labels = (M.batch_shard(torch.from_numpy(t), axes)
                      for t in _batches(tcfg.vocab_size)[0])
    loss, metrics = D.lm_loss(model, tokens, labels, remat=True,
                              mtp_weight=MTP_WEIGHT)
    loss.backward()
    grads = {k: g.clone() for k, g in ST.sync_grads(
        {n: p.grad for n, p in model.named_parameters()}, axes).items()}
    return dict(loss=float(loss.detach()), mtp=float(metrics["mtp"]),
                grads=grads)


def _rank_worker(outdir: pathlib.Path):
    from repro_torch.launch.mesh import close_mesh, init_mesh
    _, tcfg = _cfgs(NO_DROP)
    _, v3cfg = _cfgs(NO_DROP, V3)
    tree = MT._load_tree(outdir / "tree.npz")
    v3tree = MT._load_tree(outdir / "v3_tree.npz")
    out = {}
    try:
        init_mesh(MeshAxes((1, 1, 1, 1, 1, WORLD)), device="cpu")
        rank = M.process_rank()
        for mesh, sizes in MESHES.items():
            axes = MeshAxes(sizes)
            M.init_groups(axes)
            if rank < axes.world:
                for name, ov in SCHEDULES.items():
                    out[mesh, name] = _mesh_run(tcfg, axes, tree, ov, rank)
            torch.distributed.barrier()
        for mesh, sizes in SERVE_MESHES.items():
            axes = MeshAxes(sizes)
            M.init_groups(axes)
            for arch, cfg, tr in ((ARCH, tcfg, tree), (V3, v3cfg, v3tree)):
                out["serve", mesh, arch] = _fixed_logits(cfg, axes, tr, rank)
            torch.distributed.barrier()
        axes = MeshAxes(V3_MESH)
        M.init_groups(axes)
        if rank < axes.world:
            out["v3"] = _v3_grads(v3cfg, axes, v3tree, rank)
        torch.distributed.barrier()
    finally:
        close_mesh()
    torch.save(out, outdir / f"rank{rank}.pt")


# ---------------------------------------------------------------------- #
# the JAX side and the one-device port
# ---------------------------------------------------------------------- #

def _one_device(tcfg, tree):
    """The port's one-device loss, aux, gradients and drop count on the
    loss batch."""
    model = convert.params_from_jax(tree, tcfg, "cpu")
    tokens, labels = (torch.from_numpy(t) for t in
                      _batches(tcfg.vocab_size)[0])
    loss, metrics = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    return dict(loss=float(loss.detach()), aux=float(metrics["aux"]),
                grads={n: p.grad.clone()
                       for n, p in model.named_parameters()},
                dropped=MOE.dropped(model))


@pytest.fixture(scope="module")
def trees():
    return {cf: MT._init_tree(_cfgs(cf)[0], (1, 1, 1, 1))
            for cf in (None, NO_DROP)}


@pytest.fixture(scope="module")
def world(tmp_path_factory, trees):
    """The 4-rank worker; while it runs, the port's one-device runs (the
    loss and gradients, the served logits, V3's step)."""
    outdir = tmp_path_factory.mktemp("mla_ranks")
    MT._save_tree(trees[NO_DROP], outdir / "tree.npz")
    v3cfg = _cfgs(NO_DROP, V3)
    v3tree = MT._init_tree(v3cfg[0], (1, 1, 1, 1))
    MT._save_tree(v3tree, outdir / "v3_tree.npz")
    proc = MT._torchrun([__file__, str(outdir)], nproc=WORLD)
    try:
        tcfg = _cfgs(NO_DROP)[1]
        one = _one_device(tcfg, trees[NO_DROP])
        one["serve"] = {
            ARCH: _fixed_logits(tcfg, MeshAxes(), trees[NO_DROP], 0),
            V3: _fixed_logits(v3cfg[1], MeshAxes(), v3tree, 0)}
        one["v3"] = _v3_grads(v3cfg[1], MeshAxes(), v3tree, 0)
    finally:
        MT._wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, one


@pytest.fixture(scope="module")
def jax_runs(trees):
    """The reference's one-device loss and gradients, and its trajectory,
    at the config's capacity factor."""
    jcfg, tcfg = _cfgs()
    loss_b, traj_b = _batches(tcfg.vocab_size)
    with ThreadPoolExecutor(2) as pool:
        g = pool.submit(MT._jax_grads, jcfg, (1, 1, 1, 1), trees[None],
                        *loss_b)
        t = pool.submit(MT._jax_trajectory, jcfg, (1, 1, 1, 1), trees[None],
                        traj_b)
        return g.result(), t.result()


# ---------------------------------------------------------------------- #
# 1. rope and the layer
# ---------------------------------------------------------------------- #

def test_neox_rope_matches_the_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 3, 16).astype(np.float32)
    pos = (np.arange(9)[None] + np.array([[0], [40]])).astype(np.int32)
    got = apply_rope_interleaved_neox(torch.from_numpy(x),
                                      torch.from_numpy(pos), 10000.0)
    want = JR.apply_rope_interleaved_neox(jnp.asarray(x), jnp.asarray(pos),
                                          10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def test_mla_train_branch_matches_mla_apply():
    """The layer's output and the gradients of every weight and of its
    input against the reference's mla_apply in mode "train", the weights
    carried across."""
    jcfg, tcfg = _cfgs()
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    jp, _ = unbox(JA.mla_init(jax.random.PRNGKey(7), jcfg, axes,
                              dtype=jnp.float32))
    rng = np.random.RandomState(8)
    h = rng.randn(2, 20, jcfg.d_model).astype(np.float32)
    dout = rng.randn(2, 20, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))

    def f(p, h, dout):
        o, pull = jax.vjp(lambda p, h: JA.mla_apply(
            p, h, jcfg, axes, positions=jnp.asarray(pos), mode="train")[0],
            p, h)
        return o, pull(dout)
    g = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()),
                  out_specs=(P(), P()), check_vma=False)
    want, (jdp, jdh) = jax.jit(g)(jp, jnp.asarray(h), jnp.asarray(dout))
    layer = A.MLA(tcfg, MeshAxes(), gen=torch.Generator())
    with torch.no_grad():
        for n, prm in layer.named_parameters():
            prm.copy_(torch.from_numpy(np.array(jp[n])))
    ht = torch.from_numpy(h).requires_grad_()
    out = layer(ht, positions=torch.from_numpy(pos.copy()), mode="train")
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FN_TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), **FN_TOL)
    for n, prm in layer.named_parameters():
        w = np.asarray(jdp[n])
        err = np.abs(prm.grad.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (n, err)


def test_reference_mla_rope_gradient_holds_one_y_rank_of_heads():
    """The reference fault at G_y > 1 that the port does not copy: every
    head reads the one rotary key, so each y rank back-propagates only
    its own heads' share of it, and ``mla_apply`` psums no gradient over
    y there: on (1,1,2,1) the rotary columns of each y rank's w_dkv
    gradient are more than 10% of their max off the one-device ones,
    while the latent's columns agree. The port sums k_rope's gradient
    over y (``parallel.bwd_psum``)."""
    import test_torch_moe as TM
    jcfg, _ = _cfgs()
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (2, 8))

    def init(axes, abstract):
        return JA.mla_init(jax.random.PRNGKey(3), jcfg, axes,
                           dtype=jnp.float32, abstract=abstract)

    def apply(p, h, axes):
        out, _ = JA.mla_apply(p, h, jcfg, axes, positions=pos,
                              mode="train")
        return jnp.sum(out * out)
    g1, _ = TM._reference_grads_on((1, 1, 1, 1), init, apply, jcfg)
    g2, _ = TM._reference_grads_on((1, 1, 2, 1), init, apply, jcfg)
    kl = jcfg.mla.kv_lora_rank
    w1 = np.asarray(g1["w_dkv"][0])
    for yr in range(2):
        w = np.asarray(g2["w_dkv"][yr])
        latent = np.abs(w[:, :kl] - w1[:, :kl]).max()
        assert latent <= GRAD_REL * np.abs(w1[:, :kl]).max(), yr
        rope = np.abs(w[:, kl:] - w1[:, kl:]).max()
        assert rope > 0.1 * np.abs(w1[:, kl:]).max(), yr


# ---------------------------------------------------------------------- #
# 2. the model against the reference on one device
# ---------------------------------------------------------------------- #

def test_loss_aux_and_every_gradient_match_the_reference(trees, jax_runs):
    jcfg, tcfg = _cfgs()
    (jloss, jgrads), _ = jax_runs
    model = convert.params_from_jax(trees[None], tcfg, "cpu")
    tokens, labels = (torch.from_numpy(t)
                      for t in _batches(tcfg.vocab_size)[0])
    loss, metrics = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert float(metrics["aux"]) > 0
    assert MOE.dropped(model) > 0         # the config's capacity drops
    paths = convert.jax_paths(model)
    checked = 0
    for n, p in model.named_parameters():
        want = _layer(MT._leaf(jgrads, paths[n])[0], n, tcfg)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (n, err)
        checked += 1
    kinds = {n.rsplit(".", 1)[-1] for n, _ in model.named_parameters()}
    assert kinds >= {"w_q", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo",
                     "w_router", "w_up", "w_down", "wi", "wg"}
    assert checked == len(list(model.parameters()))


def test_aux_loss_is_the_references(trees):
    """lm_loss's aux metric: the sum of the MoE layers' aux losses as the
    reference carries it through its layers."""
    jcfg, tcfg = _cfgs()
    from repro.models import decoder as JD
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    tokens, labels = _batches(tcfg.vocab_size)[0]

    def f(p, t, lab):
        return JD.lm_loss(p, jcfg, axes, t, lab, remat=False)[1]["aux"]
    g = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
                  check_vma=False)
    jaux = float(jax.jit(g)(jax.tree.map(jnp.asarray, trees[None]),
                            jnp.asarray(tokens), jnp.asarray(labels)))
    model = convert.params_from_jax(trees[None], tcfg, "cpu")
    _, metrics = D.lm_loss(model, torch.from_numpy(tokens),
                           torch.from_numpy(labels), remat=False)
    np.testing.assert_allclose(float(metrics["aux"]), jaux, rtol=1e-6)


def test_three_step_trajectory_matches_the_reference(trees, jax_runs):
    _, tcfg = _cfgs()
    _, jtraj = jax_runs
    traj_b = _batches(tcfg.vocab_size)[1]
    got, _ = MT._trajectory(tcfg, MeshAxes(), trees[None],
                            MT._torch_batch(traj_b, MeshAxes()), 0)
    for step, (m, (jl, jg)) in enumerate(zip(got, jtraj)):
        np.testing.assert_allclose(m["loss"], jl, rtol=TRAJ_RTOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(m["grad_norm"], jg, rtol=TRAJ_RTOL,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_unrematerialized_bits(trees, policy):
    """Remat "full" and "dots" over the MLA and MoE blocks: the loss and
    every gradient bitwise the run without remat (a block's recompute
    routes and dispatches as its forward did; "dots" replays its 2-D K1
    products and recomputes the batched expert ones)."""
    _, tcfg = _cfgs()
    tokens, labels = (torch.from_numpy(t)
                      for t in _batches(tcfg.vocab_size)[0])
    runs = []
    for remat in (False, True):
        model = convert.params_from_jax(trees[None], tcfg, "cpu")
        loss, _ = D.lm_loss(model, tokens, labels, remat=remat,
                            remat_policy=policy)
        loss.backward()
        runs.append((float(loss), {n: p.grad for n, p in
                                   model.named_parameters()},
                     MOE.dropped(model)))
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2]
    for n, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][n]), n


def test_train_calib_prices_deepseek_as_the_reference(tmp_path):
    """``train.py --calib`` on reduced DeepSeek: the predicted step
    bitwise the reference's price of its comm_layers (MLA's projections,
    the MoE's expert markers and all-to-all width)."""
    prof = tmp_path / "cpu.json"
    TT._profile(prof)
    flags = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
             "--steps", "2", "--batch", "4", "--seq", "16"]
    res = train.main(flags + ["--calib", str(prof)])
    want = TT._reference_prediction(prof, flags)
    assert res.predicted == dict(total=want.total, compute=want.compute,
                                 exposed_comm=want.exposed_comm,
                                 hidden_comm=want.hidden_comm)
    assert all(np.isfinite(res.losses)) and len(res.moe_dropped) == 2


# ---------------------------------------------------------------------- #
# 3. the expert meshes against one device
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_expert_meshes_match_one_device(world, mesh, schedule):
    """Each rank's loss, aux and every gradient block against the
    one-device ones, nothing dropped on either side."""
    ranks, one = world
    axes = MeshAxes(MESHES[mesh])
    assert one["dropped"] == 0
    for r in range(axes.world):
        got = ranks[r][mesh, schedule]
        assert got["dropped"] == 0, r
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["aux"], one["aux"], rtol=LOSS_RTOL)
        for n, g in got["grads"].items():
            want = MT._block(one["grads"][n].numpy(), axes, r,
                             convert.param_spec(n))
            err = np.abs(g.numpy() - want).max()
            assert err <= GRAD_REL * np.abs(want).max(), (mesh, r, n, err)


def test_params_cross_both_ways_on_the_expert_meshes(world, trees):
    """Each rank's blocks, gathered over their specs' axes (the expert
    bank over (y, expert)) into the reference's stacked tree, give back
    the tree they were sliced from, on every rank of both meshes; and on
    one device the structure and PartitionSpecs are the reference's."""
    ranks, _ = world
    for mesh, sizes in MESHES.items():
        for r in range(MeshAxes(sizes).world):
            assert ranks[r][mesh, "blocking"]["to_jax"], (mesh, r)
    jcfg, tcfg = _cfgs()
    model = convert.params_from_jax(trees[None], tcfg, "cpu")
    back = convert._flatten(convert.params_to_jax(model))
    want = convert._flatten(trees[None])
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)
    from repro.launch import steps as JST
    _, jaxes = MT._jax_mesh((1, 1, 1, 1))
    _, jspecs = JST.init_model(jcfg, jaxes, abstract=True,
                               dtype=jnp.float32)
    ours = convert._flatten(convert.jax_specs(model))
    theirs = convert._flatten(jax.tree.map(
        lambda s: s.spec, jspecs, is_leaf=lambda s: hasattr(s, "spec")))
    assert ours.keys() == theirs.keys()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_expert_ring_is_the_blocking_run_bitwise(world, mesh):
    """The ring-decomposed all-to-all with the batched z rings: loss,
    gradients and a 3-step trajectory bitwise the blocking run's, and the
    ranks that hold the same blocks end with the same parameters."""
    ranks, _ = world
    axes = MeshAxes(MESHES[mesh])
    for r in range(axes.world):
        ring, block = ranks[r][mesh, "ring"], ranks[r][mesh, "blocking"]
        assert ring["loss"] == block["loss"]
        assert all(torch.equal(g, block["grads"][n])
                   for n, g in ring["grads"].items())
        assert ring["traj"] == block["traj"]
        assert ring["sha"] == block["sha"]


@pytest.mark.parametrize("mesh", sorted(SERVE_MESHES))
@pytest.mark.parametrize("arch", [ARCH, V3])
def test_fixed_serving_on_meshes_matches_one_device(world, mesh, arch):
    """Every rank's gathered logits of the prefill and each decode step
    against one device's: (1,2,2,1) shards the latent's and the heads'
    projections over x and y, (1,1,2,2) the batch and the weights over z
    (the absorbed decode gathers W_uk and W_uv whole over z)."""
    ranks, one = world
    want = one["serve"][arch]
    for r in range(MeshAxes(SERVE_MESHES[mesh]).world):
        got = ranks[r]["serve", mesh, arch]
        assert len(got) == len(want) == 4
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **SERVE_TOL,
                                       err_msg=f"{mesh} rank {r} {step}")


def test_v3_step_gradient_blocks_on_y_match_one_device(world):
    """One V3 step on (1,1,2,1), its MTP term included: each rank's loss
    and every gradient block (the compressed query's and the MTP
    module's among them) against one device's."""
    ranks, one = world
    axes = MeshAxes(V3_MESH)
    want = one["v3"]
    for r in range(axes.world):
        got = ranks[r]["v3"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["mtp"], want["mtp"], rtol=LOSS_RTOL)
        assert got["grads"].keys() == want["grads"].keys()
        for n, g in got["grads"].items():
            w = MT._block(want["grads"][n].numpy(), axes, r,
                          convert.param_spec(n))
            err = np.abs(g.numpy() - w).max()
            assert err <= GRAD_REL * np.abs(w).max(), (r, n, err)
    assert any(n.endswith("cq_norm") for n in want["grads"])


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
