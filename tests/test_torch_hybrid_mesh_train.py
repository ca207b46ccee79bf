"""Training Jamba's hybrid decoder on the 4D mesh, held to one device on
the CPU.

One ``torch.distributed.run --nproc-per-node 4`` launch of this file's
``__main__`` runs four gloo ranks on the reduced ``jamba-v0.1-52b-dense-
ffn`` (8 layers, d 256: each Mamba layer's inner channels over y): on
(1,2,2,1) and (1,1,2,2) under the blocking schedule, every gradient
block after the step's reductions (B's and C's columns of ``w_x``
summed over y once; the per-channel leaves over z) and 3 train steps; on
(1,2,2,1) under the overlapped schedule, the same blocks and step 1.
While the ranks run, this process computes the port's one-device loss,
gradients and 3-step trajectory on the same weights (the JAX package's,
carried across by ``convert``), which ``tests/test_torch_hybrid_train.py``
holds to ``jax.grad`` and the JAX train step. The ranks run the kernels'
plain versions on the CPU.

Tolerances are those of ``tests/test_torch_mesh_train.py`` (float32: the
mesh sums its blocks in other orders) and, between the schedules, those
of ``tests/test_torch_overlap.py``.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import mesh as M
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.core.partition import param_spec
from repro_torch.launch import steps as ST
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_hybrid_train as HT  # noqa: E402
import test_torch_mesh_train as MT  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

WORLD = 4
MESHES = {"y2x2": (1, 2, 2, 1), "y2z2": (1, 1, 2, 2)}
SCHEDULES = {"blocking": OverlapConfig(), "overlapped": OverlapConfig.all_on()}
LOSS_RTOL = MT.LOSS_RTOL
GRAD_REL = MT.GRAD_REL
TRAJ_RTOL = MT.TRAJ_RTOL
OVERLAP_TOL = dict(rtol=2e-5, atol=1e-5)   # tests/test_torch_overlap.py


_one_thread = HT._one_thread   # torch on one thread here too (autouse)


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _mesh_run(tcfg, axes, tree, ov, rank, steps):
    """Under ``ov``: the loss and this rank's gradient blocks of one
    microbatch after the step's reductions, then ``steps`` train steps'
    metrics."""
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    batch = MT._torch_batch(HT._loss_batch(tcfg.vocab_size), axes)
    tokens, labels = (M.batch_shard(batch[k], axes)
                      for k in ("tokens", "labels"))
    with D.overlap_bound(model, ov):
        loss, _ = D.lm_loss(model, tokens, labels, remat=True)
        loss.backward()
    grads = {k: g.clone() for k, g in ST.sync_grads(
        {n: p.grad for n, p in model.named_parameters()}, axes).items()}
    model = convert.params_from_jax(tree, tcfg, "cpu", axes, rank)
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, axes, OPT.AdamWConfig(**MT.OPT_CFG),
                              ST.TrainOptions(dtype=torch.float32,
                                              overlap=ov))
    batch = MT._torch_batch(HT._traj_batch(tcfg.vocab_size), axes)
    traj = [{k: float(v) for k, v in step(model, state, batch).items()}
            for _ in range(steps)]
    return dict(loss=float(loss.detach()), grads=grads, traj=traj)


def _rank_worker(outdir: pathlib.Path):
    from repro_torch.launch.mesh import close_mesh, init_mesh
    _, tcfg = HT._cfgs(HT.DENSE)
    tree = MT._load_tree(outdir / "dense.npz")
    out = {}
    try:
        for i, (name, sizes) in enumerate(MESHES.items()):
            axes = MeshAxes(sizes)
            if i == 0:
                init_mesh(axes, device="cpu")
            else:
                M.init_groups(axes)
            rank = M.process_rank()
            out[name, "blocking"] = _mesh_run(tcfg, axes, tree,
                                              SCHEDULES["blocking"], rank, 3)
            if name == "y2x2":
                out[name, "overlapped"] = _mesh_run(
                    tcfg, axes, tree, SCHEDULES["overlapped"], rank, 1)
        torch.distributed.barrier()
    finally:
        close_mesh()
    torch.save(out, outdir / f"rank{rank}.pt")


# ---------------------------------------------------------------------- #
# one device, in this process while the ranks run
# ---------------------------------------------------------------------- #

def _one_device(tcfg, tree):
    """The port's one-device loss and gradients of the loss batch, and its
    3-step trajectory."""
    model = convert.params_from_jax(tree, tcfg, "cpu")
    tokens, labels = map(torch.from_numpy, HT._loss_batch(tcfg.vocab_size))
    loss, _ = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    traj, _, _ = HT._three_steps(tcfg, tree)
    return float(loss.detach()), grads, traj


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank worker launched on the JAX package's weights of the
    reduced dense-FFN model; meanwhile the one-device run of the same
    weights. Returns (ranks' results, one device's)."""
    _, tcfg = HT._cfgs(HT.DENSE)
    tree = MT._init_tree(HT._cfgs(HT.DENSE)[0], (1, 1, 1, 1))
    outdir = tmp_path_factory.mktemp("hybrid_mesh_train_ranks")
    MT._save_tree(tree, outdir / "dense.npz")
    proc = MT._torchrun([__file__, str(outdir)], nproc=WORLD)
    try:
        one = _one_device(tcfg, tree)
    finally:
        MT._wait(proc)
    ranks = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, one


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_gradient_blocks_are_the_one_device_gradient(world, name):
    """Every rank's block of every gradient after the step's reductions
    (B's and C's columns of w_x summed over y once; the per-channel leaves
    summed over z) against the same block of the one-device gradient; the
    microbatch's loss equal to one device's."""
    ranks, (loss, grads, _) = world
    axes = MeshAxes(MESHES[name])
    for r in range(WORLD):
        res = ranks[r][name, "blocking"]
        assert abs(res["loss"] - loss) <= LOSS_RTOL * abs(loss), r
        assert "layers.0.mixer.conv_w" in res["grads"]
        for n, g in res["grads"].items():
            want = MT._block(grads[n], axes, r, param_spec(n))
            err = np.abs(g.numpy() - want).max()
            assert err <= GRAD_REL * np.abs(grads[n]).max(), (r, n, err)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_trajectory_matches_one_device(world, name):
    """3 steps on the mesh: each step's loss and grad norm those of the
    one-device trajectory."""
    ranks, (_, _, traj) = world
    for r in range(WORLD):
        for i, (m, one) in enumerate(zip(ranks[r][name, "blocking"]["traj"],
                                         traj)):
            assert abs(m["loss"] - one["loss"]) <= TRAJ_RTOL * abs(
                one["loss"]), (r, i)
            assert abs(m["grad_norm"] - one["grad_norm"]) <= TRAJ_RTOL * \
                one["grad_norm"], (r, i)


def test_overlapped_first_step_matches_the_blocking_one(world):
    """(1,2,2,1) under ``OverlapConfig.all_on()``: the gradient blocks and
    step 1 of the blocking run's."""
    ranks, _ = world
    for r in range(WORLD):
        a, b = ranks[r]["y2x2", "overlapped"], ranks[r]["y2x2", "blocking"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a["traj"][0][k], b["traj"][0][k],
                                       **OVERLAP_TOL, err_msg=k)
        for n, g in a["grads"].items():
            np.testing.assert_allclose(g.numpy(), b["grads"][n].numpy(),
                                       **OVERLAP_TOL, err_msg=n)


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
