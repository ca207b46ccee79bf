"""Training Jamba's hybrid decoder, held against the JAX package on the CPU.

In this process: the Mamba layer's train mode against ``mamba_apply(mode=
"train")`` (its output, the input's and every parameter's gradient); the
scan's autograd Function (``kernels.selective_scan.SelectiveScan``, the
plain forward and backward on the CPU) against autograd of the plain
scan; ``lm_loss`` and every parameter gradient of ``jamba-v0.1-52b-dense-
ffn`` and ``jamba-v0.1-52b`` (its experts) at ``ArchConfig.reduced()`` (8
layers, one period: 7 Mamba and attention at index 4, d 256) against
``jax.grad``, weights carried across by ``convert``; the dense-FFN model's
3-step trajectory against the JAX train step on (1,1,1,1); a checkpoint
of the trained state read back by the reference; the reference's fault
that the port does not copy (each y rank's B and C gradients hold only
its own channels' share); the train CLI on the reference's own example.
The JAX side computes on forced host devices, a few computations at a
time on threads. The port runs its kernels' plain versions on the CPU.
The mesh runs are in ``tests/test_torch_hybrid_mesh_train.py``.

Tolerances are those of ``tests/test_torch_training.py`` and
``tests/test_torch_mesh_train.py`` (float32: the frameworks sum in other
orders; the port's scan is sequential, the reference's an associative
scan over each chunk of 128 steps).
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
from repro.core.compat import shard_map
from repro.core.partition import unbox
from repro.layers import mamba as jmamba
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core.mesh import MeshAxes
from repro_torch.kernels import ops
from repro_torch.kernels.selective_scan import (SelectiveScan,
                                                selective_scan_plain)
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.layers.mamba import Mamba
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_mesh_train as MT  # noqa: E402
import test_torch_moe as TM  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DENSE, MOE = "jamba-v0.1-52b-dense-ffn", "jamba-v0.1-52b"
FN_TOL = dict(rtol=1e-5, atol=1e-5)      # test_torch_training.py, float32
LOSS_RTOL = MT.LOSS_RTOL
GRAD_REL = MT.GRAD_REL
TRAJ_RTOL = MT.TRAJ_RTOL
OPT_CFG = MT.OPT_CFG
JAX_THREADS = 3
CLI = ["--preset", "smoke", "--device", "cpu", "--steps", "2", "--batch",
       "2", "--seq", "32", "--log-every", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread in this process: beside the other test files'
    workers, its default threads only contend for the cores (as
    ``tests/test_torch_zero3.py``'s ``cli_runs`` found)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg(arch):
    """The reference's config of ``arch``: Jamba, or Jamba with its experts
    replaced by the dense MLP (``configs/jamba_v0_1_52b.DENSE_FFN``)."""
    cfg = jax_get_config(MOE)
    if arch == DENSE:
        cfg = dataclasses.replace(cfg, name=DENSE, moe=None)
    return cfg


def _cfgs(arch):
    return _jax_cfg(arch).reduced(), get_config(arch).reduced()


def _loss_batch(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (4, 16)).astype(np.int32)
            for _ in range(2)]


def _traj_batch(vocab):
    """conftest.train_smoke's batch: B 8, S 32."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (8, 32)).astype(np.int32)
            for _ in range(2)]


def _one_device_grad(jgrads, name, cfg):
    """The one-device JAX gradient of the port parameter ``name`` (its
    device dim dropped, a stacked leaf's period taken)."""
    leaf = MT._leaf(jgrads, convert.jax_path(name, cfg))[0]
    return leaf[convert._slot(name, cfg)[2]] if name.startswith(
        "layers.") else leaf


# ---------------------------------------------------------------------- #
# the JAX side
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def trees():
    return {arch: MT._init_tree(_cfgs(arch)[0], (1, 1, 1, 1))
            for arch in (DENSE, MOE)}


@pytest.fixture(scope="module")
def jax_out(trees):
    """JAX's one-device loss and gradients of both archs and the dense-FFN
    model's trajectory, computed a few at a time on threads (most of
    their time is XLA's compiler, which releases the GIL)."""
    tasks = []
    for arch in (DENSE, MOE):
        jcfg, tcfg = _cfgs(arch)
        tasks.append(((arch, "grads"), MT._jax_grads,
                      (jcfg, (1, 1, 1, 1), trees[arch],
                       *_loss_batch(tcfg.vocab_size))))
    jcfg, tcfg = _cfgs(DENSE)
    tasks.append(((DENSE, "traj"), MT._jax_trajectory,
                  (jcfg, (1, 1, 1, 1), trees[DENSE],
                   _traj_batch(tcfg.vocab_size))))
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        done = {key: pool.submit(fn, *args) for key, fn, args in tasks}
        return {key: f.result() for key, f in done.items()}


# ---------------------------------------------------------------------- #
# 1. the scan's Function and the Mamba layer
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("T,with_s0", [(40, False), (7, True)])
def test_scan_function_gradients_are_autograd_of_the_plain_scan(T,
                                                                with_s0):
    """``SelectiveScan`` on CPU tensors (the plain forward, then
    ``selective_scan_bwd_plain``) gives autograd's gradients of the plain
    scan, for cotangents of y and of the final state; B and C as column
    views of one buffer, as the layer passes them."""
    rng = np.random.RandomState(T)
    Bt, d, N = 2, 24, 16
    x, dy = rng.randn(2, Bt, T, d)
    dt = np.log1p(np.exp(rng.randn(Bt, T, d) - 2.0))
    A = -np.exp(0.5 * rng.randn(d, N))
    bc = rng.randn(Bt, T, 3 + 2 * N)
    s0, ds = 0.5 * rng.randn(2, Bt, d, N)

    def leaves():
        xdbc = torch.tensor(bc, dtype=torch.float32, requires_grad=True)
        ts = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
              for v in (x, dt, A)]
        s = (torch.tensor(s0, dtype=torch.float32, requires_grad=True)
             if with_s0 else None)
        return ts, xdbc, s
    got, want = [], []
    for fn, out in ((lambda *a: SelectiveScan.apply(*a, False), got),
                    (selective_scan_plain, want)):
        (tx, tdt, tA), xdbc, s = leaves()
        y, s_fin = fn(tx, tdt, tA, xdbc[..., 3:3 + N], xdbc[..., 3 + N:], s)
        (y * torch.from_numpy(dy).float()).sum().add_(
            (s_fin * torch.from_numpy(ds).float()).sum()).backward()
        out += [y.detach(), s_fin.detach(), tx.grad, tdt.grad, tA.grad,
                xdbc.grad] + ([s.grad] if with_s0 else [])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **FN_TOL,
                                   err_msg=str(i))


def test_mamba_train_matches_mamba_apply():
    """The port's ``Mamba(mode="train")`` against ``mamba_apply(mode=
    "train")`` of the reduced Jamba on one device: the output and the
    gradients of the input and of every parameter for a random cotangent
    (T 40: two of the port's 32-step chunks, one of the reference's)."""
    jcfg, tcfg = _cfgs(DENSE)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    p, _ = unbox(jmamba.mamba_init(jax.random.PRNGKey(4), jcfg, axes,
                                   dtype=jnp.float32))
    p = jax.tree.map(np.asarray, p)
    rng = np.random.RandomState(9)
    h = rng.randn(2, 40, tcfg.d_model).astype(np.float32)
    ct = rng.randn(2, 40, tcfg.d_model).astype(np.float32)

    def step(p, h, ct):
        out, pull = jax.vjp(lambda p, h: jmamba.mamba_apply(
            p, h, jcfg, axes, mode="train")[0], p, h)
        return out, pull(ct)
    specs = {k: P() for k in p}
    f = shard_map(step, mesh=mesh, in_specs=(specs, P(), P()),
                  out_specs=(P(), (specs, P())), check_vma=False)
    jout, (jdp, jdh) = jax.jit(f)(p, h, ct)
    mixer = Mamba(tcfg, MeshAxes(), gen=torch.Generator())
    mixer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    th = torch.from_numpy(h).requires_grad_()
    out = mixer(th, mode="train")
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FN_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **FN_TOL)
    for k, prm in mixer.named_parameters():
        jg = np.asarray(jdp[k])
        err = np.abs(prm.grad.numpy() - jg).max()
        assert err <= GRAD_REL * np.abs(jg).max(), (k, err)


def test_mamba_train_keeps_no_state_and_counts_no_kernel():
    """Mode "train" on CPU tensors runs the plain scan through the
    Function and launches nothing; serving's modes keep working."""
    _, tcfg = _cfgs(DENSE)
    mixer = Mamba(tcfg, MeshAxes(), gen=torch.Generator().manual_seed(1))
    ops.reset_launches()
    h = torch.randn((1, 5, tcfg.d_model), requires_grad=True)
    out = mixer(h, mode="train")
    out.sum().backward()
    assert out.grad_fn is not None and h.grad is not None
    assert set(ops.launches().values()) == {0}
    with pytest.raises(ValueError):
        mixer(h, mode="paged")


# ---------------------------------------------------------------------- #
# 2. one device: the loss, every gradient, the trajectory, checkpoints
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_lm_loss_and_every_gradient_match_jax(jax_out, trees, arch):
    """``lm_loss`` within LOSS_RTOL and every gradient leaf (the Mamba
    layers' projections and per-channel leaves, attention, the MLP or the
    experts, the norms, the embedding and the head) within GRAD_REL of
    its largest entry."""
    _, tcfg = _cfgs(arch)
    jloss, jgrads = jax_out[arch, "grads"]
    model = convert.params_from_jax(trees[arch], tcfg, "cpu")
    tokens, labels = map(torch.from_numpy, _loss_batch(tcfg.vocab_size))
    loss, _ = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    names = dict(model.named_parameters())
    assert "layers.0.mixer.A_log" in names and "layers.4.mixer.wq" in names
    for name, p in names.items():
        jg = _one_device_grad(jgrads, name, tcfg)
        assert p.grad.shape == jg.shape, name
        err = np.abs(p.grad.numpy() - jg).max()
        assert err <= GRAD_REL * np.abs(jg).max(), (name, err)


def _three_steps(tcfg, tree):
    model = convert.params_from_jax(tree, tcfg, "cpu")
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(dtype=torch.float32))
    batch = MT._torch_batch(_traj_batch(tcfg.vocab_size), MeshAxes())
    out = [{k: float(v) for k, v in step(model, state, batch).items()}
           for _ in range(3)]
    return out, model, state


@pytest.fixture(scope="module")
def one_card(trees):
    """The dense-FFN model's 3 train steps on one device: (metrics, model,
    optimizer state)."""
    return _three_steps(_cfgs(DENSE)[1], trees[DENSE])


def test_three_step_trajectory_matches_jax(jax_out, one_card):
    """conftest.train_smoke's settings (B 8, S 32, overdecompose 2, lr
    1e-3, warmup 1, float32): the loss and grad norm of each step."""
    traj, _, _ = one_card
    for i, (m, (jloss, jgn)) in enumerate(zip(traj, jax_out[DENSE,
                                                             "traj"])):
        assert abs(m["loss"] - jloss) <= TRAJ_RTOL * abs(jloss), i
        assert abs(m["grad_norm"] - jgn) <= TRAJ_RTOL * jgn, i


def test_a_trained_checkpoint_restores_in_the_reference(tmp_path, trees,
                                                        one_card):
    """After 3 steps the port's ``.npz`` (parameters and AdamW's state,
    the Mamba layers' per-channel leaves among them) verifies and restores
    in the reference, every parameter equal to the port's."""
    _, tcfg = _cfgs(DENSE)
    _, model, state = one_card
    path = str(tmp_path / "jamba.npz")
    ckpt.save(path, convert.params_to_jax(model),
              convert.opt_state_to_jax(state, model), step=3,
              pspecs=convert.jax_specs(model))
    structs = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           trees[DENSE])
    assert jckpt.verify(path)["leaves"] == 4 * len(
        jax.tree.leaves(structs)) + 1
    jparams, saved = jckpt.restore(path, structs)
    assert saved == 3
    params = dict(model.named_parameters())
    for n, p in params.items():
        leaf = np.asarray(MT._leaf(jparams, convert.jax_path(n, tcfg)))
        if n.startswith("layers."):
            leaf = leaf[convert._slot(n, tcfg)[2]]
        np.testing.assert_array_equal(leaf, p.detach().numpy(), err_msg=n)


# ---------------------------------------------------------------------- #
# 3. the reference's fault at g_y > 1
# ---------------------------------------------------------------------- #

def test_reference_mamba_bc_gradient_holds_one_y_rank_of_channels():
    """The reference fault at G_y > 1 that the port does not copy
    (ROADMAP.md §3): ``w_x``'s product (``tp_matmul(xc, w_x, "y",
    None)``) is replicated over y and each y rank's scan takes B's and C's
    gradients over its own channels only; the reference passes those
    partial sums into w_x's backward, so on (1,1,2,1) each rank's B and C
    columns of w_x's gradient are more than 10% of max|g| off its block of
    the one-device gradient, while the low-rank dt columns (summed over y
    by w_dt's backward) are within GRAD_REL. The port sums B's and C's
    gradients over y (``parallel.bwd_psum``);
    ``tests/test_torch_hybrid_mesh_train.py`` holds its blocks to one
    device."""
    jcfg, _ = _cfgs(DENSE)
    dtr = -(-jcfg.d_model // 16) if not jcfg.mamba.dt_rank else \
        jcfg.mamba.dt_rank

    def init(axes, abstract):
        return jmamba.mamba_init(jax.random.PRNGKey(5), jcfg, axes,
                                 dtype=jnp.float32, abstract=abstract)

    def apply(p, h, axes):
        out, _ = jmamba.mamba_apply(p, h, jcfg, axes, mode="train")
        return jnp.sum(out * out)
    g1, _ = TM._reference_grads_on((1, 1, 1, 1), init, apply, jcfg)
    g2, _ = TM._reference_grads_on((1, 1, 2, 1), init, apply, jcfg)
    whole = np.asarray(g1["w_x"][0])
    rows = whole.shape[0] // 2
    for yr in range(2):
        got = np.asarray(g2["w_x"][yr])
        want = whole[yr * rows:(yr + 1) * rows]
        bc = np.abs(want[:, dtr:]).max()
        assert np.abs(got[:, dtr:] - want[:, dtr:]).max() > 0.1 * bc, yr
        assert np.abs(got[:, :dtr] - want[:, :dtr]).max() <= \
            GRAD_REL * np.abs(want[:, :dtr]).max(), yr


# ---------------------------------------------------------------------- #
# 4. the train CLI
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", [MOE, DENSE])
def test_train_cli_trains_jamba(arch, capsys):
    """The reference's own example, ``--arch jamba-v0.1-52b --preset
    smoke`` (and the dense-FFN variant), through the port's train CLI on
    the CPU: finite losses."""
    res = train.main(["--arch", arch, *CLI])
    assert len(res.losses) == 2
    assert all(np.isfinite(v) for v in res.losses + res.grad_norms)
    assert "final loss" in capsys.readouterr().out

