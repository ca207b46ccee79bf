"""The port's context-parallel (seq-axis) slice held against the JAX
package on the CPU.

K4's plain version against the Pallas kernel (interpret mode) and the jnp
oracle ``attn_core_partial``, its backward against ``jax.vjp`` of the
chained oracle, the striping helpers, and, on two gloo ranks of a
(1, 1, 1, 1, 2) mesh, the collectives, ``seq_attn``, ``lm_loss`` with
every gradient and a 3-step train-step trajectory against the JAX package
on the same mesh. The ranks run as ``torch.distributed.run --standalone
--nproc-per-node 2`` subprocesses of this file (its ``__main__``), each
once per module; inputs are made with numpy from a seed, weights cross
from JAX through ``convert.params_from_jax``. On the CPU the port's
wrappers run their kernels' plain versions. Tolerances are float32 ones;
each differs from 0 only because the two sides sum in another order (the
port chains one K4 pass per gathered block, the JAX blocking schedule runs
one pass over the gathered keys).
"""
import json
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
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core import mesh as JM
from repro.core.compat import shard_map
from repro.core.partition import spec_tree_to_pspecs
from repro.kernels import flash_attention as JFA
from repro.kernels import ops as JOPS
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.layers import attention as JA
from repro.models import decoder as JD
from repro.optim import adamw as JOPT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import mesh as M
from repro_torch.core.mesh import MeshAxes
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch import train
from repro_torch.layers import attention as A
from repro_torch.models import decoder as D
from repro_torch.optim import adamw as OPT

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
SEQ = (1, 1, 1, 1, 2)
KERNEL_TOL = 1e-5     # K4 plain vs Pallas / oracle, as the JAX tests hold
ATTN_TOL = 1e-5       # seq_attn and its gradients vs JAX, absolute
LOSS_RTOL = 1e-5      # lm_loss, relative
GRAD_REL = 1e-4       # per leaf: max|dg| <= GRAD_REL * max|g_leaf|
TRAJ_RTOL = 1e-4      # loss and grad_norm at each step vs JAX, relative
OWN_TOL = 1e-3        # seq-2 vs the port's own (1,1,1,1) loss, absolute
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=50)
ATTN_SHAPE = dict(B=2, T=64, nq=4, nkv=2, d=16)
WINDOWS = (0, 37)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------- #
# K4's plain version against the Pallas kernel and the jnp oracle
# ---------------------------------------------------------------------- #

def _qkv(rng, T, S, nq=4, nkv=2, d=32, B=1):
    """Model-layout (B, T, H, d) numpy inputs."""
    return _rand(rng, B, T, nq, d), _rand(rng, B, S, nkv, d), \
        _rand(rng, B, S, nkv, d)


def _jax_init(B, T, nq, d):
    return (jnp.full((B, nq, T), JFA.NEG_INF, jnp.float32),
            jnp.zeros((B, nq, T), jnp.float32),
            jnp.zeros((B, nq, T, d), jnp.float32))


def _pallas(q, k, v, carry, **pos):
    """The Pallas kernel (interpret mode, through the JAX ops wrapper that
    pads to its blocks) in the port's layouts and carry order."""
    m, l, acc = carry
    acc, m, l = JOPS.flash_attention_partial(
        *(jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (q, k, v)),
        jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc), causal=True, **pos)
    return np.asarray(m), np.asarray(l), np.asarray(acc)


def _plain(q, k, v, carry, **pos):
    out = FA.partial_attention_plain(
        *map(torch.from_numpy, (q, k, v)),
        *(torch.as_tensor(np.asarray(c)) for c in carry), **pos)
    return [o.numpy() for o in out]


def _out(carry):
    _, l, acc = carry
    return acc / np.maximum(l, 1e-30)[..., None]


def _assert_carry(got, want, tol=KERNEL_TOL):
    np.testing.assert_allclose(_out(got), _out(want), atol=tol, rtol=tol)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("T", [128, 200])   # 200: the Pallas blocks pad
def test_k4_plain_single_block(T):
    q, k, v = _qkv(np.random.RandomState(0), T, T)
    got = _plain(q, k, v, FA.attn_partial_init(1, T, 4, 32))
    _assert_carry(got, _pallas(q, k, v, _jax_init(1, T, 4, 32)))
    # a single block seeded fresh, finalised, is flash attention
    full = FA.attn_core(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(_out(got).transpose(0, 2, 1, 3),
                               full.numpy(), atol=KERNEL_TOL)


def test_k4_plain_chained_blocks():
    T, s1 = 200, 72                       # a split off the block grid
    q, k, v = _qkv(np.random.RandomState(1), T, T)
    got, want = FA.attn_partial_init(1, T, 4, 32), _jax_init(1, T, 4, 32)
    for lo, hi in ((0, s1), (s1, T)):
        got = _plain(q, k[:, lo:hi], v[:, lo:hi], got, k_pos0=lo)
        want = _pallas(q, k[:, lo:hi], v[:, lo:hi], want, k_pos0=lo)
    _assert_carry(got, want)


@pytest.mark.parametrize("window", WINDOWS)
def test_k4_plain_strided_positions(window):
    """Rank r of p = 2 holds global positions r, r + 2, ...: chained over
    the two stripes, the affine masks give attention over the whole
    sequence; each block also matches the Pallas kernel and the oracle
    over the position vectors."""
    p, C = 2, 64
    T = p * C
    q, k, v = _qkv(np.random.RandomState(2), T, T)
    full = FA.attn_core(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=window).numpy()
    for r in range(p):
        qr = np.ascontiguousarray(q[:, r::p])
        got, want = FA.attn_partial_init(1, C, 4, 32), _jax_init(1, C, 4, 32)
        for owner in range(p):
            kb, vb = (np.ascontiguousarray(t[:, owner::p]) for t in (k, v))
            pos = dict(q_pos0=r, q_stride=p, k_pos0=owner, k_stride=p,
                       window=window)
            # the oracle's carry is (B, nkv, g, C[, d]): nq = 4 split 2 x 2
            oracle = JA.attn_core_partial(
                jnp.asarray(qr), jnp.asarray(kb), jnp.asarray(vb),
                tuple(jnp.asarray(np.asarray(c)).reshape(
                    1, 2, 2, *np.shape(c)[2:]) for c in got),
                q_pos=jnp.arange(C) * p + r, k_pos=jnp.arange(C) * p + owner,
                causal=True, window=window)
            oracle = [np.asarray(o).reshape(np.shape(c))
                      for o, c in zip(oracle, got)]
            got = _plain(qr, kb, vb, got, **pos)
            want = _pallas(qr, kb, vb, want, **pos)
            _assert_carry(got, want)
            _assert_carry(got, oracle)
        np.testing.assert_allclose(_out(got).transpose(0, 2, 1, 3),
                                   full[:, r::p], atol=KERNEL_TOL)


def test_k4_plain_padding_masks_rows_and_keys():
    """``q_len`` and ``kv_len`` mask rows and keys past them, as the
    Pallas kernel masks its block padding: rows past q_len keep their
    carry bit for bit."""
    T, S, q_len, kv_len = 200, 160, 150, 130
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, T, S)
    start = _plain(q, k, v, FA.attn_partial_init(1, T, 4, 32), k_pos0=0)
    pos = dict(q_pos0=5, k_pos0=40, q_len=q_len, kv_len=kv_len)
    got = _plain(q, k, v, start, **pos)
    qp, kp, vp = (np.pad(t, ((0, 0), (0, 256 - t.shape[1]), (0, 0), (0, 0)))
                  for t in (q, k, v))
    pad = [np.pad(np.asarray(c), ((0, 0), (0, 0), (0, 56))
                  + ((0, 0),) * (c.ndim - 3)) for c in start]
    acc, m, l = JFA.flash_attention_partial(
        *(jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (qp, kp, vp)),
        *(jnp.asarray(c) for c in pad), bq=128, bk=128, **pos)
    want = [np.asarray(t)[:, :, :T] for t in (m, l, acc)]
    _assert_carry(got, want)
    for g, s in zip(got, start):
        assert np.array_equal(g[:, :, q_len:], np.asarray(s)[:, :, q_len:])


def test_k4_plain_fully_masked_rows_keep_their_carry():
    """Query positions 0, 2, 4, ... against keys 1, 3, 5, ...: row 0 sees
    no key of the block and keeps its carry bit for bit (p is zeroed
    under the mask); every other row moves, as the Pallas kernel's."""
    C = 64
    rng = np.random.RandomState(4)
    q, k, v = _qkv(rng, C, C)
    k0, v0 = _rand(rng, 1, C, 2, 32), _rand(rng, 1, C, 2, 32)
    start = _plain(q, k0, v0, FA.attn_partial_init(1, C, 4, 32), q_stride=2,
                   k_stride=2)                     # keys 0, 2, 4, ...
    pos = dict(q_stride=2, k_pos0=1, k_stride=2)
    got = _plain(q, k, v, start, **pos)
    for g, s in zip(got, start):
        assert np.array_equal(g[:, :, 0], np.asarray(s)[:, :, 0])
        assert not np.array_equal(g[:, :, 1:], np.asarray(s)[:, :, 1:])
    _assert_carry(got, _pallas(q, k, v, start, **pos))


@pytest.mark.parametrize("window", WINDOWS)
def test_k4_plain_backward_matches_jax_vjp_of_the_chain(window):
    """The plain K4 backward chained over the gathered blocks (one fp32
    dQ, dK/dV per block) against ``jax.vjp`` of the chained oracle and
    finalize, for rank 1 of p = 2."""
    p, C, r = 2, 48, 1
    B, nq, nkv, d = 2, 4, 2, 16
    rng = np.random.RandomState(5)
    q, kg, vg = _rand(rng, B, C, nq, d), _rand(rng, B, p * C, nkv, d), \
        _rand(rng, B, p * C, nkv, d)
    dout = _rand(rng, B, C, nq, d)
    q_pos = jnp.arange(C) * p + r

    def chain(q, kg, vg):
        carry = JA.attn_partial_init(B, C, nkv, nq // nkv, d)
        for rho in range(p):
            blk = slice(rho * C, (rho + 1) * C)
            carry = JA.attn_core_partial(
                q, kg[:, blk], vg[:, blk], carry, q_pos=q_pos,
                k_pos=jnp.arange(C) * p + rho, causal=True, window=window)
        return JA.attn_partial_finalize(carry, jnp.float32)
    want_out, pull = jax.vjp(chain, *map(jnp.asarray, (q, kg, vg)))
    want = pull(jnp.asarray(dout))

    tq, tk, tv, td = map(torch.from_numpy, (q, kg, vg, dout))
    pos = dict(q_pos0=r, q_stride=p, k_stride=p, window=window)
    carry = FA.attn_partial_init(B, C, nq, d)
    for rho in range(p):
        blk = slice(rho * C, (rho + 1) * C)
        carry = FA.partial_attention_plain(tq, tk[:, blk], tv[:, blk], *carry,
                                           k_pos0=rho, **pos)
    out = FA.attn_partial_finalize(carry, torch.float32)
    m, l, _ = carry
    lse = m + torch.log(l)
    delta = (td * out).sum(-1).transpose(1, 2).contiguous()
    dq = torch.zeros_like(tq)
    dks, dvs = [], []
    for rho in range(p):
        blk = slice(rho * C, (rho + 1) * C)
        dk, dv = FA.partial_attention_bwd_plain(
            tq, tk[:, blk], tv[:, blk], td, lse, delta, dq, k_pos0=rho, **pos)
        dks.append(dk)
        dvs.append(dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=KERNEL_TOL)
    for g, w in zip((dq, torch.cat(dks, 1), torch.cat(dvs, 1)), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)


def test_k4_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors ops.flash_attention_partial(_bwd) run the plain
    versions and count no launch; a K4 wrapper refuses CPU tensors."""
    rng = np.random.RandomState(6)
    q, k, v = map(torch.from_numpy, _qkv(rng, 16, 16, d=64))
    carry = FA.attn_partial_init(1, 16, 4, 64)
    ops.reset_launches()
    got = ops.flash_attention_partial(q, k, v, *carry, k_pos0=0)
    want = FA.partial_attention_plain(q, k, v, *carry)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    m, l, _ = got
    dq = torch.zeros_like(q)
    ops.flash_attention_partial_bwd(q, k, v, q, m + torch.log(l),
                                    torch.zeros_like(m), dq)
    assert ops.launches()["partial_attention"] == 0
    assert ops.launches()["partial_attention_bwd"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        FA.partial_attention_kernel(q, k, v, *carry)


# ---------------------------------------------------------------------- #
# striping
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("p", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("dim", [1, -1])
def test_stripe_and_unstripe_match_jax(p, dim):
    x = np.arange(2 * 12 * 12).reshape(2, 12, 12).astype(np.int32)
    s = M.stripe_seq(torch.from_numpy(x), p, dim=dim)
    np.testing.assert_array_equal(s.numpy(), np.asarray(
        JM.stripe_seq(jnp.asarray(x), p, dim=dim)))
    u = M.unstripe_seq(s, p, dim=dim)
    np.testing.assert_array_equal(u.numpy(), np.asarray(
        JM.unstripe_seq(jnp.asarray(s.numpy()), p, dim=dim)))
    np.testing.assert_array_equal(u.numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        M.stripe_seq(torch.zeros(2, 5), 2)


# ---------------------------------------------------------------------- #
# two gloo ranks on a (1, 1, 1, 1, 2) mesh
# ---------------------------------------------------------------------- #

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _torchrun(args, timeout=240):
    """``args`` under ``torch.distributed.run`` on 2 ranks; its stdout. The
    launcher runs in a session of its own, so that a timeout stops it and
    both ranks together."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *args], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    return out


def _global_inputs():
    """Every input of the rank worker, from numpy seeds."""
    s = ATTN_SHAPE
    rng = np.random.RandomState(7)
    attn = [_rand(rng, s["B"], s["T"], n, s["d"])
            for n in (s["nq"], s["nkv"], s["nkv"], s["nq"])]
    vocab = get_config(ARCH).reduced().vocab_size
    rng = np.random.RandomState(8)
    loss_batch = [rng.randint(0, vocab, (4, 32)).astype(np.int32)
                  for _ in range(2)]
    rng = np.random.RandomState(0)        # conftest.train_smoke's batch
    traj_batch = [rng.randint(0, vocab, (8, 32)).astype(np.int32)
                  for _ in range(2)]
    return dict(coll=_rand(np.random.RandomState(9), 2, 6, 3), attn=attn,
                loss_batch=loss_batch, traj_batch=traj_batch)


def _local(x, axes):
    """This rank's shard of a global (B, T, ...) input, striped."""
    return M.seq_shard(M.stripe_seq(torch.from_numpy(x), axes.gseq), axes)


def _rank_worker(outdir: pathlib.Path):
    """One rank: every 2-rank case of this file, saved to rank<r>.pt."""
    from repro_torch.launch.mesh import close_mesh, init_mesh
    axes = MeshAxes(SEQ)
    rank = init_mesh(axes, device="cpu")["rank"]
    inp = _global_inputs()
    out = {}
    try:
        x = torch.from_numpy(inp["coll"])
        r = M.axis_index(axes, "seq")
        mine = x * (r + 1)
        out["coll"] = dict(
            index=r, psum=M.psum(mine, axes, "seq"),
            psum_token_axes=M.psum(mine, axes, axes.token_axes()),
            pmax=M.pmax(mine, axes, "seq"),
            all_gather=M.all_gather(x.chunk(2, 1)[r], axes, "seq", dim=1),
            psum_scatter=M.psum_scatter(mine, axes, "seq", dim=1))
        for window in WINDOWS:
            q, k, v, dout = (_local(t, axes).requires_grad_()
                             for t in inp["attn"])
            o = A.seq_attn(q, k, v, axes, window=window)
            o.backward(dout.detach())
            out[f"attn{window}"] = [t.detach() for t in
                                    (o, q.grad, k.grad, v.grad)]
        cfg = get_config(ARCH).reduced()
        state = torch.load(outdir / "model.pt")
        model = ST.init_model(cfg, axes, device="cpu")
        model.load_state_dict(state)
        tokens, labels = (_local(t, axes) for t in inp["loss_batch"])
        loss, metrics = D.lm_loss(model, tokens, labels, remat=True)
        loss.backward()
        out["loss"] = (float(loss.detach()), float(metrics["aux"]))
        out["grads"] = {n: M.psum(p.grad, axes, "seq")
                        for n, p in model.named_parameters()}
        model = ST.init_model(cfg, axes, device="cpu")
        model.load_state_dict(state)
        opt_state = OPT.init_state(dict(model.named_parameters()))
        step = ST.make_train_step(cfg, axes, OPT.AdamWConfig(**OPT_CFG),
                                  ST.TrainOptions(overdecompose=2,
                                                  dtype=torch.float32))
        batch = ST.stripe_batch(
            {k: torch.from_numpy(v) for k, v in
             zip(("tokens", "labels"), inp["traj_batch"])}, axes)
        out["traj"] = [{k: float(v) for k, v in step(model, opt_state,
                                                      batch).items()}
                       for _ in range(3)]
        out["param_sha256"] = train.param_sha256(model)
        out["bf16_n1"] = _bf16_one_microbatch(cfg, axes, state,
                                              inp["loss_batch"])
    finally:
        close_mesh()
    torch.save(out, outdir / f"rank{rank}.pt")


def _bf16_one_microbatch(cfg, axes, state, batch):
    """A bfloat16 train step at overdecompose 1: this rank's own bf16
    gradients of the step's loss, and the gradients the step hands to
    AdamW (captured around ``adamw.apply_updates``)."""
    model = ST.init_model(cfg, axes, device="cpu")
    model.load_state_dict(state)
    model.to(torch.bfloat16)
    tokens, labels = (_local(t, axes) for t in batch)
    loss, _ = D.lm_loss(model, tokens, labels, remat=True)
    loss.backward()
    own = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    handed = {}
    apply_updates = OPT.apply_updates

    def capture(params, grads, *args, **kw):
        handed.update({k: g.clone() for k, g in grads.items()})
        return apply_updates(params, grads, *args, **kw)
    step = ST.make_train_step(cfg, axes, OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(overdecompose=1,
                                              dtype=torch.bfloat16))
    OPT.apply_updates = capture
    try:
        step(model, OPT.init_state(dict(model.named_parameters())),
             ST.stripe_batch({k: torch.from_numpy(v) for k, v in
                              zip(("tokens", "labels"), batch)}, axes))
    finally:
        OPT.apply_updates = apply_updates
    return dict(own=own, handed=handed)


@pytest.fixture(scope="module")
def jax_model():
    """(jax cfg, numpy params, port cfg) of qwen3-1.7b reduced with the JAX
    package's weights."""
    jcfg = jax_get_config(ARCH).reduced()
    axes = LM.bind_4d(LM.make_smoke_mesh((1, 1, 1, 1)))
    params, _ = JST.init_model(jcfg, axes, jax.random.PRNGKey(0),
                               dtype=jnp.float32)
    return jcfg, jax.tree.map(np.asarray, params), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def ranks(jax_model, tmp_path_factory):
    """The two ranks' results of :func:`_rank_worker`."""
    _, tree, tcfg = jax_model
    outdir = tmp_path_factory.mktemp("seq_ranks")
    torch.save(convert.params_from_jax(tree, tcfg, "cpu").state_dict(),
               outdir / "model.pt")
    _torchrun([__file__, str(outdir)])
    return [torch.load(outdir / f"rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def seq_mesh():
    mesh = LM.make_smoke_mesh(SEQ, ("data", "x", "y", "z", "seq"))
    return mesh, LM.bind_4d(mesh)


def _joined(parts):
    """The ranks' (B, C, ...) shards as the global unstriped array."""
    return M.unstripe_seq(torch.cat(parts, 1), len(parts)).numpy()


def test_collectives_over_two_ranks(ranks):
    x = _global_inputs()["coll"]
    total = x * np.float32(1) + x * np.float32(2)
    for r, res in enumerate(ranks):
        c = res["coll"]
        assert c["index"] == r
        np.testing.assert_array_equal(c["psum"].numpy(), total)
        np.testing.assert_array_equal(c["psum_token_axes"].numpy(), total)
        np.testing.assert_array_equal(c["pmax"].numpy(),
                                      np.maximum(x, 2 * x))
        np.testing.assert_array_equal(c["all_gather"].numpy(), x)
        np.testing.assert_array_equal(c["psum_scatter"].numpy(),
                                      np.split(total, 2, 1)[r])


def _jax_attn_vjp(q, k, v, dout, window):
    def f(q, k, v):
        return JA.attn_core(q, k, v, causal=True, window=window)
    out, pull = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(t) for t in (out, *pull(jnp.asarray(dout)))]


@pytest.mark.parametrize("window", WINDOWS)
def test_seq_attn_on_two_ranks_matches_attention_over_the_sequence(
        ranks, window):
    """Both ranks' outputs and input gradients, unstriped, against JAX's
    attn_core over the whole sequence and its vjp."""
    q, k, v, dout = _global_inputs()["attn"]
    want = _jax_attn_vjp(q, k, v, dout, window)
    for i, w in enumerate(want):
        got = _joined([res[f"attn{window}"][i] for res in ranks])
        np.testing.assert_allclose(got, w, atol=ATTN_TOL, rtol=ATTN_TOL)


def test_seq_attn_on_two_ranks_matches_jax_seq_attn(ranks, seq_mesh):
    """Against JAX's blocking seq_attn on the (1,1,1,1,2) mesh (window 0,
    the case the reference passes), forward and vjp, shard by shard."""
    mesh, axes = seq_mesh
    q, k, v, dout = (JM.stripe_seq(jnp.asarray(t), 2)
                     for t in _global_inputs()["attn"])
    spec = P(None, "seq", None, None)

    def f(q, k, v, dout):
        out, pull = jax.vjp(lambda *a: JA.seq_attn(*a, axes, causal=True),
                            q, k, v)
        return out, pull(dout)
    g = shard_map(f, mesh=mesh, in_specs=(spec,) * 4,
                  out_specs=(spec, (spec,) * 3), check_vma=False)
    out, grads = jax.jit(g)(q, k, v, dout)
    for i, w in enumerate((out, *grads)):
        got = torch.cat([res["attn0"][i] for res in ranks], 1).numpy()
        np.testing.assert_allclose(got, np.asarray(w), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


def _jax_leaf(tree, path: str, name: str):
    leaf = tree
    for k in path.split("/"):
        leaf = leaf[k]
    return leaf[int(name.split(".")[1])] if name.startswith("layers.") \
        else leaf


def test_lm_loss_and_every_gradient_on_two_ranks_match_jax(
        ranks, jax_model, seq_mesh):
    """lm_loss and every parameter's gradient (psum'd over seq) of the
    two ranks against JAX's on the (1,1,1,1,2) mesh."""
    jcfg, tree, tcfg = jax_model
    mesh, axes = seq_mesh
    tokens, labels = (JM.stripe_seq(jnp.asarray(t), 2)
                      for t in _global_inputs()["loss_batch"])

    def step(params, tokens, labels):
        def f(p):
            return JD.lm_loss(p, jcfg, axes, tokens, labels, remat=True)
        (loss, _), grads = jax.value_and_grad(f, has_aux=True)(params)
        return loss, jax.tree.map(lambda g: JM.psum(g, axes.seq), grads)
    specs = jax.tree.map(lambda _: P(), tree)
    tspec = P(None, "seq")
    f = shard_map(step, mesh=mesh, in_specs=(specs, tspec, tspec),
                  out_specs=(P(), specs), check_vma=False)
    jloss, jgrads = jax.jit(f)(jax.tree.map(jnp.asarray, tree), tokens,
                               labels)
    jloss = float(jloss)
    model = convert.params_from_jax(tree, tcfg, "cpu")
    paths = convert.jax_paths(model)
    for res in ranks:
        loss, aux = res["loss"]
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
        assert aux == 0.0
        for name, g in res["grads"].items():
            jg = np.asarray(_jax_leaf(jgrads, paths[name], name))
            assert g.shape == jg.shape, name
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_REL * np.abs(jg).max(), (name, err)
    assert all(torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n])
               for n in ranks[0]["grads"])


def test_seq_loss_is_the_mean_over_the_whole_sequence(ranks, jax_model):
    """The loss of two seq-ranks reduces over the token axes (data, z,
    seq) and divides by token_shards: it is the unsharded loss, not the
    mean of a rank's own tokens."""
    _, tree, tcfg = jax_model
    tokens, labels = map(torch.from_numpy, _global_inputs()["loss_batch"])
    model = convert.params_from_jax(tree, tcfg, "cpu")
    loss, _ = D.lm_loss(model, tokens, labels, remat=True)
    for res in ranks:
        assert abs(res["loss"][0] - float(loss.detach())) <= \
            LOSS_RTOL * float(loss.detach())


def test_bf16_step_at_overdecompose_1_reduces_in_bf16(ranks):
    """At overdecompose 1 the JAX step keeps bfloat16 gradients and psums
    them over seq in bfloat16 (no fp32 accumulator, which it makes only
    for n > 1). On two ranks AdamW gets, on each, the bf16 sum of the two
    ranks' bf16 gradients, rounded once: not their exact fp32 sum."""
    own = [r["bf16_n1"]["own"] for r in ranks]
    assert own[0].keys() == ranks[0]["bf16_n1"]["handed"].keys()
    for n in own[0]:
        want = (own[0][n].float() + own[1][n].float()).to(torch.bfloat16)
        for r in ranks:
            got = r["bf16_n1"]["handed"][n]
            assert got.dtype == torch.bfloat16, (n, got.dtype)
            assert torch.equal(got, want), n


def _jax_trajectory(jcfg, tree, batch, mesh, axes, steps=3):
    _, specs = JST.init_model(jcfg, axes, abstract=True, dtype=jnp.float32)
    params = JST.device_put_tree(mesh, jax.tree.map(jnp.asarray, tree),
                                 spec_tree_to_pspecs(specs))
    state = JOPT.init_state(params)
    step_fn, _, _ = JST.make_train_step(
        jcfg, mesh, axes, JOPT.AdamWConfig(**OPT_CFG),
        JST.TrainOptions(overdecompose=2, dtype=jnp.float32))
    jb = JST.stripe_batch({k: jnp.asarray(v) for k, v in batch.items()},
                          axes)
    out = []
    for _ in range(steps):
        params, state, m = step_fn(params, state, jb)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def test_three_step_trajectory_on_two_ranks(ranks, jax_model, seq_mesh):
    """conftest.train_smoke's batch (B 8, S 32, overdecompose 2, lr 1e-3,
    warmup 1, f32) on two seq-ranks: loss and grad_norm at each step
    against JAX's make_train_step on (1,1,1,1,2) and against the port's
    own (1,1,1,1) step; both ranks end with bitwise-equal parameters."""
    jcfg, tree, tcfg = jax_model
    batch = dict(zip(("tokens", "labels"), _global_inputs()["traj_batch"]))
    want = _jax_trajectory(jcfg, tree, batch, *seq_mesh)
    model = convert.params_from_jax(tree, tcfg, "cpu")
    state = OPT.init_state(dict(model.named_parameters()))
    step = ST.make_train_step(tcfg, MeshAxes(), OPT.AdamWConfig(**OPT_CFG),
                              ST.TrainOptions(overdecompose=2,
                                              dtype=torch.float32))
    own = [float(step(model, state, {k: torch.from_numpy(v) for k, v in
                                     batch.items()})["loss"])
           for _ in range(3)]
    for res in ranks:
        for i, ((jloss, jgn), m) in enumerate(zip(want, res["traj"])):
            assert abs(m["loss"] - jloss) <= TRAJ_RTOL * abs(jloss), i
            assert abs(m["grad_norm"] - jgn) <= TRAJ_RTOL * jgn, i
            assert abs(m["loss"] - own[i]) <= OWN_TOL, i
    assert want[2][0] < want[0][0]
    assert ranks[0]["param_sha256"] == ranks[1]["param_sha256"]


def test_train_cli_on_two_ranks():
    """``launch/train.py --mesh 1,1,1,1,2 --backend gloo --device cpu`` on
    two ranks: rank 0 alone prints, its last line is the JSON report;
    losses within 1e-3 of the one-rank run of the same seed and data,
    parameters bitwise equal on both ranks, seq-axis traffic counted."""
    flags = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
             "--steps", "3", "--batch", "4", "--seq", "32", "--log-every",
             "1"]
    out = _torchrun(["-m", "repro_torch.launch.train", *flags, "--mesh",
                     "1,1,1,1,2", "--backend", "gloo"])
    lines = out.strip().splitlines()
    assert lines.count("backend=gloo ranks_per_card=- ranks=2") == 1
    assert sum(ln.startswith("step ") for ln in lines) == 3
    rep = json.loads(lines[-1])["train"]
    one = train.main(flags)
    assert len(rep["losses"]) == 3
    assert max(abs(a - b) for a, b in zip(rep["losses"], one.losses)) \
        <= OWN_TOL
    r0, r1 = rep["ranks"]
    assert r0["param_sha256"] == r1["param_sha256"] is not None
    assert all(b > 0 for b in r0["comm_bytes"]) and len(r0["comm_s"]) == 3
    assert r0["launches"]["partial_attention"] == 0   # the CPU runs plain


def test_a_seq_axis_needs_its_ranks():
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        train.main(["--arch", ARCH, "--device", "cpu", "--mesh",
                    "1,1,1,1,2"])


@pytest.mark.parametrize("arch,g_seq,match", [
    ("jamba-v0.1-52b-dense-ffn", 2, "all-attention mixers"),
    (ARCH, 3, "max_seq 512 % g_seq 3")])
def test_a_seq_axis_needs_attention_and_a_dividing_max_seq(arch, g_seq,
                                                            match):
    cfg = get_config(arch).reduced()
    with pytest.raises(ValueError, match=match):
        ST.init_model(cfg, MeshAxes((1, 1, 1, 1, g_seq)), device="cpu")


@pytest.mark.parametrize("mode", ["paged", "prefill", "decode"])
def test_serving_refuses_a_seq_axis(mode):
    cfg = get_config(ARCH).reduced()
    model = ST.init_model(cfg, MeshAxes(SEQ), device="cpu")
    with pytest.raises(NotImplementedError, match="training-path feature"):
        model.hidden(torch.zeros((1, 4), dtype=torch.int32), mode=mode)


if __name__ == "__main__":
    _rank_worker(pathlib.Path(sys.argv[1]))
