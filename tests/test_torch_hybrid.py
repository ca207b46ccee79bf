"""The port's fixed-batch serving slice and Jamba's hybrid decoder held
against the JAX package on the CPU.

K6's plain version against the JAX Pallas kernel (interpret mode), its
sequential oracle and the model's chunked associative scan; the Mamba
layer's prefill and decode against ``mamba_apply``; the slice end to end
(JAX ``make_prefill_step`` / ``make_decode_step`` on a (1, 1, 1, 1) mesh
against the port's) on ``jamba-v0.1-52b-dense-ffn`` reduced and on
``qwen3-1.7b`` reduced. Inputs are made with numpy from a seed, weights
cross with ``convert.params_from_jax``; the port runs its kernels' plain
versions on the CPU.

Tolerances: the scan's 2e-4 is that of ``tests/test_kernels.py``: the
associative scan multiplies the decay factors in another order than the
sequential one, in float32. Layer outputs (1e-5), logits and caches (1e-4,
as ``test_torch_serving.py`` holds logits) are float32 sums taken in
another order by the two frameworks, through 8 layers for the logits.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core.compat import shard_map
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro.layers import mamba as jmamba
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.mesh import MeshAxes
from repro_torch.kernels import ops
from repro_torch.kernels.selective_scan import selective_scan_plain
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.layers.mamba import Mamba, mamba_state_spec
from repro_torch.models import decoder as D

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

JAMBA = "jamba-v0.1-52b-dense-ffn"
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_SHAPES = [(2, 128, 64, 16), (1, 200, 100, 8), (3, 64, 256, 16)]


def _jax_cfg(name):
    if name == JAMBA:
        return dataclasses.replace(jax_get_config("jamba-v0.1-52b"),
                                   moe=None, name=JAMBA)
    return jax_get_config(name)


@pytest.fixture(scope="module")
def jax_mesh():
    mesh = LM.make_smoke_mesh((1, 1, 1, 1))
    return mesh, LM.bind_4d(mesh)


def _scan_inputs(bt, t, d, n, seed=0):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    x = rng.randn(bt, t, d).astype(f32)
    dt = (np.log1p(np.exp(rng.randn(bt, t, d))) * 0.1).astype(f32)
    A = (-np.exp(rng.randn(d, n) * 0.5)).astype(f32)
    B = rng.randn(bt, t, n).astype(f32)
    C = rng.randn(bt, t, n).astype(f32)
    s0 = (0.5 * rng.randn(bt, d, n)).astype(f32)
    return x, dt, A, B, C, s0


def _port_scan(x, dt, A, B, C, s0=None):
    y, s = selective_scan_plain(*map(torch.from_numpy, (x, dt, A, B, C)),
                                s0=None if s0 is None
                                else torch.from_numpy(s0))
    return y.numpy(), s.numpy()


# ---------------------------------------------------------------------- #
# K6: the plain version against the JAX kernel, oracle and chunked scan
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("bt,t,d,n", SCAN_SHAPES)
def test_scan_plain_matches_pallas_kernel(bt, t, d, n):
    x, dt, A, B, C, _ = _scan_inputs(bt, t, d, n)
    want = np.asarray(jops.selective_scan(*map(jnp.asarray, (x, dt, A, B, C)),
                                          bd=64, ck=64))
    np.testing.assert_allclose(_port_scan(x, dt, A, B, C)[0], want,
                               **SCAN_TOL)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("bt,t,d,n", SCAN_SHAPES)
def test_scan_plain_matches_sequential_oracle(bt, t, d, n, with_s0):
    x, dt, A, B, C, s0 = _scan_inputs(bt, t, d, n, seed=1)
    s0 = s0 if with_s0 else None
    wy, ws = jref.selective_scan_ref(*map(jnp.asarray, (x, dt, A, B, C)),
                                     s0=None if s0 is None
                                     else jnp.asarray(s0))
    y, s = _port_scan(x, dt, A, B, C, s0)
    np.testing.assert_allclose(y, np.asarray(wy), **SCAN_TOL)
    np.testing.assert_allclose(s, np.asarray(ws), **SCAN_TOL)


@pytest.mark.parametrize("bt,t,d,n", SCAN_SHAPES)
def test_scan_plain_matches_chunked_associative_scan(bt, t, d, n):
    """``ssm_scan_chunked`` reshapes T into T // (T // 128) chunks, so T
    must be at most 128 or a multiple of that; the shapes here are."""
    x, dt, A, B, C, s0 = _scan_inputs(bt, t, d, n, seed=2)
    wy, ws = jmamba.ssm_scan_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                                     s0=jnp.asarray(s0))
    y, s = _port_scan(x, dt, A, B, C, s0)
    np.testing.assert_allclose(y, np.asarray(wy), **SCAN_TOL)
    np.testing.assert_allclose(s, np.asarray(ws), **SCAN_TOL)


def test_scan_takes_strided_b_and_c_and_an_empty_sequence():
    """B and C as column views of one projection (as the layer passes
    them) give what contiguous copies give; T = 0 returns the initial
    state."""
    x, dt, A, B, C, s0 = _scan_inputs(2, 9, 32, 8, seed=3)
    xdbc = torch.from_numpy(np.concatenate([x[..., :5], B, C], axis=-1))
    bv, cv = xdbc[..., 5:13], xdbc[..., 13:]
    assert not bv.is_contiguous()
    y, s = ops.selective_scan(torch.from_numpy(x), torch.from_numpy(dt),
                              torch.from_numpy(A), bv, cv,
                              torch.from_numpy(s0))
    wy, ws = _port_scan(x, dt, A, B, C, s0)
    np.testing.assert_array_equal(y.numpy(), wy)
    np.testing.assert_array_equal(s.numpy(), ws)
    y0, s0_out = ops.selective_scan(*(torch.from_numpy(a[:, :0])
                                      for a in (x, dt)),
                                    torch.from_numpy(A),
                                    *(torch.from_numpy(a[:, :0])
                                      for a in (B, C)),
                                    torch.from_numpy(s0))
    assert y0.shape == (2, 0, 32)
    np.testing.assert_array_equal(s0_out.numpy(), s0)


# ---------------------------------------------------------------------- #
# the Mamba layer against mamba_apply
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jamba(jax_mesh):
    """(jax cfg, jax params, port cfg, port model) of the reduced dense-FFN
    Jamba (8 layers: Mamba at 0-3 and 5-7, attention at 4)."""
    jcfg = _jax_cfg(JAMBA).reduced()
    tcfg = get_config(JAMBA).reduced()
    params, _ = JST.init_model(jcfg, jax_mesh[1], jax.random.PRNGKey(0),
                               dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, convert.params_from_jax(tree, tcfg, "cpu")


def _jax_mamba(jax_mesh, jcfg, p, h, mode, state=None):
    mesh, axes = jax_mesh

    def f(p, h, state):
        return jmamba.mamba_apply(p, h, jcfg, axes, mode=mode, state=state)
    fn = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()),
                   out_specs=(P(), P()), check_vma=False)
    out, st = jax.jit(fn)(p, jnp.asarray(h), state)
    return np.asarray(out), jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("layer", [0, 6])
def test_mamba_layer_prefill_and_decode_match_jax(jamba, jax_mesh, layer):
    """One prefill of 16 rows, then 3 decode rows from its states: outputs
    and both states (conv inputs, scan state) agree."""
    jcfg, params, tcfg, model = jamba
    s, i, p = tcfg.layer_slots()[layer]
    jp = jax.tree.map(lambda a: a[p],
                      params["segments"][f"seg{s}"][f"pos{i}"]["mixer"])
    mixer = model.layers[layer].mixer
    assert isinstance(mixer, Mamba)
    rng = np.random.RandomState(layer)
    B, T, d = 2, 16, tcfg.d_model
    h = rng.randn(B, T, d).astype(np.float32)
    state = ST.zeros_caches(mamba_state_spec(tcfg, MeshAxes(), B), "cpu")
    with torch.inference_mode():
        out = mixer(torch.from_numpy(h), mode="prefill", state=state)
    jout, jst = _jax_mamba(jax_mesh, jcfg, jp, h, "prefill")
    np.testing.assert_allclose(out.numpy(), jout, **LAYER_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(state[k].numpy(), jst[k], **LAYER_TOL,
                                   err_msg=k)
    for step in range(3):
        h1 = rng.randn(B, 1, d).astype(np.float32)
        with torch.inference_mode():
            out = mixer(torch.from_numpy(h1), mode="decode", state=state)
        jout, jst = _jax_mamba(jax_mesh, jcfg, jp, h1, "decode", jst)
        np.testing.assert_allclose(out.numpy(), jout, **LAYER_TOL,
                                   err_msg=f"decode {step}")
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(state[k].numpy(), jst[k],
                                       **LAYER_TOL, err_msg=f"{k} {step}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_calls_k6_within_its_contract(jamba, monkeypatch, dtype):
    """What prefill and decode hand to K6 passes the kernel's own dtype,
    shape and stride checks (the CPU runs the plain version, which takes
    anything)."""
    from repro_torch.kernels import selective_scan as KS
    calls = []

    def checked(*args):
        KS.check_inputs(*args)
        calls.append(args[0].shape[1])
        return KS.selective_scan_plain(*args)
    monkeypatch.setattr(ops, "selective_scan_plain", checked)
    *_, tcfg, model = jamba
    mixer = model.layers[0].mixer
    if dtype != torch.float32:
        mixer = Mamba(tcfg, MeshAxes(), gen=torch.Generator().manual_seed(0),
                      dtype=dtype)
    state = ST.zeros_caches(mamba_state_spec(tcfg, MeshAxes(), 2,
                                             dtype=dtype), "cpu")
    h = torch.randn((2, 7, tcfg.d_model)).to(dtype)
    with torch.inference_mode():
        mixer(h, mode="prefill", state=state)
        out = mixer(h[:, :1], mode="decode", state=state)
    assert calls == [7, 1] and out.dtype == dtype


# ---------------------------------------------------------------------- #
# the slice end to end: prefill + 4 decode steps
# ---------------------------------------------------------------------- #

def _jax_fixed(jcfg, jax_mesh, params, tokens, gen):
    """JAX prefill and gen - 1 greedy decode steps: per step (logits,
    caches as numpy, greedy ids)."""
    mesh, axes = jax_mesh
    B, T = tokens.shape
    S = T + gen
    pre_fn, _, ct = JST.make_prefill_step(jcfg, mesh, axes,
                                          dtype=jnp.float32)[0](B, T, S)
    dec_fn, _ = JST.make_decode_step(jcfg, mesh, axes,
                                     dtype=jnp.float32)[0](B, S)
    caches = JST.zeros_caches(mesh, ct)
    logits, caches = pre_fn(params, caches, {"tokens": jnp.asarray(tokens)})
    out = []
    for i in range(gen):
        lg = np.asarray(logits)
        ids = lg[:, -1].argmax(-1).astype(np.int32)
        out.append((lg, jax.tree.map(np.asarray, caches), ids))
        if i + 1 < gen:
            logits, caches = dec_fn(params, caches,
                                    jnp.asarray(ids[:, None]),
                                    jnp.int32(T + i))
    return out


@pytest.fixture(scope="module", params=[JAMBA, "qwen3-1.7b"])
def served(request, jax_mesh):
    jcfg = _jax_cfg(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    params, _ = JST.init_model(jcfg, jax_mesh[1], jax.random.PRNGKey(1),
                               dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, convert.params_from_jax(tree, tcfg, "cpu")


def test_fixed_serving_matches_jax(served, jax_mesh):
    """Prefill of 4 prompts of 12 tokens, then 4 decode steps fed JAX's
    greedy ids: logits and every layer's cache agree, and the port's
    greedy ids are JAX's."""
    jcfg, params, tcfg, model = served
    B, T, GEN = 4, 12, 5
    tokens = np.random.RandomState(5).randint(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    want = _jax_fixed(jcfg, jax_mesh, params, tokens, GEN)
    S = T + GEN
    pre_fn, ct = ST.make_prefill_step(tcfg, MeshAxes())(B, T, S)
    dec_fn, ct2 = ST.make_decode_step(tcfg, MeshAxes())(B, S)
    assert ct == ct2
    caches = ST.zeros_caches(ct, "cpu")
    logits, caches = pre_fn(model, caches, torch.from_numpy(tokens))
    for i, (jl, jc, ids) in enumerate(want):
        np.testing.assert_allclose(logits.numpy(), jl, **LOGIT_TOL,
                                   err_msg=f"step {i}")
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), ids), i
        for layer, (got, exp) in enumerate(zip(
                caches, convert.caches_from_jax(jc, tcfg))):
            for k in exp:
                np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(),
                                           **LOGIT_TOL,
                                           err_msg=f"step {i} {layer} {k}")
        if i + 1 < GEN:
            logits, caches = dec_fn(model, caches,
                                    torch.from_numpy(ids[:, None]), T + i)


def test_fixed_ids_equal_paged_engine_ids():
    """qwen3-1.7b: fixed-batch greedy decode (dense caches, K2 prefill, K5
    over the dense cache) gives the paged engine's tokens, as
    tests/test_serving.py pins for the JAX package."""
    from repro_torch.launch.serving import PagedEngine, Request, ServeConfig
    cfg = get_config("qwen3-1.7b").reduced()
    model = ST.init_model(cfg, seed=3, device="cpu")
    B, L, GEN = 4, 8, 6
    prompts = np.random.RandomState(3).randint(
        1, cfg.vocab_size, (B, L)).astype(np.int32)
    pre_fn, ct = ST.make_prefill_step(cfg, MeshAxes())(B, L, L + GEN)
    dec_fn, _ = ST.make_decode_step(cfg, MeshAxes())(B, L + GEN)
    caches = ST.zeros_caches(ct, "cpu")
    logits, caches = pre_fn(model, caches, torch.from_numpy(prompts))
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    dense = [tok]
    for i in range(GEN - 1):
        logits, caches = dec_fn(model, caches, tok, L + i)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        dense.append(tok)
    dense = torch.cat(dense, 1).numpy()
    engine = PagedEngine(cfg, MeshAxes(), model, ServeConfig(
        slots=B, page_size=4, pages_per_shard=1 + B * 4, chunk=4))
    reqs = [Request(rid=r, prompt=prompts[r], max_new=GEN)
            for r in range(B)]
    engine.run(reqs)
    paged = np.stack([np.asarray(r.generated, np.int32) for r in reqs])
    assert np.array_equal(dense, paged), (dense, paged)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", JAMBA])
def test_serve_fixed_cli_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--mode", "fixed", "--device", "cpu",
                "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill 2x6" in out and "decode: 2 steps x batch 2" in out
    assert "SERVE OK" in out


def test_run_fixed_returns_the_greedy_ids():
    args = serve.build_parser().parse_args([
        "--arch", JAMBA, "--mode", "fixed", "--device", "cpu", "--batch",
        "3", "--prompt-len", "5", "--gen", "4"])
    res = serve.run_fixed(args)
    assert res.ids.shape == (3, 4) and res.ids.dtype == np.int32
    assert res.logits.shape == (3, 1, get_config(JAMBA).reduced()
                                .padded_vocab)
    assert torch.isfinite(res.logits).all() and res.prefill_s >= 0


def test_fixed_serving_of_the_hybrid_decoder_with_overlap_on_one_rank():
    """``serve.py --mode fixed --overlap`` serves Jamba's hybrid decoder on
    one CPU rank (it raised before the overlapped schedule was ported):
    every ring is inert on one rank, so the greedy ids and the last
    logits are bitwise those of the run without ``--overlap``."""
    model = ST.init_model(get_config(JAMBA).reduced(), seed=0, device="cpu")
    flags = ["--arch", JAMBA, "--mode", "fixed", "--device", "cpu",
             "--batch", "2", "--prompt-len", "5", "--gen", "3"]
    off, on = (serve.run_fixed(serve.build_parser().parse_args(flags + f),
                               model) for f in ([], ["--overlap"]))
    assert np.array_equal(off.ids, on.ids)
    assert torch.equal(off.logits, on.logits)


@pytest.mark.parametrize("flag,item", [("--telemetry", "runtime tooling")])
def test_run_fixed_with_a_model_refuses_unported_flags(flag, item):
    """A caller's model skips building, not the refusals of the CLI."""
    model = ST.init_model(get_config(JAMBA).reduced(), seed=0, device="cpu")
    args = serve.build_parser().parse_args([
        "--arch", JAMBA, "--mode", "fixed", "--device", "cpu", flag])
    with pytest.raises(NotImplementedError, match=f"'{item}'"):
        serve.run_fixed(args, model)


def test_dense_page_view_is_the_cache_without_a_copy():
    """K5's view of a dense decode cache: row b's pages are its own rows
    in order, and writes to the cache show through the view."""
    from repro_torch.layers.attention import DENSE_PAGE, dense_page_view
    cache = torch.randn((3, 2 * DENSE_PAGE, 2, 4))
    pages, table = dense_page_view(cache)
    assert table.dtype == torch.int32 and table.tolist() == [[0, 1], [2, 3],
                                                             [4, 5]]
    assert torch.equal(pages[table.long()].reshape(cache.shape), cache)
    cache[2, DENSE_PAGE + 1] = 7.0
    assert (pages[5, 1] == 7.0).all()


def test_short_prompt_keeps_zeros_in_the_conv_state():
    """A prompt shorter than d_conv - 1 leaves zeros in front of its
    inputs in the conv state, as the conv's own padding has."""
    cfg = get_config(JAMBA).reduced()
    model = ST.init_model(cfg, seed=0, device="cpu")
    pre_fn, ct = ST.make_prefill_step(cfg, MeshAxes())(2, 1, 4)
    caches = ST.zeros_caches(ct, "cpu")
    logits, caches = pre_fn(model, caches,
                            torch.ones((2, 1), dtype=torch.int32))
    assert torch.isfinite(logits).all()
    conv = caches[0]["conv"]
    assert not conv[:, :2].any() and conv[:, 2].any()


# ---------------------------------------------------------------------- #
# configuration and conversion
# ---------------------------------------------------------------------- #

def test_full_width_jamba_config():
    cfg = get_config(JAMBA)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size) == (
        32, 4096, 32, 8, 128, 14336, 65536)
    assert (cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state,
            cfg.mamba.d_conv, cfg.dt_rank) == (8192, 16, 4, 256)
    assert not cfg.tie_embeddings and cfg.rotary_pct == 0.0
    assert cfg.moe is None and "dense" in cfg.source
    kinds = cfg.segments()
    assert len(kinds) == 1 and kinds[0][1] == 4
    assert [m for m, _ in kinds[0][0]] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3
    assert cfg.mixers().count("mamba") == 28
    assert cfg.param_count() == 9_285_140_480
    small = cfg.reduced()
    assert (small.n_layers, small.d_model, small.n_heads,
            small.n_kv_heads, small.dt_rank) == (8, 256, 4, 4, 16)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", JAMBA, "qwen3-1.7b"])
def test_config_matches_jax(name):
    """Layer kinds, segments and parameter count of the full and reduced
    configs equal the JAX package's (the full Jamba keeps its experts:
    the config is made; the model refuses to be built from it)."""
    for reduce in (False, True):
        ours, theirs = get_config(name), _jax_cfg(name)
        if reduce:
            ours, theirs = ours.reduced(), theirs.reduced()
        assert ours.layer_kinds() == theirs.layer_kinds()
        assert ours.segments() == theirs.segments()
        assert ours.scan_period() == theirs.scan_period()
        assert ours.param_count() == theirs.param_count()
        assert ours.padded_vocab == theirs.padded_vocab


def test_model_refuses_moe_ffns():
    """Jamba's MoE FFNs, refused here until the MoE slice, are built
    (``tests/test_torch_moe.py`` serves them against the reference); the
    multi-token prediction loss, refused here until DeepSeek-V3 was
    ported, adds nothing to a model without MTP leaves, as in the
    reference (``"mtp" in params``)."""
    model = ST.init_model(get_config("jamba-v0.1-52b").reduced(),
                          device="cpu")
    kinds = [type(blk.ffn).__name__ for blk in model.layers]
    assert kinds == ["MLP", "MoE"] * 4
    assert not hasattr(model, "mtp")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        loss, metrics = D.lm_loss(model, toks, toks, mtp_weight=0.3,
                                  remat=False)
        base, _ = D.lm_loss(model, toks, toks, remat=False)
    assert torch.equal(loss, base) and "mtp" not in metrics


def test_params_from_jax_uses_every_leaf_once(jamba):
    """Each stacked JAX entry lands in exactly one port layer, the untied
    head included; a leaf the port has no place for raises."""
    jcfg, params, tcfg, model = jamba
    tree = jax.tree.map(np.asarray, params)
    n_jax = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    np.testing.assert_array_equal(model.lm_head.detach().numpy(),
                                  tree["lm_head"])
    np.testing.assert_array_equal(
        model.layers[6].mixer.A_log.detach().numpy(),
        tree["segments"]["seg0"]["pos6"]["mixer"]["A_log"][0])
    assert convert.jax_path("layers.6.mixer.w_x", tcfg) == \
        "segments/seg0/pos6/mixer/w_x"
    tree["segments"]["seg0"]["pos0"]["mixer"]["extra"] = np.zeros((1, 2))
    with pytest.raises(ValueError, match="unused"):
        convert.params_from_jax(tree, tcfg, "cpu")
