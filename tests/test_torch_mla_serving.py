"""DeepSeek served, and DeepSeek-V3's compressed query and MTP loss, held
against the JAX package on the CPU.

In this process, on seeded numpy inputs, torch on one thread, on
``deepseek-v2-lite-16b`` reduced (d 256, 4 heads; MLA's latent 64, q/k
48 = 32 + 16 rotary, v 32; layer 0 dense, layer 1 MoE) and
``deepseek-v3-671b`` reduced (the same widths with a compressed query of
32, sigmoid-scored experts, and the MTP module):
  * the ``MLA`` layer's ``"prefill"`` and ``"decode"`` against
    ``mla_apply``: the output and both latent caches;
  * ``decoder.prefill`` + 3 ``decode_step``s against the reference's
    ``make_prefill_step``/``make_decode_step`` on (1,1,1,1): logits, and
    every layer's caches through ``convert.caches_from_jax``;
  * the absorbed decode of token T equal to a prefill of T + 1 tokens'
    last row (the latent cache against the materialised heads);
  * V3's compressed query in mode ``"train"``: output and every gradient
    against ``mla_apply``; ``lm_loss(mtp_weight=0.3)``, its MTP term and
    every gradient leaf against ``jax.grad`` of the reference's;
  * V3's parameters across both ways, with the reference's paths and
    PartitionSpecs, and its parameter counts;
  * the reference's compressed-query gradients on (1,1,2,1), pinned: whole
    on each y rank (unlike its rotary key's, ``tests/test_torch_mla.py``);
  * the refusals the reference keeps (continuous serving, seqshard), and
    ``serve.py --mode fixed`` on the CPU at ``--preset smoke``.

The mesh runs (fixed serving on (1,2,2,1) and (1,1,2,2), a V3 step's
gradient blocks on (1,1,2,1)) are in ``tests/test_torch_mla.py``'s 4-rank
launch. K7's CUDA source runs in ``tests/test_torch_k7_emulated.py``.

Tolerances: float32; the layer's output and caches rtol = atol = 1e-5
(``tests/test_torch_mla.py``'s FN_TOL), logits rtol = atol = 1e-4
(``tests/test_torch_hybrid.py``'s LOGIT_TOL: two frameworks, several
layers), the loss rtol 1e-5 and each gradient leaf max |dg| <= 1e-4 max
|g| (``tests/test_torch_mesh_train.py``'s).
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core.compat import shard_map
from repro.core.partition import unbox
from repro.launch import steps as JST
from repro.layers import attention as JA
from repro.models import decoder as JD
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.partition import JAX_LEAF_NAMES
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.layers import attention as A
from repro_torch.models import decoder as D

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_mesh_train as MT  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

V2, V3 = "deepseek-v2-lite-16b", "deepseek-v3-671b"
FN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL, GRAD_REL = MT.LOSS_RTOL, MT.GRAD_REL
MTP_WEIGHT = 0.3


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _mla_layer(arch, seed=7):
    """The reference's MLA weights (global, one device) and the port's
    layer holding them."""
    jcfg, tcfg = _cfgs(arch)
    _, axes = MT._jax_mesh((1, 1, 1, 1))
    jp, _ = unbox(JA.mla_init(jax.random.PRNGKey(seed), jcfg, axes,
                              dtype=jnp.float32))
    layer = A.MLA(tcfg, MeshAxes(), gen=torch.Generator())
    with torch.no_grad():
        for n, prm in layer.named_parameters():
            prm.copy_(torch.from_numpy(np.array(jp[JAX_LEAF_NAMES.get(n,
                                                                      n)])))
    return jcfg, tcfg, jp, layer


# ---------------------------------------------------------------------- #
# 1. the layer
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", [V2, V3])
def test_mla_prefill_and_decode_match_mla_apply(arch):
    """Prefill of 11 tokens into a 16-row latent cache, then decode at
    positions 11 and 12: each step's output and both caches against
    ``mla_apply`` in the same mode on the same weights."""
    jcfg, tcfg, jp, layer = _mla_layer(arch)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    B, T, S = 2, 11, 16
    m = tcfg.mla
    rng = np.random.RandomState(9)
    hs = rng.randn(B, T + 2, tcfg.d_model).astype(np.float32)
    zeros = {"ckv": np.zeros((B, S, m.kv_lora_rank), np.float32),
             "k_rope": np.zeros((B, S, m.qk_rope_dim), np.float32)}

    def jrun(mode, h, pos, cache):
        def f(p, h, c):
            return JA.mla_apply(p, h, jcfg, axes, positions=pos, mode=mode,
                                cache=c)
        g = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()),
                      out_specs=(P(), P()), check_vma=False)
        out, c = jax.jit(g)(jp, jnp.asarray(h), cache)
        return np.asarray(out), jax.tree.map(np.asarray, c)

    steps = [("prefill", slice(0, T), np.arange(T))] + [
        ("decode", slice(T + i, T + i + 1), np.array([T + i]))
        for i in range(2)]
    jc = {k: jnp.asarray(v) for k, v in zeros.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in zeros.items()}
    for mode, rows, pos in steps:
        pos = np.broadcast_to(pos.astype(np.int32), (B, len(pos))).copy()
        want, jc = jrun(mode, hs[:, rows], jnp.asarray(pos), jc)
        with torch.inference_mode():
            got = layer(torch.from_numpy(hs[:, rows].copy()),
                        positions=torch.from_numpy(pos), mode=mode,
                        cache=tc)
        np.testing.assert_allclose(got.numpy(), want, **FN_TOL,
                                   err_msg=mode)
        for k in zeros:
            np.testing.assert_allclose(tc[k].numpy(), jc[k], **FN_TOL,
                                       err_msg=f"{mode} {k}")
    assert tc["ckv"][:, T + 2:].abs().max() == 0


def test_compressed_query_train_branch_matches_mla_apply():
    """V3's layer in mode "train": the output and the gradients of every
    weight (w_dq, the latent's gain, w_uq among them) and of its input
    against ``mla_apply``."""
    jcfg, tcfg, jp, layer = _mla_layer(V3)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    rng = np.random.RandomState(8)
    h = rng.randn(2, 20, jcfg.d_model).astype(np.float32)
    dout = rng.randn(2, 20, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()

    def f(p, h, dout):
        o, pull = jax.vjp(lambda p, h: JA.mla_apply(
            p, h, jcfg, axes, positions=jnp.asarray(pos), mode="train")[0],
            p, h)
        return o, pull(dout)
    g = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()),
                  out_specs=(P(), P()), check_vma=False)
    want, (jdp, jdh) = jax.jit(g)(jp, jnp.asarray(h), jnp.asarray(dout))
    ht = torch.from_numpy(h).requires_grad_()
    out = layer(ht, positions=torch.from_numpy(pos), mode="train")
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FN_TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jdh), **FN_TOL)
    names = {n for n, _ in layer.named_parameters()}
    assert {"w_dq", "cq_norm", "w_uq"} <= names and "w_q" not in names
    for n, prm in layer.named_parameters():
        w = np.asarray(jdp[JAX_LEAF_NAMES.get(n, n)])
        err = np.abs(prm.grad.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (n, err)


def test_reference_compressed_query_gradients_are_whole_on_each_y_rank():
    """The reference on (1,1,2,1): unlike the shared rotary key's (a fault,
    ``tests/test_torch_mla.py``), the compressed query's latent reaches
    the y-sharded heads through w_uq's ``tp_matmul``, whose backward
    psums the latent's gradient over y, so each y rank's w_dq and
    q_norm gradients are the one-device ones. The port sums nothing more
    (``partition.LEAF_SPECS["cq_norm"]`` carries no y flag)."""
    import test_torch_moe as TM
    jcfg, _ = _cfgs(V3)
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
    for leaf in ("w_dq", "q_norm"):
        w1 = np.asarray(g1[leaf][0])
        for yr in range(2):
            err = np.abs(np.asarray(g2[leaf][yr]) - w1).max()
            assert err <= GRAD_REL * np.abs(w1).max(), (leaf, yr, err)


# ---------------------------------------------------------------------- #
# 2. fixed-batch serving of the model
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module", params=[V2, V3])
def served(request):
    jcfg, tcfg = _cfgs(request.param)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    params, _ = JST.init_model(jcfg, axes, jax.random.PRNGKey(1),
                               dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, convert.params_from_jax(tree, tcfg, "cpu")


def _jax_fixed(jcfg, params, tokens, gen):
    """The reference's prefill and gen - 1 decode steps fed its greedy
    ids: per step (logits, caches as numpy, greedy ids)."""
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
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


def test_prefill_and_decode_steps_match_the_reference(served):
    """Prefill of 4 prompts of 10 tokens, then 3 decode steps fed the
    reference's greedy ids: logits, greedy ids, and every layer's latent
    cache against the reference's stacked caches."""
    jcfg, params, tcfg, model = served
    B, T, GEN = 4, 10, 4
    tokens = np.random.RandomState(5).randint(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    want = _jax_fixed(jcfg, params, tokens, GEN)
    S = T + GEN
    pre_fn, ct = ST.make_prefill_step(tcfg, MeshAxes())(B, T, S)
    dec_fn, ct2 = ST.make_decode_step(tcfg, MeshAxes())(B, S)
    assert ct == ct2 and set(ct[0]) == {"ckv", "k_rope"}
    caches = ST.zeros_caches(ct, "cpu")
    logits, caches = pre_fn(model, caches, torch.from_numpy(tokens))
    for i, (jl, jc, ids) in enumerate(want):
        np.testing.assert_allclose(logits.numpy(), jl, **LOGIT_TOL,
                                   err_msg=f"step {i}")
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), ids), i
        for layer, (got, exp) in enumerate(zip(
                caches, convert.caches_from_jax(jc, tcfg))):
            assert got.keys() == exp.keys() == {"ckv", "k_rope"}
            for k in exp:
                np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(),
                                           **LOGIT_TOL,
                                           err_msg=f"step {i} {layer} {k}")
        if i + 1 < GEN:
            logits, caches = dec_fn(model, caches,
                                    torch.from_numpy(ids[:, None]), T + i)


def test_absorbed_decode_equals_the_materialised_prefill(served):
    """The decode of token T over the latent cache of T prompt tokens
    gives the logits of a prefill of all T + 1 tokens' last row, which
    expands the latent to every head's K and V. At a capacity factor
    where no expert queue overflows (E / top_k): the two runs route
    different token counts, so a capacity that drops would drop
    different tokens in each."""
    _, params, tcfg, _ = served
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=tcfg.moe.n_experts / tcfg.moe.top_k))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    "cpu")
    B, T = 3, 13
    tokens = torch.from_numpy(np.random.RandomState(6).randint(
        0, tcfg.vocab_size, (B, T + 1)).astype(np.int32))
    pre_fn, ct = ST.make_prefill_step(tcfg, MeshAxes())(B, T, T + 1)
    dec_fn, _ = ST.make_decode_step(tcfg, MeshAxes())(B, T + 1)
    _, caches = pre_fn(model, ST.zeros_caches(ct, "cpu"), tokens[:, :T])
    absorbed, _ = dec_fn(model, caches, tokens[:, T:], T)
    pre_all, _ = ST.make_prefill_step(tcfg, MeshAxes())(B, T + 1, T + 1)
    whole, _ = pre_all(model, ST.zeros_caches(ct, "cpu"), tokens)
    np.testing.assert_allclose(absorbed.numpy(), whole.numpy(), **LOGIT_TOL)


def test_serve_fixed_runs_deepseek_v3_on_the_cpu():
    """``serve.py --mode fixed --arch deepseek-v3-671b --preset smoke`` on
    the CPU: the greedy ids of the batch, finite logits; the continuous
    mode keeps the reference's refusal, naming the fixed path."""
    flags = ["--arch", V3, "--preset", "smoke", "--device", "cpu"]
    res = serve.run_fixed(serve.build_parser().parse_args(
        flags + ["--mode", "fixed", "--batch", "2", "--prompt-len", "8",
                 "--gen", "4"]))
    assert res.ids.shape == (2, 4) and torch.isfinite(res.logits).all()
    assert res.launches["mla_decode"] == 0      # the CPU runs plain
    with pytest.raises(NotImplementedError, match="--mode fixed"):
        serve.main(flags + ["--requests", "2", "--gen", "2"])


def test_mla_serving_keeps_the_references_refusals():
    """The paged cache (continuous serving) and the seq-sharded decode
    cache refuse MLA, as the reference's ``decoder_paged_cache_specs``
    and ``decoder_cache_specs`` do."""
    _, tcfg = _cfgs(V2)
    with pytest.raises(NotImplementedError, match="softmax-attention"):
        D.decoder_paged_cache_specs(tcfg, MeshAxes(), 8, 4)
    with pytest.raises(ValueError, match="seqshard"):
        D.decoder_cache_specs(tcfg, MeshAxes(), 2, 8, seqshard=True)
    specs = D.decoder_cache_specs(tcfg, MeshAxes((2, 1, 1, 2)), 8, 12)
    assert specs[0] == {"ckv": ((2, 12, 64), torch.float32),
                        "k_rope": ((2, 12, 16), torch.float32)}


# ---------------------------------------------------------------------- #
# 3. DeepSeek-V3: the MTP loss, the parameters, the config
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def v3_tree():
    return MT._init_tree(_cfgs(V3)[0], (1, 1, 1, 1))


def test_v3_loss_mtp_and_every_gradient_match_the_reference(v3_tree):
    """``lm_loss(mtp_weight=0.3)`` on reduced V3: the loss, its xent, aux
    and MTP terms, and every gradient leaf (the MTP module's among them)
    against ``jax.value_and_grad`` of the reference's."""
    jcfg, tcfg = _cfgs(V3)
    mesh, axes = MT._jax_mesh((1, 1, 1, 1))
    rng = np.random.RandomState(11)
    tokens, labels = (rng.randint(0, tcfg.vocab_size, (2, 12)
                                  ).astype(np.int32) for _ in range(2))

    def f(p, t, lab):
        (loss, met), g = jax.value_and_grad(
            lambda p: JD.lm_loss(p, jcfg, axes, t, lab, remat=True,
                                 mtp_weight=MTP_WEIGHT), has_aux=True)(p)
        return loss, met, g
    g = shard_map(f, mesh=mesh, in_specs=(P(), P(), P()),
                  out_specs=(P(), P(), P()), check_vma=False)
    jloss, jmet, jgrads = jax.jit(g)(jax.tree.map(jnp.asarray, v3_tree),
                                     jnp.asarray(tokens), jnp.asarray(labels))
    model = convert.params_from_jax(v3_tree, tcfg, "cpu")
    loss, metrics = D.lm_loss(model, torch.from_numpy(tokens),
                              torch.from_numpy(labels), remat=True,
                              mtp_weight=MTP_WEIGHT)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for k in ("xent", "aux", "mtp"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    paths = convert.jax_paths(model)
    jg = convert._flat_tree(jax.tree.map(np.asarray, jgrads))
    for n, p in model.named_parameters():
        want = _stacked_entry(jg[paths[n]], n, tcfg)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (n, err)
    assert any(n.startswith("mtp.block.mixer.w_dq")
               for n, _ in model.named_parameters())


def _stacked_entry(a, name, cfg):
    return (a[cfg.layer_slots()[int(name.split(".")[1])][2]]
            if name.startswith("layers.") else a)


def test_v3_params_cross_both_ways(v3_tree):
    """Reduced V3's JAX tree (the MTP module and the compressed query's
    ``q_norm`` among its leaves) through ``params_from_jax`` and
    ``params_to_jax`` gives back its leaves bitwise; the port's paths and
    PartitionSpecs are the reference's."""
    jcfg, tcfg = _cfgs(V3)
    model = convert.params_from_jax(v3_tree, tcfg, "cpu")
    back = convert._flatten(convert.params_to_jax(model))
    want = convert._flatten(v3_tree)
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)
    assert {"mtp.w_comb_o", "mtp.block.mixer.q_norm",
            "segments.seg0.pos0.mixer.q_norm"} <= want.keys()
    _, jaxes = MT._jax_mesh((1, 1, 1, 1))
    _, jspecs = JST.init_model(jcfg, jaxes, abstract=True,
                               dtype=jnp.float32)
    ours = convert._flatten(convert.jax_specs(model))
    theirs = convert._flatten(jax.tree.map(
        lambda s: s.spec, jspecs, is_leaf=lambda s: hasattr(s, "spec")))
    assert ours.keys() == theirs.keys()
    for k in ("mtp.w_comb_h", "mtp.w_comb_o", "segments.seg0.pos0.mixer.w_dq",
              "segments.seg0.pos0.mixer.q_norm",
              "segments.seg0.pos0.mixer.w_uq"):
        assert tuple(ours[k]) == tuple(theirs[k]), k


@pytest.mark.parametrize("reduced", [False, True])
def test_v3_config_counts_are_the_references(reduced):
    """The registry's V3 against the reference's: the fields, and the
    parameter counts, full (580-720 B in the reference's own check) and
    reduced."""
    ours, theirs = get_config(V3), jax_get_config(V3)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert ours.mtp_depth == theirs.mtp_depth == 1
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert ours.layer_kinds() == theirs.layer_kinds()
    if not reduced:
        assert 580e9 <= ours.param_count() <= 720e9
    model_free = dataclasses.asdict(ours)
    assert model_free["mla"]["q_lora_rank"] == (32 if reduced else 1536)
