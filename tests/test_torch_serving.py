"""The port's serving slice held against the JAX package on the CPU.

The same weights (carried over with ``convert.params_from_jax``), tokens,
positions, valid-row counts and page tables go through JAX's
``make_paged_step`` on a (1, 1, 1, 1) mesh and through the port's
``paged_step``; the JAX and port engines serve the same requests. JAX
runs on the CPU; the port runs its kernels' plain versions there.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as LM
from repro.launch import steps as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.mesh import MeshAxes
from repro_torch.launch import steps as ST
from repro_torch.models import decoder as D

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCH = "qwen3-1.7b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = {"reduced": {}, "gqa": {"n_kv_heads": 2}}


@pytest.fixture(scope="module")
def jax_mesh():
    mesh = LM.make_smoke_mesh((1, 1, 1, 1))
    return mesh, LM.bind_4d(mesh)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request, jax_mesh):
    """(jax cfg, jax params, port cfg, port model) with equal weights."""
    kw = VARIANTS[request.param]
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    params, _ = JST.init_model(jcfg, jax_mesh[1], jax.random.PRNGKey(0),
                               dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, convert.params_from_jax(tree, tcfg, "cpu")


def _schedule(vocab, seed=0):
    """One prefill chunk (full, partial and idle slots) then decode rows:
    (tokens, positions, q_len) per step and the page table. Page 0 is the
    null page; slot 2 stays idle throughout."""
    rng = np.random.RandomState(seed)
    R, chunk, page, n_tab = 3, 8, 4, 4
    table = np.array([[3, 1, 6, 0], [2, 5, 4, 0], [0, 0, 0, 0]], np.int32)
    q_len = np.array([8, 5, 0], np.int32)
    tokens = np.zeros((R, chunk), np.int32)
    tokens[0] = rng.randint(1, vocab, chunk)
    tokens[1, :5] = rng.randint(1, vocab, 5)
    positions = np.broadcast_to(np.arange(chunk, dtype=np.int32),
                                (R, chunk)).copy()
    return (tokens, positions, q_len), table, page, 1 + 6


def _jax_step(jcfg, jax_mesh, n_pages, page):
    mesh, axes = jax_mesh
    build, _ = JST.make_paged_step(jcfg, mesh, axes, dtype=jnp.float32)
    fn, ct = build(n_pages, page)
    return fn, JST.zeros_caches(mesh, ct)


def _port_step(tcfg, n_pages, page):
    build = ST.make_paged_step(tcfg, MeshAxes())
    fn, ct = build(n_pages, page)
    return fn, ST.zeros_caches(ct, "cpu")


def test_paged_step_matches_jax(models, jax_mesh):
    """One prefill chunk and 3 decode steps: logits within 1e-4, greedy
    ids equal. The decode tokens are JAX's greedy ids, fed to both."""
    jcfg, params, tcfg, model = models
    (tokens, positions, q_len), table, page, n_pages = _schedule(
        jcfg.vocab_size)
    jfn, jpools = _jax_step(jcfg, jax_mesh, n_pages, page)
    tfn, tpools = _port_step(tcfg, n_pages, page)
    R = tokens.shape[0]
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
        # the next decode row of each live slot
        last = positions[np.arange(R), np.maximum(q_len - 1, 0)]
        live = q_len > 0
        tokens = np.where(live, ids, 0)[:, None].astype(np.int32)
        positions = np.where(live, last + 1, 0)[:, None].astype(np.int32)
        q_len = live.astype(np.int32)


def _paged_logits(model, cfg, prompts, chunk, page):
    """Chunked prefill of equal-length prompts, then one decode step."""
    R, L = prompts.shape
    n_tab = -(-(L + 1) // page)
    table = torch.tensor([[1 + r * n_tab + p for p in range(n_tab)]
                          for r in range(R)], dtype=torch.int32)
    fn, pools = _port_step(cfg, 1 + R * n_tab, page)
    pos = 0
    while pos < L:
        cl = min(chunk, L - pos)
        tokens = torch.zeros((R, chunk), dtype=torch.int32)
        tokens[:, :cl] = torch.from_numpy(prompts[:, pos:pos + cl])
        positions = (pos + torch.arange(chunk, dtype=torch.int32)
                     ).expand(R, chunk).contiguous()
        logits, pools = fn(model, tokens, pools, positions,
                           torch.full((R,), cl, dtype=torch.int32), table)
        pos += cl
    tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    logits, _ = fn(model, tok, pools, torch.full((R, 1), L,
                                                 dtype=torch.int32),
                   torch.ones(R, dtype=torch.int32), table)
    return logits


def test_chunked_prefill_bitwise_equals_oneshot(models):
    """tests/test_serving.py pins this for the JAX path; the port's plain
    path keeps it."""
    _, _, tcfg, model = models
    rng = np.random.RandomState(4)
    prompts = rng.randint(1, tcfg.vocab_size, (4, 8)).astype(np.int32)
    chunked = _paged_logits(model, tcfg, prompts, chunk=4, page=4)
    oneshot = _paged_logits(model, tcfg, prompts, chunk=8, page=4)
    assert torch.equal(chunked, oneshot)


def _virtual_clock():
    """Deterministic time source: each call advances 1 ms."""
    state = {"t": 0.0}

    def tick():
        state["t"] += 1e-3
        return state["t"]
    return tick


def test_engine_tokens_match_jax(models, jax_mesh):
    """Six requests of mixed lengths, staggered arrivals and a pool small
    enough to preempt: the port's engine generates JAX's tokens."""
    from repro.launch.serving import PagedEngine as JaxEngine
    from repro.launch.serving import Request as JaxRequest
    from repro.launch.serving import ServeConfig as JaxServeConfig
    from repro_torch.launch.serving import PagedEngine, Request, ServeConfig

    jcfg, params, tcfg, model = models
    mesh, axes = jax_mesh
    knobs = dict(slots=4, page_size=4, pages_per_shard=10, chunk=8)
    rng = np.random.RandomState(5)
    specs = [(rng.randint(1, jcfg.vocab_size, size=(int(rng.randint(3, 12)),)
                          ).astype(np.int32), int(rng.randint(2, 7)))
             for _ in range(6)]

    jeng = JaxEngine(jcfg, mesh, axes, params, JaxServeConfig(**knobs),
                     dtype=jnp.float32)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=n, arrival=0.002 * i)
             for i, (p, n) in enumerate(specs)]
    jeng.run(jreqs, time_fn=_virtual_clock())

    teng = PagedEngine(tcfg, MeshAxes(), model, ServeConfig(**knobs))
    treqs = [Request(rid=i, prompt=p, max_new=n, arrival=0.002 * i)
             for i, (p, n) in enumerate(specs)]
    stats = teng.run(treqs, time_fn=_virtual_clock())

    assert stats.n_requests == 6
    assert stats.total_new_tokens == sum(n for _, n in specs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.state == "done" and len(tr.generated) == tr.max_new
        assert tr.generated == jr.generated, tr.rid
    for a in teng.sched.allocators:
        a.check()
        assert a.n_used == 0, "pages leaked after drain"


def test_engine_sends_only_the_table_columns_in_use(models):
    """The step gets the table columns that hold its rows' pages, not a
    table as wide as the pool (K5's grid and workspace grow with the
    width): pools of 40 and 640 pages serve the same tokens through
    tables of the same widths."""
    from repro_torch.launch.serving import PagedEngine, Request, ServeConfig

    _, _, tcfg, model = models
    page = 4
    rng = np.random.RandomState(11)
    specs = [(rng.randint(1, tcfg.vocab_size, size=(int(rng.randint(3, 13)),)
                          ).astype(np.int32), int(rng.randint(2, 8)))
             for _ in range(6)]
    runs = {}
    for pages in (40, 640):
        eng = PagedEngine(tcfg, MeshAxes(), model, ServeConfig(
            slots=4, page_size=page, pages_per_shard=pages, chunk=8))
        widths, step = [], eng.step_fn

        def spy(model, tokens, pools, positions, q_len, table, step=step,
                widths=widths):
            valid = torch.arange(tokens.shape[1])[None] < q_len[:, None]
            assert int(positions[valid].max()) < table.shape[1] * page
            widths.append(table.shape[1])
            return step(model, tokens, pools, positions, q_len, table)
        eng.step_fn = spy
        reqs = [Request(rid=i, prompt=p, max_new=n, arrival=0.002 * i)
                for i, (p, n) in enumerate(specs)]
        stats = eng.run(reqs, time_fn=_virtual_clock())
        assert stats.n_preemptions == 0
        runs[pages] = ([r.generated for r in reqs], widths)
    assert runs[40] == runs[640]
    longest = max(len(p) + n for p, n in specs)
    assert max(runs[640][1]) == -(-(longest - 1) // page)


def test_paged_gate_rejects_non_attention_mixers():
    cfg = get_config(ARCH).reduced()

    class Hybrid(type(cfg)):
        def mixers(self):
            return ("mamba",) + ("attn",) * (self.n_layers - 1)

    hybrid = Hybrid(**dataclasses.asdict(cfg))
    with pytest.raises(NotImplementedError, match="softmax-attention"):
        D.decoder_paged_cache_specs(hybrid, MeshAxes(), 16, 4)
