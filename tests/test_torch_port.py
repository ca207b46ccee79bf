"""The port's boundaries: what it imports, where its entry points run,
what it refuses, and its copies of the JAX package's numpy-only modules."""
import ast
import dataclasses
import itertools
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.gradsync import GradSyncConfig
from repro_torch.core.mesh import MeshAxes
from repro_torch.core.overlap import OverlapConfig
from repro_torch.launch import serve
from repro_torch.launch import steps as ST
from repro_torch.launch import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["init_model", "zeros_caches", "serve",
                                   "train"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no card and no device="cpu", an entry point raises instead of
    running somewhere else."""
    _no_card(monkeypatch)
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "init_model":
            ST.init_model(cfg)
        elif entry == "zeros_caches":
            ST.zeros_caches({"k": ((2, 4), torch.float32)})
        elif entry == "serve":
            serve.main(["--arch", "qwen3-1.7b", "--requests", "1"])
        else:
            train.main(["--arch", "qwen3-1.7b", "--steps", "1"])
    assert ST.resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off_for_float32_serving():
    torch.backends.cuda.matmul.allow_tf32 = True
    ST.resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--requests",
                "3", "--prompt-len", "6", "--gen", "3", "--slots", "2",
                "--page-size", "4", "--pages", "12", "--chunk", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
    assert "SERVE OK" in out


@pytest.mark.parametrize("flags", [["--arch", "jamba-v0.1-52b"],
                                   ["--mode", "fixed", "--telemetry"],
                                   ["--mesh", "1,2,1,1"]])
def test_serve_rejects_what_is_not_ported(flags):
    """The unported flags raise naming their ROADMAP item (``--telemetry``
    is ported for ``--mode continuous`` only); a mesh of more than one
    rank is served, but only under torch.distributed.run, and outside it
    raises naming WORLD_SIZE."""
    if "--mesh" in flags:
        exc, match = ValueError, "WORLD_SIZE"
    elif "--arch" in flags:
        exc, match = NotImplementedError, \
            "not ported.*'MoE and the expert axis'"
    else:
        exc, match = NotImplementedError, "not ported"
    with pytest.raises(exc, match=match):
        serve.main(["--arch", "qwen3-1.7b", "--device", "cpu", *flags])


def test_serve_overlap_on_one_rank_is_the_blocking_run():
    """``--overlap --z-chunks 2 --ar-chunks 2`` serves (it raised before the
    overlapped schedule was ported); on a mesh of one rank every ring is
    the plain GEMM, so the served ids and the last logits are bitwise
    those of the run without it."""
    flags = ["--arch", "qwen3-1.7b", "--device", "cpu", "--requests", "3",
             "--prompt-len", "6", "--gen", "3", "--slots", "2",
             "--page-size", "4", "--pages", "12", "--chunk", "4"]
    runs = []
    for extra in ([], ["--overlap", "--z-chunks", "2", "--ar-chunks", "2"]):
        args = serve.build_parser().parse_args(flags + extra)
        engine, stats, reqs = serve.run_continuous(args)
        runs.append(([r.generated for r in reqs], engine.last_logits))
    assert serve.overlap_config(args) == OverlapConfig.all_on(
        z_chunks=2, ar_chunks=2)
    (ids, logits), (ids_on, logits_on) = runs
    assert ids == ids_on and torch.equal(logits, logits_on)


def test_train_step_with_the_overlap_on_one_rank_is_the_blocking_step():
    """``TrainOptions(overlap=OverlapConfig.all_on())`` trains (it raised
    before); on one rank its three steps end with the blocking step's
    losses, grad norms and parameter bits."""
    from repro_torch.optim.adamw import AdamWConfig, init_state
    cfg = get_config("qwen3-1.7b").reduced()
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    runs = []
    for ov in (OverlapConfig(), OverlapConfig.all_on(z_chunks=2)):
        model = ST.init_model(cfg, device="cpu")
        state = init_state(dict(model.named_parameters()))
        step = ST.make_train_step(
            cfg, MeshAxes(), AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=10),
            ST.TrainOptions(dtype=torch.float32, overlap=ov))
        metrics = [{k: float(v) for k, v in step(
            model, state, {"tokens": toks, "labels": toks}).items()}
            for _ in range(3)]
        runs.append((metrics, ST.param_sha256(model)))
    assert runs[0] == runs[1]


def test_train_cli_on_cpu(capsys):
    res = train.main(["--arch", "qwen3-1.7b", "--preset", "smoke",
                      "--device", "cpu", "--steps", "3", "--batch", "4",
                      "--seq", "16", "--log-every", "1"])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert np.isfinite(res.grad_norms).all() and res.tokens_per_step == 64
    assert res.max_memory_bytes is None
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "final loss" in out


@pytest.mark.parametrize("flags,item", [
    (["--chaos", "seed=0"], "runtime tooling"),
    (["--probe-every", "2"], "runtime tooling"),
    (["--telemetry", "--probe-every", "2"], "runtime tooling"),
    (["--calib", "auto", "--chaos", "seed=0"], "runtime tooling"),
    (["--backend", "nccl"], "multi-rank mesh")])
def test_train_refuses_what_is_not_ported(flags, item):
    """The unported flags raise naming their ROADMAP item, beside the
    ported ``--telemetry`` and ``--calib`` too
    (tests/test_torch_telemetry.py runs those; tests/test_torch_trace.py
    runs the ported ``--profile-steps``)."""
    with pytest.raises(NotImplementedError, match=f"'{item}'"):
        train.main(["--arch", "qwen3-1.7b", "--device", "cpu", *flags])


@pytest.mark.parametrize("mesh", ["2,1,1,1", "1,2,1,1,2", "1,1,1,2,2"])
def test_train_on_a_mesh_needs_its_ranks(mesh):
    """Data, x, y, z and seq above 1 are trained (they raised before the
    mesh's training was ported), but only under torch.distributed.run:
    outside it a mesh of more than one rank raises naming WORLD_SIZE, as
    serving's does."""
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        train.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--mesh",
                    mesh])


@pytest.mark.parametrize("extra,item", [
    (dict(image_embeds=torch.zeros((2, 1, 64))),
     "other mixers and architectures")])
def test_train_step_refuses_what_is_not_ported(extra, item):
    """A batch the port's train step cannot train yet raises naming its
    ROADMAP.md §1 item (ZeRO-3, refused here before, is ported:
    ``tests/test_torch_zero3.py``)."""
    from repro_torch.optim.adamw import AdamWConfig, init_state
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(NotImplementedError, match=f"'{item}'"):
        step = ST.make_train_step(cfg, MeshAxes(), AdamWConfig(),
                                  ST.TrainOptions(dtype=torch.float32))
        model = ST.init_model(cfg, device="cpu")
        toks = torch.zeros((2, 4), dtype=torch.int32)
        step(model, init_state(dict(model.named_parameters())),
             {"tokens": toks, "labels": toks, **extra})


@pytest.mark.parametrize("sizes", [(2, 1, 1, 1), (1, 1, 2, 1),
                                   (1, 1, 1, 2), (2, 1, 1, 1, 2),
                                   (1, 2, 1, 1, 2)])
def test_mesh_factors_above_one_raise(sizes):
    """Factors above 1 on data, x, y and z are admitted (they raised
    before the mesh was ported): the sizes, the batch and token shards,
    the axis tuples, and the ranks' row-major coordinates."""
    axes = MeshAxes(sizes)
    full = tuple(sizes) + (1,) * (5 - len(sizes))
    assert axes.sizes == full and axes.world == math.prod(full)
    assert (axes.dp, axes.gx, axes.gy, axes.gz, axes.gseq) == full
    assert axes.tensor == full[1] * full[2] * full[3]
    assert axes.batch_shards == full[0] * full[3]
    assert axes.token_shards == full[0] * full[3] * full[4]
    assert axes.batch_axes() == ("data", "z")
    assert axes.token_axes() == ("data", "z", "seq")
    assert axes.all_names() == ("data", "x", "y", "z", "seq")
    coords = [axes.coords(r) for r in range(axes.world)]
    assert coords == list(itertools.product(*(range(n) for n in full)))


def test_mesh_admits_a_seq_axis():
    """A fifth factor is the seq axis; a 4-tuple means g_seq = 1."""
    axes = MeshAxes((1, 1, 1, 1, 2))
    assert (axes.gseq, axes.batch_shards, axes.token_shards) == (2, 1, 2)
    assert axes.token_axes() == ("data", "z", "seq")
    assert MeshAxes((1, 1, 1, 1)) == MeshAxes((1, 1, 1, 1, 1))
    for bad in ((1, 1, 1), (1, 1, 1, 1, 1, 1), (1, 1, 1, 1, 0)):
        with pytest.raises(ValueError, match="4 or 5 positive factors"):
            MeshAxes(bad)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "xlstm-350m",
                                  "deepseek-v3-671b"])
def test_unported_archs_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_full_width_config():
    cfg = get_config("qwen3-1.7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff) == (28, 2048, 16, 8, 128, 6144)
    assert cfg.padded_vocab == 152064
    assert cfg.segments() == (((("attn", "mlp"),), 28),)
    small = cfg.reduced()
    assert (small.n_layers, small.d_model, small.n_heads,
            small.n_kv_heads, small.head_dim_) == (2, 256, 4, 4, 64)


@pytest.mark.parametrize("name", ["pages.py", "scheduler.py"])
def test_serving_copies_match_the_jax_package(name):
    """pages.py and scheduler.py are copies; only the import path moves."""
    ours = (PORT / "launch" / "serving" / name).read_text()
    theirs = (ROOT / "src" / "repro" / "launch" / "serving" / name
              ).read_text()
    assert ours == theirs.replace("from repro.launch",
                                  "from repro_torch.launch")


def test_data_copy_matches_the_jax_package():
    """data/synthetic.py is a copy (it imports only numpy)."""
    ours = (PORT / "data" / "synthetic.py").read_text()
    theirs = (ROOT / "src" / "repro" / "data" / "synthetic.py").read_text()
    assert ours == theirs


def test_overlap_config_copy_matches_the_jax_package():
    """core/overlap.py is a byte-for-byte copy (it imports only
    dataclasses)."""
    ours = (PORT / "core" / "overlap.py").read_bytes()
    theirs = (ROOT / "src" / "repro" / "core" / "overlap.py").read_bytes()
    assert ours == theirs


def test_gradsync_config_copy_matches_the_jax_package():
    """core/gradsync.py's GradSyncConfig is a copy of the reference's
    class: the same source, fields, defaults and properties."""
    import inspect

    from repro.core import gradsync as JGS
    assert inspect.getsource(GradSyncConfig) == inspect.getsource(
        JGS.GradSyncConfig)
    assert [(f.name, f.default) for f in dataclasses.fields(GradSyncConfig)
            ] == [(f.name, f.default)
                  for f in dataclasses.fields(JGS.GradSyncConfig)]


def test_comm_model_copy_matches_the_jax_package():
    """core/comm_model.py (the paper's analytical model) is a copy of the
    reference's apart from its two import lines, which take the port's
    GradSyncConfig and OverlapConfig."""
    ours = (PORT / "core" / "comm_model.py").read_text().splitlines()
    theirs = (ROOT / "src" / "repro" / "core" / "comm_model.py"
              ).read_text().splitlines()
    imports = {"from repro.core.gradsync import GradSyncConfig":
               "from repro_torch.core.gradsync import GradSyncConfig",
               "from repro.core.overlap import OverlapConfig":
               "from repro_torch.core.overlap import OverlapConfig"}
    assert sum(line in imports for line in theirs) == 2
    assert ours == [imports.get(line, line) for line in theirs]
    from repro.core import comm_model as JCM
    from repro_torch.core import comm_model as CM
    assert CM.GradSyncConfig is GradSyncConfig
    for gs in (GradSyncConfig(), GradSyncConfig(zero=True),
               GradSyncConfig(zero3=True),
               GradSyncConfig(zero3=True, prefetch=True)):
        jgs = JCM.GradSyncConfig(**dataclasses.asdict(gs))
        for mb in (1, 3):
            assert CM.dp_sync_volume(8, 1e6, gs, mb) == \
                JCM.dp_sync_volume(8, 1e6, jgs, mb)


def test_trace_label_copy_matches_the_jax_package():
    """core/trace.py's ``label`` and ``_axis_str`` (plain Python) are the
    reference's, source for source."""
    import inspect

    from repro.core import trace as JT
    from repro_torch.core import trace
    for name in ("label", "_axis_str"):
        assert inspect.getsource(getattr(trace, name)) == \
            inspect.getsource(getattr(JT, name))


def test_serving_records_no_graph():
    """The parameters are trainable; the serving step runs under inference
    mode, so its logits carry no graph and the pools no history."""
    from repro_torch.models.decoder import paged_step
    cfg = get_config("qwen3-1.7b").reduced()
    model = ST.init_model(cfg, seed=0, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    _, ct = ST.make_paged_step(cfg, MeshAxes())(4, 4)
    pools = ST.zeros_caches(ct, "cpu")
    i32 = torch.int32
    logits, pools = paged_step(
        model, torch.ones((1, 2), dtype=i32), pools,
        torch.arange(2, dtype=i32)[None], torch.tensor([2], dtype=i32),
        torch.tensor([[1, 2, 3]], dtype=i32))
    assert logits.grad_fn is None and not logits.requires_grad
    assert pools["k"].grad_fn is None and pools["k"][:, 1].any()


def test_engine_serves_at_every_chunk_boundary():
    """Prompts shorter than, equal to and longer than a chunk, on a pool
    that forces preemption: every request completes, no page leaks."""
    from repro_torch.launch.serving import PagedEngine, Request, ServeConfig
    cfg = get_config("qwen3-1.7b").reduced()
    model = ST.init_model(cfg, seed=1, device="cpu")
    engine = PagedEngine(cfg, MeshAxes(), model,
                         ServeConfig(slots=4, page_size=4,
                                     pages_per_shard=8, chunk=4))
    engine.warmup()
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size, (L,)
                                              ).astype(np.int32), max_new=3)
            for i, L in enumerate((3, 4, 5, 9))]
    stats = engine.run(reqs)
    assert stats.total_new_tokens == 12 and stats.n_preemptions > 0
    assert all(r.state == "done" and len(r.generated) == 3 for r in reqs)
    assert torch.isfinite(engine.last_logits).all()
    for a in engine.sched.allocators:
        a.check()
        assert a.n_used == 0
