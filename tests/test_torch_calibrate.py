"""The port's calibration of the analytical model, held against the JAX
package on the CPU.

  * ``core/calibrate.py``'s fitting half is a copy of the reference's (its
    text, and ``fit_constants`` on the reference's synthetic samples to
    1e-12 relative), and a profile saved by either package loads in the
    other to equal ``HardwareParams``;
  * ``ArchConfig.comm_layers()`` and ``tp_constraints()`` equal the
    reference's for ``qwen3-1.7b`` and ``jamba-v0.1-52b-dense-ffn``, full
    and reduced;
  * ``mesh.ring_all_to_all`` and ``mesh.all_to_all`` are bitwise the
    reference's on 4 and 8 ranks (the reference on 8 forced host devices
    in this process), and the ring counts p - 1 hops;
  * ``run_calibration`` on a 4-rank world (tiny sizes, one repetition):
    the same finite, non-negative fit on every rank, samples of all six
    kinds on every mapped axis and on the tuple ring, each kind's counted
    hops the code's count (``calibrate.ring_hops``), and a profile that
    ``optimize_decomposition(objective="time")`` takes in both packages.

The ranks are ``torch.distributed.run`` launches of this file's
``__main__`` (gloo on the CPU), one of 4 ranks and one of 8, started
together while the JAX package computes its side.
"""
import dataclasses
import inspect
import math
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
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.core import calibrate as JCB
from repro.core import comm_model as JCM
from repro.core import mesh as JM
from repro.core.compat import shard_map
from repro.launch import mesh as LM
from repro_torch.configs import get_config
from repro_torch.core import calibrate as CB
from repro_torch.core import comm_model as CM
from repro_torch.core import mesh as M

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
JAMBA = "jamba-v0.1-52b-dense-ffn"
# fit_constants on the same samples: the same least-squares solve on the
# same float64 rows, so the constants agree to rounding
FIT_RTOL = 1e-12
# the all-to-all cases: (world, mesh, axis, dim, block shape); each rank
# holds block ``rank`` of a global array drawn from seed 5
A2A_CASES = [
    (4, (1, 2, 2, 1), "x", 0, (24, 5)),
    (4, (1, 2, 2, 1), "y", 0, (24, 5)),
    (4, (1, 2, 2, 1), ("x", "y"), 0, (24, 5)),
    (4, (1, 2, 2, 1), ("x", "y"), 1, (3, 24, 2)),
    (8, (1, 2, 2, 2), "z", 0, (24, 5)),
    (8, (1, 2, 2, 2), ("x", "y", "z"), 1, (3, 24, 2)),
    (8, (2, 2, 2, 1), ("data", "x"), 0, (24, 5)),
]
CALIB_SIZES = (64, 256, 1024)
CALIB_WORLD = 4


def _a2a_input(world, block):
    return np.random.RandomState(5).randn(world, *block).astype(np.float32)


# ---------------------------------------------------------------------- #
# the rank worker (this file's __main__ under torch.distributed.run)
# ---------------------------------------------------------------------- #

def _rank_worker(outdir: pathlib.Path, world: int) -> int:
    from repro_torch.launch.mesh import close_mesh, init_mesh
    run = init_mesh(M.MeshAxes((world, 1, 1, 1)), device="cpu")
    rank = run["rank"]
    out = {}
    try:
        for i, (w, shape, axis, dim, block) in enumerate(A2A_CASES):
            if w != world:
                continue
            axes = M.MeshAxes(shape)
            M.init_groups(axes)
            v = torch.from_numpy(_a2a_input(world, block)[rank])
            M.reset_comm()
            out[f"ring{i}"] = M.ring_all_to_all(v, axes, axis, dim=dim)
            out[f"ring_hops{i}"] = sum(c["calls"] for c in M.HOPS.values())
            M.reset_comm()
            out[f"blocking{i}"] = M.all_to_all(v, axes, axis, dim=dim)
            out[f"blocking_calls{i}"] = M.COMM["all_to_all"]["calls"]
        if world == CALIB_WORLD:
            prof = CB.run_calibration(None, sizes=CALIB_SIZES, reps=1,
                                      device="cpu")
            out["fit"] = (prof.gamma, prof.alpha, prof.link_bw, prof.fit_r2)
            if rank == 0:
                prof.save(str(outdir / "calib.json"))
    finally:
        close_mesh()
    torch.save(out, outdir / f"w{world}_rank{rank}.pt")
    return 0


# ---------------------------------------------------------------------- #
# the JAX side and the launches
# ---------------------------------------------------------------------- #

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _torchrun(world, args):
    """``args`` under ``torch.distributed.run`` on ``world`` ranks, in a
    session of its own (a timeout stops the launcher and every rank)."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), *args], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _wait(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    return out


def _jax_a2a(case):
    """The reference's ring and blocking all-to-all of the case, each
    rank's result in rank order."""
    world, shape, axis, dim, block = case
    mesh = LM.make_smoke_mesh(shape, ("data", "x", "y", "z"))
    spec = P(("data", "x", "y", "z"))
    g = jax.device_put(jnp.asarray(_a2a_input(world, block)),
                       NamedSharding(mesh, spec))
    outs = []
    for fn in (JM.ring_all_to_all, JM.all_to_all):
        body = shard_map(lambda v, fn=fn: fn(v[0], axis, dim=dim)[None],
                         mesh=mesh, in_specs=(spec,), out_specs=spec,
                         check_vma=False)
        outs.append(np.asarray(jax.jit(body)(g)))
    return outs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4- and 8-rank launches, started together; while they run, the
    reference's all-to-all results. Returns (each rank's results by world
    and rank, the reference's by case, the profile path)."""
    outdir = tmp_path_factory.mktemp("calibrate_ranks")
    procs = [_torchrun(w, [__file__, str(outdir), str(w)])
             for w in (CALIB_WORLD, 8)]
    try:
        ref = [_jax_a2a(case) for case in A2A_CASES]
    finally:
        for proc in procs:
            _wait(proc)
    ranks = {(w, r): torch.load(outdir / f"w{w}_rank{r}.pt")
             for w in (CALIB_WORLD, 8) for r in range(w)}
    return ranks, ref, outdir / "calib.json"


# ---------------------------------------------------------------------- #
# the fitting half: a copy
# ---------------------------------------------------------------------- #

def test_calibrate_copy_matches_the_jax_package():
    """Everything from ``from __future__`` to ``merge_probes`` is the
    reference's text apart from two places: the comm model's import, and
    ``default_path``'s backend, which the port takes from torch ("cuda"
    on the card, else "cpu") where the reference asks JAX.
    ``_hidden_fraction`` and ``spearman`` are copies too."""
    ours = (PORT / "core" / "calibrate.py").read_text()
    theirs = (ROOT / "src" / "repro" / "core" / "calibrate.py").read_text()
    end = "# Microbenchmark harness"

    def block(text):
        i = text.index("from __future__")
        return text[i:text.index(end, i)]
    changes = {
        "from repro.core import comm_model as CM\n":
            "from repro_torch.core import comm_model as CM\n",
        "        import jax\n        backend = jax.default_backend()\n":
            "        import torch\n        backend = \"cuda\" if "
            "torch.cuda.is_available() else \"cpu\"\n"}
    want = block(theirs)
    for old, new in changes.items():
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert block(ours) == want
    for name in ("_hidden_fraction", "spearman"):
        assert inspect.getsource(getattr(CB, name)) == inspect.getsource(
            getattr(JCB, name))


def _samples(mod, gamma, alpha, beta, ps=(2, 4),
             sizes=(1 << 10, 1 << 14, 1 << 18)):
    """tests/test_calibrate.py's synthetic samples, of package ``mod``."""
    out = []
    for p in ps:
        for kind in ("all_gather", "reduce_scatter", "all_reduce", "psum"):
            for n in sizes:
                steps, wire = mod.collective_geometry(kind, p, n * 4.0)
                out.append(mod.Sample(
                    kind=kind, axis="x", p=p, elems=n, steps=steps,
                    wire_bytes=wire,
                    seconds=gamma + steps * alpha + wire * beta))
    return out


@pytest.mark.parametrize("consts", [(8.1e-4, 3.7e-5, 2.2e-9),
                                    (1e-3, 0.0, 1e-9), (0.0, 5e-5, 1e-9)])
def test_fit_constants_matches_the_reference(consts):
    """The reference's synthetic samples (its three generating points):
    the port's fit gives the reference's (γ, α, β, R²) to FIT_RTOL."""
    ours = CB.fit_constants(_samples(CB, *consts))
    theirs = JCB.fit_constants(_samples(JCB, *consts))
    assert ours == pytest.approx(theirs, rel=FIT_RTOL, abs=1e-300)


def _profile(mod):
    return mod.CalibrationProfile(
        backend="cuda", n_devices=8, mesh_shape=(1, 2, 2, 2), alpha=4e-4,
        gamma=1.5e-3, link_bw=1.2e9, flops=3.1e12, overlap_efficiency=0.3,
        z_claims_first=False, cross_step_efficiency=0.6,
        bytes_per_elem=4.0, fit_r2=0.97,
        axis_fits=(mod.AxisFit("x", 2, 4e-4, 8e-10, 0.9, 18, gamma=1e-3),),
        probes={"overlap_z_hidden": 0.3, "hops:all_reduce@x": 1.0},
        samples=(mod.Sample("all_gather", "x", 2, 1024, 1, 2048.0, 1e-3),))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_profile_moves_between_the_packages(writer, tmp_path):
    """A profile saved by either package loads in the other, to equal
    fields and equal ``HardwareParams``."""
    src, dst = (CB, JCB) if writer == "port" else (JCB, CB)
    path = _profile(src).save(str(tmp_path / "p.json"))
    loaded, mine = dst.CalibrationProfile.load(path), _profile(dst)
    assert loaded == mine
    assert dataclasses.asdict(loaded.hardware_params()) == \
        dataclasses.asdict(src.CalibrationProfile.load(path)
                           .hardware_params())
    assert dataclasses.asdict(dst.resolve_hw(path)) == \
        dataclasses.asdict(src.resolve_hw(path))


# ---------------------------------------------------------------------- #
# the configs described to the model
# ---------------------------------------------------------------------- #

def _jax_cfg(arch):
    if arch == JAMBA:
        return dataclasses.replace(jax_get_config("jamba-v0.1-52b"),
                                   moe=None, name=JAMBA)
    return jax_get_config(arch)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", JAMBA])
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_comm_layers_match_the_reference(arch, size):
    """``comm_layers()`` and ``tp_constraints()`` give the reference's
    LayerShapes and Constraints, field for field, and the model prices
    them alike (``model_flops_per_token`` too)."""
    mine, ref = get_config(arch), _jax_cfg(arch)
    if size == "reduced":
        mine, ref = mine.reduced(), ref.reduced()
    ours, theirs = mine.comm_layers(), ref.comm_layers()
    assert [dataclasses.asdict(x) for x in ours] == \
        [dataclasses.asdict(x) for x in theirs]
    assert dataclasses.asdict(mine.tp_constraints(16)) == \
        dataclasses.asdict(ref.tp_constraints(16))
    assert CM.model_flops_per_token(mine) == \
        JCM.model_flops_per_token(ref)
    d = CM.Decomposition(2, 2, 2, 1)
    assert dataclasses.astuple(CM.predict_step_time(ours, 4096, d)) == \
        dataclasses.astuple(JCM.predict_step_time(
            theirs, 4096, JCM.Decomposition(2, 2, 2, 1)))


def test_comm_layers_refuse_the_moe_ffns():
    """Jamba's published MoE FFNs, refused here until the MoE slice, are
    priced as the reference prices them (``tests/test_torch_moe.py``
    compares every field); a mixer the port does not build is still
    refused, naming its item."""
    ours = get_config("jamba-v0.1-52b").comm_layers()
    assert [dataclasses.astuple(x) for x in ours] == [
        dataclasses.astuple(x)
        for x in jax_get_config("jamba-v0.1-52b").comm_layers()]
    assert sum(x.expert for x in ours) == 2 * 16
    odd = dataclasses.replace(get_config("qwen3-1.7b"),
                              mixer_pattern=("mlstm",))
    with pytest.raises(NotImplementedError,
                       match="'other mixers and architectures'"):
        odd.comm_layers()


# ---------------------------------------------------------------------- #
# the ranks
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("i", range(len(A2A_CASES)))
def test_all_to_all_matches_the_reference(world, i):
    """Every rank's ring and blocking all-to-all bitwise the reference's
    (each block travels once, either way); the ring makes p - 1 hops, the
    blocking form one gloo call."""
    ranks, ref, _ = world
    w, shape, axis, _, _ = A2A_CASES[i]
    p = M.MeshAxes(shape).size(axis)
    j_ring, j_blocking = ref[i]
    for r in range(w):
        out = ranks[(w, r)]
        assert np.array_equal(out[f"ring{i}"].numpy(), j_ring[r])
        assert np.array_equal(out[f"blocking{i}"].numpy(), j_blocking[r])
        assert out[f"ring_hops{i}"] == p - 1
        assert out[f"blocking_calls{i}"] == 1


def test_run_calibration_fits_the_same_constants_on_every_rank(world):
    """Finite, non-negative fits, overall and per axis, the same on every
    rank (each sample is reduced over the world before the fit), and
    samples of all six kinds at every size on each mapped axis of
    (1,1,2,2) and on the tuple ring y+z."""
    ranks, _, path = world
    prof = CB.CalibrationProfile.load(str(path))
    fits = {ranks[(CALIB_WORLD, r)]["fit"] for r in range(CALIB_WORLD)}
    assert len(fits) == 1
    assert prof.mesh_shape == (1, 1, 2, 2) and prof.backend == "cpu"
    for f in (prof, *prof.axis_fits):
        assert math.isfinite(f.gamma) and f.gamma >= 0
        assert math.isfinite(f.alpha) and f.alpha >= 0
    assert 0 < prof.link_bw < math.inf and 0 < prof.flops < math.inf
    assert [f.axis for f in prof.axis_fits] == ["y", "z", "y+z"]
    got = {(s.kind, s.axis, s.elems) for s in prof.samples}
    want = {(k, a, -(-n // p) * p) for k in CB._KINDS
            for a, p in (("y", 2), ("z", 2), ("y+z", 4))
            for n in CALIB_SIZES}
    assert got == want and len(prof.samples) == len(want)
    assert all(math.isfinite(s.seconds) and s.seconds >= 0
               for s in prof.samples)
    for k in ("overlap_z_hidden", "overlap_ar_hidden", "cross_step_hidden"):
        assert 0.0 <= prof.probes[k] <= 1.0


def test_run_calibration_counts_the_code_s_hops(world):
    """Each kind's ring hops a call, counted in ``mesh.HOPS`` over every
    timed call, equal ``ring_hops``: the model's geometry except at p = 2
    for all_reduce (one exchange of the whole buffer, where the geometry
    has 2 hops of half of it: the same wire bytes) and for the blocking
    psum (one gloo call, no hop)."""
    _, _, path = world
    prof = CB.CalibrationProfile.load(str(path))
    hops = {k[len("hops:"):]: v for k, v in prof.probes.items()
            if k.startswith("hops:")}
    assert len(hops) == 6 * 3
    for key, counted in hops.items():
        kind, axis = key.split("@")
        p = 4 if axis == "y+z" else 2
        assert counted == CB.ring_hops(kind, p), key
        model = CB.collective_geometry(kind, p, 1.0)[0]
        if kind == "psum" or (kind == "all_reduce" and p == 2):
            assert counted < model
        else:
            assert counted == model


def test_calibrated_profile_ranks_decompositions(world):
    """The fitted profile prices ``optimize_decomposition(objective=
    "time")`` for qwen3-1.7b on 8 ranks in the port, and the reference
    loads it and ranks the same candidates alike."""
    _, _, path = world
    hw = CB.resolve_hw(str(path))
    cfg = get_config("qwen3-1.7b")
    ours = CM.optimize_decomposition(
        list(cfg.comm_layers()), 8 * 512, 8, cfg.tp_constraints(8),
        top_k=5, objective="time", hw=hw)
    assert ours and all(math.isfinite(t) and t > 0 for _, t in ours)
    jcfg = _jax_cfg("qwen3-1.7b")
    theirs = JCM.optimize_decomposition(
        list(jcfg.comm_layers()), 8 * 512, 8, jcfg.tp_constraints(8),
        top_k=5, objective="time", hw=JCB.resolve_hw(str(path)))
    assert [(dataclasses.astuple(d), t) for d, t in ours] == \
        [(dataclasses.astuple(d), t) for d, t in theirs]


if __name__ == "__main__":
    sys.exit(_rank_worker(pathlib.Path(sys.argv[1]), int(sys.argv[2])))
