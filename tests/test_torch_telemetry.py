"""The port's runtime telemetry and ``--calib``, held against the JAX
package on the CPU.

  * ``SCHEMA``, ``NULLABLE``, ``validate_record``, ``validate_file`` and
    ``DriftMonitor`` are copies of the reference's (their source), and
    ``DriftMonitor`` gives the reference's verdicts on the same ratio
    streams;
  * serve telemetry agrees with the engine's ``ServeStats``, as
    ``tests/test_telemetry.py::test_serve_telemetry_agrees_with_stats``
    holds the reference's, and ``serve.py --log-file`` writes one
    ``serve_step`` a plan;
  * ``train.py --calib <profile> --telemetry --log-file`` on one process
    and on (2,1,1,1) (two gloo ranks under ``torch.distributed.run``): the
    predicted step is bitwise the reference's ``predict_step_time`` for
    the same profile and flags, every JSONL passes the reference's
    ``validate_file``, the drift is merged into the profile, and the flags
    change no loss and no kernel launch.

Every JSONL is read with the reference's ``validate_file``. MFU never
divides by the TPU constants: with ``--calib`` it is the profile's rate,
without it the card's peak, and null off the card.
"""
import dataclasses
import inspect
import json
import os
import pathlib
import signal
import subprocess
import sys

import pytest

from repro.configs import get_config as jax_get_config
from repro.core import calibrate as JCB
from repro.core import comm_model as JCM
from repro.core.gradsync import GradSyncConfig as JGradSyncConfig
from repro.launch import telemetry as JTL
from repro_torch.core import calibrate as CB
from repro_torch.launch import serve, train
from repro_torch.launch import telemetry as TL

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
TRAIN_FLAGS = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
               "--steps", "4", "--batch", "4", "--seq", "16",
               "--log-every", "1"]
MESH_FLAGS = TRAIN_FLAGS + ["--mesh", "2,1,1,1", "--backend", "gloo"]
SERVE_FLAGS = ["--arch", ARCH, "--device", "cpu", "--requests", "4",
               "--prompt-len", "6", "--gen", "3", "--slots", "2",
               "--page-size", "4", "--pages", "12", "--chunk", "4"]


def _profile(path):
    """A fitted profile's shape, with made-up constants (seconds per call,
    per hop and per byte of the order gloo gives on one card)."""
    return CB.CalibrationProfile(
        backend="cpu", n_devices=8, mesh_shape=(1, 2, 2, 2), alpha=3e-4,
        gamma=1.7e-3, link_bw=1.1e9, flops=2.5e11, overlap_efficiency=0.4,
        z_claims_first=True, cross_step_efficiency=0.7, bytes_per_elem=2.0,
        fit_r2=0.95).save(str(path))


def _reference_prediction(path, flags):
    """The reference's predicted step for ``flags`` priced on ``path``, as
    its train.py computes it."""
    args = train.build_parser().parse_args(flags)
    jcfg = jax_get_config(args.arch).reduced()
    hw = dataclasses.replace(JCB.resolve_hw(str(path)), bytes_per_elem=4.0)
    return JCM.predict_step_time(
        list(jcfg.comm_layers()), args.batch * args.seq,
        JCM.Decomposition(*(int(x) for x in args.mesh.split(","))), hw,
        gradsync=JGradSyncConfig(), microbatches=args.overdecompose)


def _records(path):
    return [json.loads(x) for x in open(path) if x.strip()]


# ---------------------------------------------------------------------- #
# the copies
# ---------------------------------------------------------------------- #

def test_telemetry_copies_match_the_jax_package():
    """The schema and its checks, and the drift monitor, are the
    reference's source."""
    for name in ("validate_record", "validate_file", "DriftMonitor"):
        assert inspect.getsource(getattr(TL, name)) == \
            inspect.getsource(getattr(JTL, name)), name
    ours = (ROOT / "src" / "repro_torch" / "launch" /
            "telemetry.py").read_text()
    theirs = (ROOT / "src" / "repro" / "launch" / "telemetry.py").read_text()

    def schema(text):
        i = text.index("SCHEMA_VERSION = 1")
        return text[i:text.index("def validate_record", i)]
    assert schema(ours) == schema(theirs)
    assert (TL.SCHEMA, TL.NULLABLE, TL.SCHEMA_VERSION) == \
        (JTL.SCHEMA, JTL.NULLABLE, JTL.SCHEMA_VERSION)


STREAMS = {
    # in band throughout
    "steady": ([1.0, 1.1, 0.9, 1.05, 1.0, 0.95, 1.02], {}),
    # out of band above, back in, out below (one warning per excursion)
    "excursions": ([1.0] * 5 + [2.5] * 8 + [1.0] * 20 + [0.3] * 40,
                   dict(window=8)),
    # a narrow band and an early verdict
    "narrow": ([1.0, 1.3, 1.25, 1.4, 0.7, 1.6, 1.2, 1.21],
               dict(band=0.2, min_steps=2, window=4)),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_drift_monitor_verdicts_match_the_reference(stream):
    """The same measured stream gives the reference's rolling ratio,
    band verdict, warning and record at every step."""
    times, kw = STREAMS[stream]
    ours, theirs = TL.DriftMonitor(0.04, **kw), JTL.DriftMonitor(0.04, **kw)
    for t in times:
        step_s = 0.04 * t
        assert ours.update(step_s) == theirs.update(step_s)
        assert ours.out_of_band == theirs.out_of_band
        assert ours.check() == theirs.check()
        assert ours.record(workload="w") == theirs.record(workload="w")


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #

def test_serve_telemetry_agrees_with_stats(tmp_path):
    """The reference's test on the port's recorder: serve_step records +
    close(extra=stats) leave a file whose summary quotes the engine's own
    tokens/s; off the card there is no peak memory and no MFU."""
    path = str(tmp_path / "serve.jsonl")
    telem = TL.Telemetry("srv", path=path, verbose=False, device="cpu")
    total = 0
    for s in range(5):
        telem.serve_step(s, 0.001, new_tokens=3, queue_depth=1,
                         active=3, page_util=0.5, preemptions=0)
        total += 3
    engine_tok_s = 1234.5
    telem.close(extra={"tok_s": engine_tok_s, "tokens": total,
                       "steps": 5})
    assert JTL.validate_file(path) == 7
    summary = json.loads(open(path).readlines()[-1])
    assert summary["tok_s"] == engine_tok_s
    assert summary["tokens"] == total == telem.serve_tokens
    assert summary["peak_bytes"] is None and summary["mfu"] is None
    assert TL.card_peak_flops("cpu", "float32") == 0.0


def test_serve_cli_telemetry_agrees_with_the_engine(tmp_path):
    """``serve.py --log-file``: one serve_step a plan, whose new tokens sum
    to the engine's; the summary's tokens/s, steps and latencies are the
    engine's ``ServeStats``; the MFU denominator is no TPU constant (0 off
    the card, so MFU is null)."""
    path = tmp_path / "serve.jsonl"
    args = serve.build_parser().parse_args(SERVE_FLAGS + ["--log-file",
                                                          str(path)])
    _, stats, _ = serve.run_continuous(args)
    assert JTL.validate_file(str(path)) == stats.n_steps + 2
    recs = _records(path)
    steps = [r for r in recs if r["kind"] == "serve_step"]
    assert [r["step"] for r in steps] == list(range(stats.n_steps))
    assert sum(r["new_tokens"] for r in steps) == stats.total_new_tokens
    assert {r["step_kind"] for r in steps} <= {"mixed", "decode"}
    summary = recs[-1]
    assert (summary["tok_s"], summary["steps"], summary["ttft_p99_ms"],
            summary["latency_p50_ms"]) == (
        stats.tokens_per_s, stats.n_steps, stats.ttft_p99_ms,
        stats.latency_p50_ms)
    assert recs[0]["peak_flops"] == 0.0 and summary["mfu"] is None


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #

def test_train_calib_telemetry_on_one_process(tmp_path, capsys):
    """``--calib --telemetry --log-file`` on one process: the predicted
    step bitwise the reference's, a valid JSONL of one train_step per step
    after the first, MFU over the profile's rate, the end-of-run line, the
    drift merged into the profile; the same losses, grad norms and kernel
    launches as the run without the flags."""
    prof, log = tmp_path / "cpu.json", tmp_path / "train.jsonl"
    _profile(prof)
    plain = train.main(TRAIN_FLAGS)
    res = train.main(TRAIN_FLAGS + ["--calib", str(prof), "--telemetry",
                                    "--log-file", str(log)])
    assert (res.losses, res.grad_norms, res.launches) == \
        (plain.losses, plain.grad_norms, plain.launches)
    want = _reference_prediction(prof, TRAIN_FLAGS)
    assert res.predicted == dict(total=want.total, compute=want.compute,
                                 exposed_comm=want.exposed_comm,
                                 hidden_comm=want.hidden_comm)
    assert plain.predicted is None
    n = JTL.validate_file(str(log))
    recs = _records(log)
    steps = [r for r in recs if r["kind"] == "train_step"]
    assert n == len(steps) + 3 and [r["step"] for r in steps] == [1, 2, 3]
    assert [r["loss"] for r in steps] == res.losses[1:]
    meta = recs[0]
    assert meta["predicted_step_s"] == want.total
    assert meta["peak_flops"] == CB.CalibrationProfile.load(
        str(prof)).flops
    assert all(r["mfu"] > 0 and r["drift"] > 0 for r in steps)
    out = capsys.readouterr().out
    assert f"calib[{prof}]: predicted step {want.total * 1e3:.2f} ms" in out
    probes = CB.CalibrationProfile.load(str(prof)).probes
    assert probes["drift:qwen3-1.7b-smoke@1,1,1,1"] == recs[-2]["ratio"]


def test_train_telemetry_without_calib_has_no_tpu_peak(tmp_path):
    """``--telemetry`` alone: no prediction and no drift; MFU's
    denominator is the card's own peak, 0 on the CPU, so MFU is null."""
    log = tmp_path / "train.jsonl"
    res = train.main(TRAIN_FLAGS + ["--log-file", str(log)])
    assert res.predicted is None
    JTL.validate_file(str(log))
    recs = _records(log)
    assert recs[0]["peak_flops"] == 0.0
    assert recs[0]["predicted_step_s"] is None
    assert all(r["mfu"] is None and r["drift"] is None
               for r in recs if r["kind"] == "train_step")
    assert not any(r["kind"] == "drift" for r in recs)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def test_train_calib_on_a_mesh_predicts_the_reference_step(tmp_path):
    """``train.py --calib --telemetry --log-file`` on (2,1,1,1), two gloo
    ranks: rank 0's report carries the reference's predicted step
    bitwise, its JSONL is valid, and the profile gains the run's drift."""
    prof, log = tmp_path / "cpu.json", tmp_path / "mesh.jsonl"
    _profile(prof)
    flags = MESH_FLAGS + ["--calib", str(prof), "--telemetry",
                          "--log-file", str(log)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    report = json.loads(next(x for x in out.splitlines()
                             if x.startswith('{"train"')))["train"]
    want = _reference_prediction(prof, MESH_FLAGS)
    assert report["predicted"] == dict(
        total=want.total, compute=want.compute,
        exposed_comm=want.exposed_comm, hidden_comm=want.hidden_comm)
    assert want.exposed_comm > 0          # the data axis's gradient psum
    assert "calib[" in out and "drift record merged" in out
    assert JTL.validate_file(str(log)) == 3 + 3
    assert _records(log)[0]["mesh"] == [2, 1, 1, 1]
    assert "drift:qwen3-1.7b-smoke@2,1,1,1" in CB.CalibrationProfile.load(
        str(prof)).probes
