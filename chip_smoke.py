#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch built for CUDA. It builds the hand-written
kernels from ``src/repro_torch/kernels/csrc`` and runs these phases, each
a hard failure:

  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: one nvcc per kernel source, all at once;
  3. each kernel against its plain PyTorch version on the card, at the
     serving and training paths' shapes, in float32 and bfloat16:
     K3 RMSNorm (also at training's and Jamba's shapes; a row normed
     alone gives the bits it gets among 1,024; its stats and apply passes
     at the mesh path's local width, stats then apply on a whole row
     bitwise the single pass), K5 paged attention
     (chunked == one-shot bitwise; also over Jamba's dense decode cache
     seen as 32-row pages), K1 block
     matmul in the three layouts of training, at the Mamba layer's widths
     and in the middle band of M (each run twice: the same bits), K2
     flash attention forward and backward (also at Jamba's
     prefill shape; the forward run twice gives the same bits, as
     rematerialization needs); K1, K2's forward and K5 also at the local
     shapes of the (1,2,2,1) mesh (phase 11); K1 (its products, their dX
     and dW, the tied head's three), K2 forward and backward and K3's
     stats and apply passes at the local shapes of training on (1,2,2,2)
     (phase 12), K1's float32 output for bf16 operands at the dW shapes,
     K1 at the ring-hop shapes of phase 13a (a column slice of dY or h
     as an operand); K1 at Jamba's local shapes on (1,2,2,1) and
     (2,1,2,1) and K2's forward at its mesh prefill (phase 14); K5 with
     its log-sum-exp at the seq-sharded decode's shard of 262,144 keys
     (a row with every key, a few, none, past the table; the output
     bitwise the call without the lse);
     K6 selective scan at the prefill and decode shapes, also at the
     4,096 channels of g_y = 2 (y and final state; two runs give the
     same bits);
  4. full-width qwen3-1.7b (float32, random weights from a seed): one
     prefill chunk and 4 decode steps through ``paged_step`` with the
     kernels and with the plain versions; logits must agree;
  5. the continuous-batching engine serves 16 requests at full width;
     every request completes, logits are finite, and each kernel's launch
     count (K5's combine reported apart) is the expected count per step
     times the steps run; a profile of a short serving run; then the same
     requests on a pool 64 times larger: the same tokens, no more memory
     above the resident, and its profile;
  6. per-kernel times (CUDA events) at the paths' shapes, beside the plain
     version, one PyTorch library call where one exists (for attention
     SDPA pinned to its memory-efficient backend) and the least time the
     card could take, with the attention kernels' TFLOP/s; the backwards
     as the median of several eager rounds, their spread printed; K1 also
     in bfloat16 at the forward and decode
     shapes, beside bfloat16 ``torch.matmul``; K3 at the serving,
     training and Jamba shapes beside ``F.rms_norm``, its stats and apply
     passes at the mesh path's local width; K5 at serving's
     decode and
     chunked-prefill shapes and at Jamba's dense decode (each also held
     to its plain version), K2's forward also at Jamba's prefill shape;
     K6 at Jamba's prefill and decode shapes and, in bfloat16, the
     prefill, with the SFU floor (its exps at 16 a clock per SM) beside
     the bound;
  7. full-width training parity: the loss and every gradient of one
     microbatch (2 x 512 tokens) through the kernels and through the plain
     versions, before any optimizer state exists; the kernels' run twice
     gives the same bits (loss and every gradient);
  8. training: the serving model is freed, then ``launch/train.py`` runs
     3 full-width steps (batch 4 x 512, overdecompose 2, float32); every
     loss is finite and each kernel's launch count is the expected count
     per microbatch times the microbatches run; a profile of one step;
  9. fixed-batch serving of Jamba's hybrid decoder
     (``jamba-v0.1-52b-dense-ffn``, full width and depth, float32, random
     weights from a seed; the qwen3 models are freed first): one prefill
     of 4 x 512 and 4 decode steps through the kernels and through the
     plain versions (logits agree, greedy ids equal); then ``serve.py
     --mode fixed`` (batch 4, prompt 512, 32 new tokens), each kernel's
     launch count the expected count per prefill and per decode step
     times those run, and a profile of a prefill and 8 decode steps;
 10. context-parallel training (Jamba freed first): K4, partial flash
     attention, forward and backward against its plain version and the
     plain chain's autograd at the seq path's shape (a chain over 2
     striped blocks, causal and windowed, f32 and bf16; a row the second
     block fully masks keeps its carry bit for bit; two runs give the same
     bits), K4's times (the backward chain also replayed from a CUDA
     graph); then ``launch/train.py --mesh 1,1,1,1,2`` as two
     gloo ranks sharing the card (``launch_ranks``)
     (qwen3-1.7b at full width and MESH_LAYERS layers, full depth until
     phase 16 took its place in the script's time; the flags, seed and
     data of phase 8), in one launch with 13b's run: losses within 1e-3 of
     one card's run of the same model (run first), both ranks' parameters
     bitwise equal, each kernel's launches per rank exactly the code's per
     microbatch;
 11. serving on the 4D mesh (1,2,2,1): qwen3-1.7b at full width and
     MESH_SERVE_LAYERS layers, four gloo ranks sharing the card
     (``launch_ranks``), each holding its shard of every weight, each rank ``serve.main`` with the cut model's config (``chip_smoke.py
     --serve-worker LAYERS FLAGS``). One card's runs of the same cut model
     come first, in this process: phase 5's flags served, and the fixed
     run below. Then the one-card run's sequences fed whole
     (teacher-forced) through the mesh: logits within MESH_TF_TOL of one
     card's; then ``serve.py --mesh 1,2,2,1`` with phase 5's flags: every
     rank's parameter shards hash to the one-card model's blocks, every
     rank ran the same plans, each kernel's launches (K3's stats and apply
     passes among them) and the collective calls per step are the code's,
     and the greedy ids equal one card's wherever its top-2 margin exceeds
     MESH_MARGIN times the teacher-forced error; then ``--mode fixed``
     (batch 4, prompt 128, 8 new tokens) with the same checks, its greedy
     ids held the same way to the fixed run of the same flags on one card
     (with the margins of its positions);
 12. training on the 4D mesh, gloo ranks sharing the card
     (``launch_ranks``), each holding its block of every weight, at full
     width and MESH_LAYERS layers (one card's run of the same cut
     model, in this process, is what they are held to); each runs
     ``train.train_on`` in ``chip_smoke.py --mesh-train-worker DIR WHICH``
     (13a's run follows 12a's in its launch):
     (a) on (1,2,2,2) (x, y and z of 2, eight ranks) with phase 8's
     flags: step 1's loss and grad norm within MESH_TRAIN_TOL of one
     card's, the later losses within 1e-3, each kernel's launches per rank
     and microbatch and the collective calls per step and axis exactly the
     code's, each rank's peak memory within its eighth of the card; (b) on
     (2,2,2,1), the data axis beside x and y: the two data replicas of
     every block end bitwise equal, and the losses and grad norms match
     one card's;
 13. the overlapped schedule (``core/overlap.py``): (a) 12a's run with
     ``OverlapConfig.all_on()`` (every z collective and x/y all-reduce a
     ring of hops whose K1 GEMMs run as the blocks arrive): step 1 within
     OVERLAP_TRAIN_TOL of one card's, launches, ring hops and blocking
     calls per step and axis the code's (``mesh_train_hops``), its step
     time, exposed comm seconds and bytes by axis beside 12a's; (b) phase
     10's run with the seq ring (``OverlapConfig(ring_attention=True)``):
     losses held to one card's and phase 10's, both ranks bitwise equal,
     K4's launches and the seq hops the code's, beside phase 10's; (c)
     ``serve.py --mesh 1,2,2,1 --mode fixed --overlap`` with phase 11's
     flags: the teacher-forced logits under the schedule within
     OVERLAP_TF_TOL of max|logit| of one card's, the greedy ids equal to
     phase 11's fixed run's, launches, calls and ring hops the code's;
 14. Jamba on the 4D mesh and long-context decode: (a) ``serve.py --mode
     fixed`` of ``jamba-v0.1-52b-dense-ffn`` at full width and
     HYBRID_MESH_LAYERS layers (one period of its pattern) on (1,2,2,1)
     (the Mamba layers' inner channels over y), four gloo ranks on the
     card, phase 9's batch and prompt and 8 new tokens: the one-card run
     of the same cut model fed through the mesh (teacher-forced logits
     within MESH_TF_TOL of max|logit| of one card's), then the served run,
     its greedy ids held to one card's above the margin, launches (K6 7 a
     forward) and collective calls the code's; (b)
     ``make_decode_step(seqshard=True)`` of one sequence at the reference's
     long_500k context (524,288 positions, the KV cache's sequence dim
     over data) on (2,1,2,1), Jamba at full width cut to one period (8
     layers): 8 steps against one card's mode "decode" over the whole
     cache on the same weights and seeded caches, logits within
     LOGIT_TOL and ids equal, launches (K5 with its lse) and collectives
     by axis the code's;
 15. the rest of the training stack: (a) ``train.py --zero`` (bucketed
     data-parallel sync, ZeRO-1 AdamW state) of qwen3-1.7b at full width
     and MESH_LAYERS layers on (2,2,2,1), after 12b in its launch, phase
     8's flags for 2 steps: held to one card's run of the same model by
     MESH_TRAIN_TOL, the data replicas of every block bitwise equal, each
     rank's peak memory, data-axis reduce-scatter/all-gather calls and
     bytes, optimizer-state bytes and step time logged; (b) checkpoints at
     ``--preset 100m``: run A 3 of 4 steps on (2,1,2,1) with ``--zero
     --ckpt`` (``train.main(stop_after=3)``), run C the 4 steps on one
     card; A's losses within MESH_TRAIN_TOL's later-step bound of C's, the
     file verified, its bytes and save seconds logged (files live in a
     temporary directory, removed after); (c) remat policy "dots" through
     ``make_train_step`` at phase 8's shape: losses bitwise phase 8's
     ("full"), K1 21L + 3 a microbatch (28L + 3 under "full"), step time
     and peak memory beside phase 8's;
 16. ZeRO-3: (a) ``train.py --zero3`` of qwen3-1.7b at full width and
     depth on (8,1,1,1), where ZeRO-1 cannot fit, batch 8 x 512 in one
     microbatch a rank, 2 steps, eight gloo ranks, then (b) ``--zero3
     --zero3-prefetch`` for one step in the same launch: both held to one
     card's run of the same batch (four microbatches, run first) by
     MESH_TRAIN_TOL, (b)'s step bitwise (a)'s first, each run's gathered
     parameters hashing alike on every rank, K1 28L + 3 a microbatch, the
     data axis's bytes a step exactly the leaf plan's count by the copied
     ``comm_model.dp_sync_volume`` (streamed layers 3 passes, 2 with
     prefetch: (b)'s 2/3 of (a)'s), each rank's peak device and host
     memory, shard and state bytes, calls, bytes and exposed seconds by
     kind logged; (c) in 15b's launches, run A 3 of 4 steps with
     ``--zero3 --ckpt`` on (4,1,1,1), run B ``--resume`` with ``--zero``
     on (2,1,2,1) for the 4th (in 15b's A's launch): A's and B's losses
     within MESH_TRAIN_TOL's later-step bound of 15b's C, the file
     verified, restore seconds logged;
 17. the paper's analytical model calibrated on the card: (a)
     ``launch/calibrate.py --quick`` on (1,2,2,2), eight gloo ranks sharing
     the card (run before phase 10): γ, α, ``link_bw``, K1's ``flops`` (a
     rank's share of the card) and r², overall and per axis, finite and
     non-negative (``link_bw`` positive); the overlap and cross-step
     efficiencies; each collective kind's ring hops counted in
     ``mesh.HOPS`` equal to the code's count (``calibrate.ring_hops``);
     the card's name, power limit and ranks per card; (b) 12a's and 16a's
     runs take ``--calib`` with (a)'s profile, ``--telemetry`` and
     ``--log-file`` (in their launches), whose JSONL passes
     ``telemetry.validate_file``; then, for phases 10, 12a, 13a (with its
     ``OverlapConfig``), 15a and 16a, the model's step time priced with
     each run's own flags (``train.predict_step``; 12a's and 16a's equal
     to their runs' own predictions) against the measured steady step,
     their ratio, and the Spearman correlation over the five; (c) in
     (a)'s launch, ``--validate --steps 2``: the reference's fig5 grid of
     7 decompositions of 8 ranks x S in {64, 128, 256} of the reduced
     qwen3-1.7b, its ``rank_correlation`` and ``predicted_best`` against
     the measured ``best``;
 18. the tracing half (``core/trace.py``'s scopes, ``launch/roofline``'s
     dispatch hook, ``train.py --profile-steps``): 13a's run once more in
     12a's launch, with ``--profile-steps 2:2`` (3 steps, eight ranks):
     every rank's chrome trace written, rank 0's holding the ring hops',
     the GEMM chunks' and the embedding gather's ranges; each rank's
     recorded calls by scope summing to the hook's totals, which equal
     ``mesh.COMM``'s for the window in calls and bytes; the losses and
     grad norms bitwise 13a's; printed: rank 0's tally by scope class,
     kind and axis (calls, raw and wire bytes, host seconds in the scope's
     ranges, K1's device time inside ``gemm/chunk`` ranges), the unscoped
     remainder beside the calls and bytes the analytical model charges the
     step, the hook's totals against 13a's calls a step, and the profiled
     step's wall time against step 1's;
 19. a summary: one ``{"kernels": [...]}`` line, the card's name and power
     limit, and as the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PYCACHE = ROOT / "build" / "pycache"


def keep_bytecode() -> None:
    """Cache compiled bytecode under PYCACHE, for this process and every
    process it starts. Each rank of a launch (and the launcher) imports
    torch anew, and where the environment forbids writing bytecode
    (PYTHONDONTWRITEBYTECODE) every such import compiles torch's sources
    again: ~9 s a process on the H100 machine, twice a launch. Here this
    process's import writes the cache and later processes read it."""
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


if __name__ == "__main__":
    keep_bytecode()

import torch  # noqa: E402

sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen3-1.7b"
HYBRID = "jamba-v0.1-52b-dense-ffn"
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet, dense): memory and the
# non-tensor-core float32 rate the kernels' fp32 arithmetic runs at
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# K3: the tolerances of tests/test_kernels.py. K5: the kernel's online
# softmax sums in another order than the plain version's single softmax;
# bf16 inputs round once more on the way in
RMS_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K1 against torch.matmul, K2 against the plain attention and its
# autograd, each as max|kernel - plain| <= tol * max|plain|: K1 sums K in
# another order than cuBLAS, K2 sums keys (and, backward, queries) in
# another order than the plain version; bf16 outputs round once more
MATMUL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# full-width training parity (float32), relative: the loss, the global
# gradient norm, and each leaf's max|dg| against its max|g|; K1's K order
# differs from cuBLAS's in every product of the 28 layers
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "leaf": 1e-3}
SERVE_FLAGS = ["--arch", ARCH, "--preset", "full", "--slots", "8",
               "--page-size", "16", "--pages", "128", "--chunk", "32",
               "--requests", "16", "--prompt-len", "128", "--gen", "32",
               "--rate", "0", "--seed", str(SEED)]
# phase 5's pool times 64: 30 GB of K/V pages at full width
POOL_PAGES = 8192
TRAIN_FLAGS = ["--arch", ARCH, "--preset", "full", "--steps", "3",
               "--batch", "4", "--seq", "512", "--overdecompose", "2",
               "--dtype", "float32", "--log-every", "1"]
FIXED_FLAGS = ["--arch", HYBRID, "--mode", "fixed", "--preset", "full",
               "--batch", "4", "--prompt-len", "512", "--gen", "32",
               "--seed", str(SEED)]
# phase 15: 15a trains with --zero on (2,2,2,1) at full width and
# MESH_LAYERS layers (full depth until phase 16's ZeRO-3 took its place in
# the script's time), phase 8's flags for 2 steps, in 12b's launch; 15b
# checkpoints at --preset 100m; 15c trains phase 8's run under remat
# "dots"
ZERO_MESH = "2,2,2,1"
ZERO_STEPS = 2


def with_flag(flags, flag, value):
    """``flags`` with ``flag`` set to ``value``."""
    i = flags.index(flag)
    return [*flags[:i], flag, str(value), *flags[i + 2:]]


def with_steps(flags, steps):
    """``flags`` with ``--steps`` set to ``steps``."""
    return with_flag(flags, "--steps", steps)


ZERO_FLAGS = with_steps(TRAIN_FLAGS, ZERO_STEPS) + [
    "--mesh", ZERO_MESH, "--backend", "gloo", "--zero"]
CKPT_FLAGS = ["--arch", ARCH, "--preset", "100m", "--steps", "4",
              "--batch", "4", "--seq", "512", "--overdecompose", "2",
              "--dtype", "float32", "--log-every", "1"]
CKPT_A_MESH = "2,1,2,1"
CKPT_A_STEPS = 3
# phase 16: ZeRO-3 on (8,1,1,1) at full width and depth, where ZeRO-1
# cannot fit (16.0 GiB a rank); 16a without prefetch for ZERO3_STEPS
# steps, then 16b with it for one, in one launch of eight ranks, held to
# one card's run of the same batch (ZERO3_ONE_FLAGS: four microbatches of
# phase 8's size, so it fits); 16c a ZeRO-3 checkpoint at --preset 100m
# on (4,1,1,1) (run A, 3 of 4 steps; one microbatch, as one row a rank
# does not split) resumed with --zero on (2,1,2,1)
ZERO3_MESH = "8,1,1,1"
ZERO3_RANKS = 8
ZERO3_STEPS = 2
ZERO3_ONE_FLAGS = with_flag(with_flag(with_steps(
    TRAIN_FLAGS, ZERO3_STEPS), "--batch", 8), "--overdecompose", 4)
ZERO3_FLAGS = with_flag(ZERO3_ONE_FLAGS, "--overdecompose", 1) + [
    "--mesh", ZERO3_MESH, "--backend", "gloo", "--zero3"]
ZERO3_PREFETCH_FLAGS = with_steps(ZERO3_FLAGS, 1) + ["--zero3-prefetch"]
ZERO3_CKPT_A_MESH = "4,1,1,1"
ZERO3_CKPT_B_MESH = CKPT_A_MESH
# phase 17: the calibration's launch (17a, then 17c's fig5 grid) and its
# profile, which 12a's and 16a's runs read (--calib) and merge their drift
# into
CALIB_MESH = "1,2,2,2"
CALIB_RANKS = 8
CALIB_VALIDATE_STEPS = 2
CALIB_TIMEOUT_S = 300
CALIB_PROFILE = ROOT / "build" / "chip_smoke_calib" / "cuda.json"


def calib_flags(outdir, name):
    """17b's flags on a run of the mesh-train worker: 17a's profile,
    telemetry into ``outdir``'s ``<name>.jsonl``."""
    return ["--calib", str(CALIB_PROFILE), "--telemetry", "--log-file",
            str(Path(outdir) / f"{name}.jsonl")]
# K3's timed shapes (rows, d): the serving step's norm1/norm2 (8 slots) and
# qk-norm rows (8 x 16 heads); training's norm1/norm2 per microbatch (2 x
# 512 tokens) and its q-norm rows (x 16 heads); Jamba's prefill (4 x 512)
# and decode (4) norms
RMS_SHAPES = [(8, 2048), (128, 128), (1024, 2048), (16384, 128),
              (2048, 4096), (4, 4096), (1, 4096)]
# K3's stats and apply passes at the mesh path's local width d / g_x =
# 1024 (qwen3-1.7b on (1,2,2,1)): the decode step's norms (8 slots) and a
# prefill chunk's (8 x 32 rows)
RMS_SPLIT_SHAPES = [(8, 1024), (256, 1024), (512, 1024), (4, 2048),
                    (2048, 2048)]
# K6 against its sequential plain version: y and the state of f32 within
# the 2e-4 of tests/test_kernels.py (exp and the FMA contractions round
# otherwise than PyTorch's kernels); bf16 y rounds once more on the way out
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# K6 at the fixed-serving path's shapes: (name, Bt, T, d, N, with s0)
SCAN_SHAPES = [("prefill", 4, 512, 8192, 16, False),
               ("decode", 4, 1, 8192, 16, True),
               # Jamba on g_y = 2 (phase 14): the rank's 4096 channels
               ("prefill, y-sharded", 4, 512, 4096, 16, False),
               ("decode, y-sharded", 4, 1, 4096, 16, True),
               ("long-context decode, y-sharded", 1, 1, 4096, 16, True)]
# K6 timed at both shapes in float32 and at the prefill in bfloat16
SCAN_TIMED = ([(torch.float32, s) for s in SCAN_SHAPES]
              + [(torch.bfloat16, SCAN_SHAPES[0])])
# exp2 results a clock across the H100's 132 SMs (16 an SM)
SFU_PER_CLOCK = 132 * 16
# the training shapes of K1: (name, M, K, N, layout); NT reads b and TN
# reads a through a transposed view, as the backward does
MATMUL_SHAPES = [("fwd X.W", 1024, 2048, 6144, "NN"),
                 ("dX dY.W^T", 1024, 6144, 2048, "NT"),
                 ("dW X^T.dY", 2048, 1024, 6144, "TN"),
                 ("tied head h.E^T", 1024, 2048, 152064, "NT"),
                 ("decode x.W", 8, 2048, 6144, "NN"),
                 ("decode tied head", 8, 2048, 152064, "NT"),
                 # the middle band of M (17 to 64 rows: the 64-row tile)
                 ("middle band x.W", 64, 2048, 6144, "NN"),
                 # Jamba's Mamba layer (prefill 4 x 512 rows, decode 4):
                 # w_x's N of 288 (dt_rank + 2N) and w_dt's K of 256, whose
                 # input is a column slice of w_x's output ("SN": a read
                 # through a row stride of K + 32)
                 ("mamba w_x", 2048, 8192, 288, "NN"),
                 ("mamba w_dt", 2048, 256, 8192, "SN"),
                 ("decode mamba w_x", 4, 8192, 288, "NN"),
                 ("decode mamba w_dt", 4, 256, 8192, "SN")]
# K1 at the local shapes of qwen3-1.7b on the (1,2,2,1) mesh, float32
# (d / g_x = 1024 in, per-rank widths out): the decode step (8 slots), a
# prefill chunk (8 x 32 rows) and the fixed-batch prefill (4 x 128)
MESH_MATMUL_SHAPES = [
    (f"mesh {tag} {w}", M, K, N, "NN")
    for tag, M in (("decode", 8), ("chunk", 256), ("fixed prefill", 512))
    for w, K, N in (("x.Wq|Wo", 1024, 1024), ("x.Wk|Wv", 1024, 512),
                    ("x.Wi|Wg", 1024, 3072), ("h.Wdown", 3072, 1024))] + [
    ("mesh decode tied head h.E^T", 8, 1024, 76032, "NT")]
# K1 at the local shapes of training qwen3-1.7b on (1,2,2,2) (phase 12),
# after the z all-gather: a microbatch of 512 rows, d / g_x = 1024 in and
# per-rank widths out, each product with its dX (NT) and dW (TN); the tied
# head h.E^T over the 152064 / g_y = 76032 local rows, its dh and dtable
MESH_TRAIN_MATMUL_SHAPES = [
    (f"mesh train {w} {kind}", *shape)
    for w, K, N in (("x.Wq|Wo", 1024, 1024), ("x.Wk|Wv", 1024, 512),
                    ("x.Wi|Wg", 1024, 3072), ("h.Wdown", 3072, 1024))
    for kind, shape in (("fwd", (512, K, N, "NN")),
                        ("dX", (512, N, K, "NT")),
                        ("dW", (K, 512, N, "TN")))] + [
    ("mesh train tied head h.E^T", 512, 1024, 76032, "NT"),
    ("mesh train tied head dh", 512, 76032, 1024, "NN"),
    ("mesh train tied head dtable", 76032, 512, 1024, "TN")]
# K1 at the ring-hop shapes of the overlapped schedule on (1,2,2,2) (phase
# 13a): one z block of x.Wi|Wg (1024 x 1536) a hop, forward on the block;
# dX on a column slice of dY (row stride 3072) against the block
# transposed; dW of x^T against a column slice of dY; the tied head's
# accumulate hop, a column slice of h (row stride 1024) against the
# table's z block (76032 x 512) transposed
RING_MATMUL_SHAPES = [("ring hop x.Wi|Wg fwd", 512, 1024, 1536, "NN"),
                      ("ring hop x.Wi|Wg dX", 512, 1536, 1024, "ST"),
                      ("ring hop x.Wi|Wg dW", 1024, 512, 1536, "TS"),
                      ("ring hop tied head h.E^T", 512, 512, 76032, "ST")]
# of those, timed in float32, and the dW also with bf16 operands, its
# output in bf16 and in float32 (beside bfloat16 torch.matmul)
MESH_TRAIN_TIMED = ("mesh train x.Wi|Wg fwd", "mesh train x.Wi|Wg dW")
# K1 shapes also timed in bfloat16, beside bfloat16 torch.matmul (which
# runs on the tensor cores; K1's bf16 path widens to fp32 on the CUDA
# cores)
MATMUL_BF16_TIMED = ("fwd X.W", "decode x.W")
# K2 at the training shape: (B, T, S, nq, nkv, hd, causal, window, kv_len)
ATTN_MAIN = (2, 512, 512, 16, 8, 128, True, 0, 0)
ATTN_JAMBA = (4, 512, 512, 32, 8, 128, True, 0, 0)
ATTN_CASES = {"train (B 2, T 512, 16/8 heads, hd 128, causal)": ATTN_MAIN,
              "window 128": (2, 512, 512, 16, 8, 128, True, 128, 0),
              "ragged kv_len 300 of 320, non-causal, T 200":
                  (2, 200, 320, 16, 8, 128, False, 0, 300),
              "Jamba prefill (B 4, T 512, 32/8 heads, hd 128, causal)":
                  ATTN_JAMBA,
              # the local heads of qwen3-1.7b on (1,2,2,1), fixed-batch
              "mesh fixed prefill (B 4, T 128, 8/4 heads, hd 128, causal)":
                  (4, 128, 128, 8, 4, 128, True, 0, 0),
              # a microbatch of training on (1,2,2,2): one sequence, the
              # local heads
              "mesh train (B 1, T 512, 8/4 heads, hd 128, causal)":
                  (1, 512, 512, 8, 4, 128, True, 0, 0),
              # Jamba's local heads on (1,2,2,1), its prefill (phase 14a)
              "Jamba mesh prefill (B 4, T 512, 16/4 heads, hd 128, "
              "causal)": (4, 512, 512, 16, 4, 128, True, 0, 0)}
# context parallelism: the seq axis, and K4 at its path's shape, per rank
# and microbatch (B 2, C = 512 / p queries, p gathered blocks of C keys,
# 16/8 heads, hd 128), causal and with a window
SEQ_P = 2
PARTIAL_MAIN = (2, 512 // SEQ_P, 16, 8, 128, SEQ_P)
PARTIAL_WINDOWS = (0, 128)
SEQ_FLAGS = TRAIN_FLAGS + ["--mesh", f"1,1,1,1,{SEQ_P}", "--backend", "gloo"]
# the seq run's losses against one card's, absolute: the reference holds
# seq-parallel against unsharded training to the same 1e-3
# (tests/test_ring_attention.py::test_train_loss_parity_seq_vs_unsharded)
SEQ_LOSS_TOL = 1e-3
# serving on the 4D mesh: four gloo ranks share the card, x and y of 2
MESH = "1,2,2,1"
MESH_RANKS = 4
MESH_SERVE_FLAGS = SERVE_FLAGS + ["--mesh", MESH, "--backend", "gloo"]
MESH_FIXED_FLAGS = ["--arch", ARCH, "--mode", "fixed", "--preset", "full",
                    "--batch", "4", "--prompt-len", "128", "--gen", "8",
                    "--seed", str(SEED), "--mesh", MESH, "--backend", "gloo"]
MESH_TIMEOUT_S = 400
# phases 11 and 13c serve qwen3-1.7b at full width and MESH_SERVE_LAYERS
# layers, held to one card's runs of the same cut model: at full depth
# they took 161 s of the script's time with start-up (on an H100 80GB
# HBM3 at 700 W)
MESH_SERVE_LAYERS = 4
# teacher-forced logits of the mesh against one card's, max|dlogit| over
# max|logit|, float32 with TF32 off: phase 4's bound, for the same cause
# (each product and each norm's sum of squares is summed in another order:
# two x ranks' halves added through gloo)
MESH_TF_TOL = 1e-3
# the mesh's greedy ids must equal one card's wherever one card's top-2
# margin exceeds this many times the teacher-forced max|dlogit|
MESH_MARGIN = 10
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
# K5 over the dense decode cache: (batch, nq, nkv, hd) and each row's keys
# after the step; Jamba's attention layers (prompt 512 + up to 32 new) and
# qwen3-1.7b's local heads on (1,2,2,1) in the fixed mesh run (prompt 128
# + up to 8 new)
# training on the 4D mesh, phase 8's flags at full width and MESH_LAYERS
# layers: 12a at (1,2,2,2), 12b at (2,2,2,1), 13a as 12a with the
# overlapped schedule, each held to one card's run of the same cut model.
# The cut keeps the whole script within its time (at full depth 12a and
# 13a took 166 and 145 s with start-up on an H100 80GB HBM3 at 700 W), and
# 12b's full depth does not fit eight ranks on the card without ZeRO
MESH_TRAIN = "1,2,2,2"
MESH_TRAIN_FLAGS = TRAIN_FLAGS + ["--mesh", MESH_TRAIN, "--backend", "gloo"]
MESH_DATA = "2,2,2,1"
MESH_LAYERS = 4
MESH_DATA_FLAGS = TRAIN_FLAGS + ["--mesh", MESH_DATA, "--backend", "gloo"]
MESH_TRAIN_RANKS = 8
MESH_TRAIN_TIMEOUT_S = 700
# step 1's loss and grad norm against one card's, relative (the mesh sums
# every product over x and y, and the norms' squares, in another order),
# and the later steps' losses, absolute, as phase 10 holds them
MESH_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "later_loss": 1e-3}
MESH_TRAIN_DIR = ROOT / "build" / "chip_smoke_mesh_train"
# the overlapped schedule (phase 13): 13a trains with
# OverlapConfig.all_on() on MESH_TRAIN, 13b with the seq ring alone on
# phase 10's mesh at MESH_LAYERS (train.py has no flag for the schedule:
# both run ``train.main`` in ``chip_smoke.py --mesh-train-worker DIR
# WHICH``), 13c serves MESH_FIXED_FLAGS with --overlap; step 1 against one
# card's (relative), later losses absolute; the overlapped serving's
# teacher-forced logits against one card's, relative to max|logit|
OVERLAP_TRAIN_TOL = {"loss": 1e-6, "grad_norm": 1e-5, "later_loss": 1e-4}
OVERLAP_TF_TOL = 3e-6
DENSE_DECODE = {"Jamba": ((4, 32, 8, 128), [513, 527, 538, 544]),
                "mesh fixed": ((4, 8, 4, 128), [129, 131, 134, 136]),
                "Jamba mesh": ((4, 16, 4, 128), [513, 515, 517, 520])}
# 14a: Jamba's fixed serving on the (1,2,2,1) mesh at full width, phase
# 9's batch and prompt; for the script's time --gen is cut from phase 9's
# 32 to phase 11's 8, and the depth to one period of the layer pattern
# (7 Mamba layers, 1 attention layer; at full depth 14a took 90 s with
# start-up on an H100 80GB HBM3 at 700 W)
HYBRID_MESH_LAYERS = 8
HYBRID_MESH_FLAGS = ["--arch", HYBRID, "--mode", "fixed", "--preset",
                     "full", "--batch", "4", "--prompt-len", "512", "--gen",
                     "8", "--seed", str(SEED), "--mesh", MESH, "--backend",
                     "gloo"]
HYBRID_MESH_DIR = ROOT / "build" / "chip_smoke_hybrid_mesh"
# 14b: decode of one sequence at the reference's long_500k context, its KV
# cache's sequence dim sharded over data (make_decode_step(seqshard=True)),
# Jamba at full width cut to one period of its layer pattern (7 Mamba
# layers and 1 attention layer): two data replicas of the full depth and
# the cache do not fit the card. The attention layer's K/V holds seeded
# keys at positions below LONG_P0; LONG_STEPS steps decode from there
LONG_MESH = "2,1,2,1"
LONG_CONTEXT = 524288
LONG_LAYERS = 8
LONG_STEPS = 8
LONG_P0 = LONG_CONTEXT - LONG_STEPS
LONG_DIR = ROOT / "build" / "chip_smoke_long"
LONG_TIMEOUT_S = 400
# 14b's logits against one card's, as tests/test_torch_serving.py holds
# logits (float32: the shards' softmaxes merge in another order)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# K1 at the local shapes of Jamba's mesh paths, float32: 14a on (1,2,2,1)
# (prefill 4 x 512 rows and decode 4 rows, d / g_x = 2048 in, d_inner /
# g_y = 4096), 14b on (2,1,2,1) (one row, d 4096 in); the untied head's
# V / g_y = 32768 columns
HYBRID_MESH_MATMUL_SHAPES = [
    (f"{tag} {w}", M, K, N, layout)
    for tag, M, d in (("jamba mesh prefill", 2048, 2048),
                      ("jamba mesh decode", 4, 2048),
                      ("jamba long decode", 1, 4096))
    for w, K, N, layout in (
        ("x.W_in|W_gate", d, 4096, "NN"), ("x.W_x", 4096, 288, "NN"),
        ("dt.W_dt", 256, 4096, "SN"), ("y.W_out", 4096, d, "NN"),
        ("x.Wq|Wo", d, 2048, "NN"), ("x.Wk|Wv", d, 512, "NN"),
        ("x.Wi|Wg", d, 7168, "NN"), ("h.Wdown", 7168, d, "NN"),
        ("head h.W", d, 32768, "NN"))]
# K5 at 14b's shape: one row against a shard of 262,144 keys (524,288
# over g_data 2), the local 16/4 heads, hd 128
SEQ_K5 = dict(nq=16, nkv=4, hd=128, keys=LONG_CONTEXT // 2)


_T0 = time.time()


def log(msg: str) -> None:
    """Print ``msg``; a phase's header ("[...] ...") gets the script's
    elapsed seconds, so the log shows where the time limit goes."""
    if msg.startswith("["):
        msg = f"{msg}  (t={time.time() - _T0:.1f} s)"
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call of ``fn`` issued back to back from Python,
    between two CUDA events. Where the host issues slower than the card
    runs, this reads the host's issue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def eager_rounds(fn, rounds: int = 7, iters: int = 20) -> dict:
    """``rounds`` runs of :func:`cuda_ms` (``iters`` calls each): their
    median, min and max (ms). Eager times of one call vary from run to run
    (autograd's backwards above all), so a single run cannot tell 1.5x
    from 2x."""
    t = sorted(cuda_ms(fn, iters, 3) for _ in range(rounds))
    return dict(median=t[len(t) // 2], lo=t[0], hi=t[-1])


def spread(r) -> str:
    return (f"{r['median'] * 1e3:.2f} us (median of rounds, "
            f"{r['lo'] * 1e3:.2f}-{r['hi'] * 1e3:.2f})")


def sdpa_backend():
    """SDPA pinned to one backend for the library column, so that calls
    compare like with like: PyTorch's memory-efficient attention, the one
    backend that takes float32 on the card."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)


SDPA_NAME = "SDPA (EFFICIENT_ATTENTION)"


def graph_ms(fn, iters: int = 100) -> float:
    """Mean device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, between two CUDA events, so that the host's
    launch cost does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timings(kernel, plain, library, nbytes, n_ops, dtype, iters=100,
            eager_iters=200):
    """The JSON line's times (device time, from graph replay) and, for the
    log, the same calls issued eagerly."""
    t = dict(ms=graph_ms(kernel, iters), plain_ms=graph_ms(plain, iters),
             library_ms=library and graph_ms(library, iters),
             **bound(nbytes, n_ops, dtype))
    warm = min(20, eager_iters)
    eager = dict(ms=cuda_ms(kernel, eager_iters, warm),
                 plain_ms=cuda_ms(plain, eager_iters, warm),
                 library_ms=library and cuda_ms(library, eager_iters, warm))
    return t, eager


def max_err(a, b, mask=None) -> float:
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def check_close(name, got, want, tol, mask=None) -> float:
    if mask is not None:
        got, want = got[mask], want[mask]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    err = max_err(got, want)
    log(f"  {name}: max|kernel - plain| = {err:.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def check_rel(name, got, want, tol) -> float:
    """max|got - want| <= tol * max|want|; returns the max abs error."""
    err, scale = max_err(got, want), float(want.float().abs().max())
    ok = err <= tol * scale and math.isfinite(err)
    log(f"  {name}: max|kernel - plain| = {err:.3e}, max|plain| = "
        f"{scale:.3e} (tol {tol:g} of it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------- #
# inputs
# ---------------------------------------------------------------------- #

def matmul_inputs(gen, M, K, N, layout, dtype):
    """a (M, K) and b (K, N): "T" reads an operand through a transposed
    view; "SN" reads a as a column slice (row stride K + 32); "ST" reads a
    as the second half of rows of 2 K and b transposed, "TS" a transposed
    and b as the second half of rows of 2 N (a ring hop's slices)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    a = (rand(K, M).t() if layout in ("TN", "TS") else
         rand(M, K + 32)[:, :K] if layout == "SN" else
         rand(M, 2 * K)[:, K:] if layout == "ST" else rand(M, K))
    b = (rand(N, K).t() if layout in ("NT", "ST") else
         rand(K, 2 * N)[:, N:] if layout == "TS" else rand(K, N))
    return a, b


def scan_inputs(gen, Bt, T, d, N, dtype, with_s0):
    """K6 inputs as the Mamba layer makes them: B and C column views of
    one (Bt, T, 256 + 2N) projection output, dt = softplus(...) in fp32,
    A = -exp(A_log) with A_log = log(1..N)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = rand(Bt, T, d).to(dtype)
    dt = torch.nn.functional.softplus(rand(Bt, T, d) - 4.6)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda"
                      ).expand(d, N).contiguous()
    xdbc = rand(Bt, T, 256 + 2 * N).to(dtype)
    s0 = rand(Bt, d, N) if with_s0 else None
    return x, dt, A, xdbc[..., 256:256 + N], xdbc[..., 256 + N:], s0


def scan_work(Bt, T, d, N, dtype, with_s0):
    """(bytes, operations) of one K6 call for its bound: x, dt, y, B, C,
    A, s0 and the final state each moved once; per (b, t, c) dt * x, per
    (b, t, c, n) dt * A, exp, two products, a sum and the dot with C."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = (Bt * T * d * (2 * elt + 4) + 2 * Bt * T * N * elt + d * N * 4
              + Bt * d * N * 4 * (2 if with_s0 else 1))
    return nbytes, Bt * T * d * (7 * N + 1)


def attn_inputs(gen, B, T, S, nq, nkv, hd, dtype):
    """q, k, v in the model's (B, T, H, hd) layout and an output
    gradient."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (rand(B, T, nq, hd), rand(B, S, nkv, hd), rand(B, S, nkv, hd),
            rand(B, T, nq, hd))


def attn_work(B, T, S, nq, nkv, hd, causal, window, kv_len, elt):
    """(visible (query, key) pairs, bytes of q, k, v and out) for the
    bounds; the backward moves as many again (dout, dq, dk, dv)."""
    i = torch.arange(T)[:, None]
    j = torch.arange(S)[None, :]
    vis = (j < (kv_len or S)).expand(T, S).clone()
    if causal:
        vis &= i >= j
    if window:
        vis &= (i - j) < window
    pairs = int(vis.sum()) * B * nq
    return pairs, 2 * (B * T * nq + B * S * nkv) * hd * elt



def paged_inputs(gen, *, ctx, q_len, T, dtype, n_layers=1, P=128, page=16,
                 n_tab=127, nq=16, nkv=8, hd=128):
    """K5 inputs as the serving path makes them: slot r holds ctx[r]
    tokens after this step, its q_len[r] valid rows are the last of them
    (positions beyond the row count continue, clipped, as the scheduler
    writes them). Pools are random everywhere, so unreferenced pages and
    the null page 0 hold stale data; unallocated table entries are 0."""
    dev = gen.device
    R = len(ctx)
    pools = [torch.randn((n_layers, P, page, nkv, hd), generator=gen,
                         device=dev).to(dtype) for _ in range(2)]
    table = torch.zeros((R, n_tab), dtype=torch.int32)
    free = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1).tolist()
    cap = n_tab * page
    q_pos = torch.zeros((R, T), dtype=torch.int32)
    for r, (c, n) in enumerate(zip(ctx, q_len)):
        pages = [free.pop() for _ in range(-(-c // page))]
        table[r, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        if n:
            q_pos[r] = torch.clamp(c - n + torch.arange(T), max=cap - 1)
    q = torch.randn((R, T, nq, hd), generator=gen, device=dev).to(dtype)
    q_len_t = torch.tensor(q_len, dtype=torch.int32)
    return (q, pools[0], pools[1], table.to(dev), q_pos.to(dev),
            q_len_t.to(dev))


def valid_rows(q_len, T):
    return (torch.arange(T, device=q_len.device)[None, :]
            < q_len[:, None].long())


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #

def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    paths = build.build()
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f}s")
    for name, path in paths.items():
        log_file = path.with_suffix(".log")
        text = log_file.read_text() if log_file.is_file() else ""
        info = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}: {path.name}")
        for ln in info:
            log(f"    {ln}")


def phase_kernels(gen):
    """Each kernel against its plain version; returns max f32 errors."""
    from repro_torch.kernels.flash_attention import (
        paged_attention_kernel, paged_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain
    errs = dict.fromkeys(("rmsnorm", "rmsnorm_stats", "rmsnorm_apply",
                          "paged_attention", "block_matmul",
                          "flash_attention", "flash_attention_bwd",
                          "selective_scan", "partial_attention",
                          "partial_attention_bwd"), 0.0)
    log("[kernels] K3 rmsnorm vs plain; a row alone gives its bits among "
        "1,024")
    R, T, nq = 8, 32, 16
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((R * T, 2048), (R * T * nq, 128), (R, 2048),
                        (R * nq, 128), (R * 8, 128), *RMS_SHAPES):
            x = torch.randn((rows, d), generator=gen, device="cuda"
                            ).to(dtype)
            g = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
                 ).to(dtype)
            e = check_close(f"{str(dtype)[6:]} ({rows}, {d})",
                            rmsnorm_kernel(x, g), rmsnorm_plain(x, g),
                            RMS_TOL[dtype])
            if dtype == torch.float32:
                errs["rmsnorm"] = max(errs["rmsnorm"], e)
        for d in sorted({d for _, d in RMS_SHAPES} | {64}):
            x = torch.randn((1024, d), generator=gen, device="cuda"
                            ).to(dtype)
            g = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
                 ).to(dtype)
            full = rmsnorm_kernel(x, g)
            for i in (0, 1, 517, 1023):
                if not (torch.equal(rmsnorm_kernel(x[i:i + 1], g)[0],
                                    full[i])
                        and torch.equal(rmsnorm_kernel(x[i].clone(), g),
                                        full[i])):
                    raise AssertionError(f"K3 row {i} of (1024, {d}) "
                                         f"differs when normed alone")
            log(f"  {str(dtype)[6:]} d {d}: rows 0, 1, 517, 1023 alone == "
                f"among 1,024: bitwise")
    phase_kernels_rms_split(gen, errs)
    log("[kernels] K5 paged attention vs plain (nq 16, nkv 8 on one card "
        "and the local 8/4 of (1,2,2,1); hd 128, page 16, table width 127)")
    cases = {1: dict(ctx=[0, 1, 17, 40, 100, 160, 33, 250],
                     q_len=[0, 1, 1, 1, 1, 1, 1, 1]),
             32: dict(ctx=[0, 32, 45, 160, 200, 17, 300, 64],
                      q_len=[0, 32, 13, 32, 32, 17, 32, 5])}
    for dtype, (nq, nkv), (T, c) in itertools.product(
            (torch.float32, torch.bfloat16), ((16, 8), (8, 4)),
            cases.items()):
        q, kp, vp, table, q_pos, q_len = paged_inputs(
            gen, T=T, dtype=dtype, nq=nq, nkv=nkv, **c)
        kp, vp = kp[0], vp[0]
        got = paged_attention_kernel(q, kp, vp, table, q_pos, q_len)
        want = paged_attention_plain(q, kp, vp, table, q_pos, q_len)
        rows = valid_rows(q_len, T)
        e = check_close(f"{str(dtype)[6:]} {nq}/{nkv} heads T={T}", got,
                        want, PAGED_TOL[dtype], rows)
        if got[~rows].any():
            raise AssertionError("rows past q_len must be exactly 0")
        if dtype == torch.float32:
            errs["paged_attention"] = max(errs["paged_attention"], e)
        if T == 32:
            for c0, c1 in ((0, 5), (5, 17), (17, 32)):
                ql = torch.clamp(q_len - c0, 0, c1 - c0).to(torch.int32)
                part = paged_attention_kernel(
                    q[:, c0:c1], kp, vp, table,
                    q_pos[:, c0:c1].contiguous(), ql)
                m = valid_rows(ql, c1 - c0)
                if not torch.equal(part[m], got[:, c0:c1][m]):
                    raise AssertionError(
                        f"chunk [{c0}, {c1}) differs from one-shot")
            log(f"  {str(dtype)[6:]} {nq}/{nkv} heads chunked (0-5, 5-17, "
                f"17-32) == one-shot: bitwise")
    phase_kernels_dense_decode(gen, errs)
    phase_kernels_seqshard(gen, errs)
    phase_kernels_train(gen, errs)
    phase_kernels_scan(gen, errs)
    return errs


def phase_kernels_rms_split(gen, errs):
    """K3's stats and apply passes (the two halves of an x-sharded row's
    norm, around the psum of its sum of squares) against their plain
    versions; stats then apply on a whole row gives the single pass's
    bits."""
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_apply_kernel, rmsnorm_apply_plain, rmsnorm_kernel,
        rmsnorm_stats_kernel, rmsnorm_stats_plain)
    log("[kernels] K3 stats and apply passes vs plain; stats then apply on "
        "a whole row == the single pass")
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in RMS_SPLIT_SHAPES:
            x = torch.randn((rows, d), generator=gen, device="cuda"
                            ).to(dtype)
            g = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
                 ).to(dtype)
            tag = f"{dtype_name(dtype)} ({rows}, {d})"
            ss = rmsnorm_stats_kernel(x)
            es = check_rel(f"{tag} stats", ss, rmsnorm_stats_plain(x),
                           RMS_TOL[torch.float32])
            # the other x rank's half-row sums, as the psum adds them
            total = ss + torch.rand((rows,), generator=gen,
                                    device="cuda") * d
            ea = check_close(f"{tag} apply", rmsnorm_apply_kernel(
                x, g, total, full_dim=2 * d), rmsnorm_apply_plain(
                x, g, total, full_dim=2 * d), RMS_TOL[dtype])
            if not torch.equal(rmsnorm_apply_kernel(x, g, ss, full_dim=d),
                               rmsnorm_kernel(x, g)):
                raise AssertionError(f"{tag}: stats then apply differs "
                                     f"from the single pass")
            log(f"  {tag}: stats then apply == the single pass: bitwise")
            if dtype == torch.float32:
                errs["rmsnorm_stats"] = max(errs["rmsnorm_stats"], es)
                errs["rmsnorm_apply"] = max(errs["rmsnorm_apply"], ea)


def phase_kernels_dense_decode(gen, errs):
    """K5 as fixed-batch decode runs it: the dense cache seen as pages of
    DENSE_PAGE rows through the table the attention layer builds."""
    from repro_torch.kernels.flash_attention import (
        paged_attention_kernel, paged_attention_plain)
    from repro_torch.layers.attention import DENSE_PAGE, dense_page_view
    for name, ((B, nq, nkv, hd), ctx) in DENSE_DECODE.items():
        S = -(-max(ctx) // DENSE_PAGE) * DENSE_PAGE
        log(f"[kernels] K5 over {name}'s dense decode cache (B {B}, nq {nq},"
            f" nkv {nkv}, hd {hd}, {S} rows as pages of {DENSE_PAGE}, keys "
            f"{ctx}, T 1)")
        q_pos = torch.tensor(ctx, dtype=torch.int32,
                             device="cuda")[:, None] - 1
        q_len = torch.ones((B,), dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            def rand(*shape):
                return torch.randn(shape, generator=gen, device="cuda"
                                   ).to(dtype)
            q, kc, vc = (rand(B, 1, nq, hd), rand(B, S, nkv, hd),
                         rand(B, S, nkv, hd))
            (kp, table), (vp, _) = dense_page_view(kc), dense_page_view(vc)
            e = check_close(
                f"{dtype_name(dtype)} dense decode",
                paged_attention_kernel(q, kp, vp, table, q_pos, q_len),
                paged_attention_plain(q, kp, vp, table, q_pos, q_len),
                PAGED_TOL[dtype])
            if dtype == torch.float32:
                errs["paged_attention"] = max(errs["paged_attention"], e)


def seqshard_inputs(gen, dtype, q_pos):
    """K5's inputs at 14b's shape: one query row against one shard's dense
    cache seen as pages of DENSE_PAGE rows, at the local position
    ``q_pos``."""
    from repro_torch.layers.attention import dense_page_view
    c = SEQ_K5

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rand(1, 1, c["nq"], c["hd"])
    kc, vc = (rand(1, c["keys"], c["nkv"], c["hd"]) for _ in range(2))
    (kp, table), (vp, _) = dense_page_view(kc), dense_page_view(vc)
    return (q, kp, vp, table,
            torch.tensor([[q_pos]], dtype=torch.int32, device="cuda"),
            torch.ones((1,), dtype=torch.int32, device="cuda"))


def phase_kernels_seqshard(gen, errs):
    """K5 as the seq-sharded decode runs it (14b): one row over a shard of
    262,144 keys, with the rows' log-sum-exp, at local positions that see
    every key, a few keys, none (a shard past the query: out 0, lse
    NEG_INF) and a position past the shard's table; the output bitwise the
    call without the lse."""
    from repro_torch.kernels.flash_attention import (
        NEG_INF, paged_attention_kernel, paged_attention_plain)
    c = SEQ_K5
    log(f"[kernels] K5 with its lse at the seq-sharded decode's shape (1 row"
        f", {c['keys']} keys a shard, {c['nq']}/{c['nkv']} heads, hd "
        f"{c['hd']}, pages of 32)")
    for dtype in (torch.float32, torch.bfloat16):
        for q_pos in (c["keys"] - 1, 1000, -5, c["keys"] + 1000):
            args = seqshard_inputs(gen, dtype, q_pos)
            out, lse = paged_attention_kernel(*args, return_lse=True)
            want, wlse = paged_attention_plain(*args, return_lse=True)
            tag = f"{dtype_name(dtype)} q_pos {q_pos}"
            e = check_close(f"{tag} out", out, want, PAGED_TOL[dtype])
            check_close(f"{tag} lse", lse, wlse, PAGED_TOL[torch.float32])
            if not torch.equal(out, paged_attention_kernel(*args)):
                raise AssertionError("K5's out differs with the lse asked")
            if q_pos < 0 and not (bool((lse == NEG_INF).all())
                                  and not out.any()):
                raise AssertionError("a row with no key must give out 0 "
                                     "and lse NEG_INF")
            if dtype == torch.float32:
                errs["paged_attention"] = max(errs["paged_attention"], e)
            del args, out, want
        log(f"  {dtype_name(dtype)}: out bitwise the call without the lse")


def phase_kernels_scan(gen, errs):
    """K6 at the fixed-serving path's prefill and decode shapes."""
    from repro_torch.kernels.selective_scan import (selective_scan_kernel,
                                                    selective_scan_plain)
    log("[kernels] K6 selective_scan vs plain (the sequential oracle), B "
        "and C read as column slices (row stride 288)")
    for dtype in (torch.float32, torch.bfloat16):
        for name, Bt, T, d, N, with_s0 in SCAN_SHAPES:
            args = scan_inputs(gen, Bt, T, d, N, dtype, with_s0)
            y, s = selective_scan_kernel(*args)
            y2, s2 = selective_scan_kernel(*args)
            if not (torch.equal(y, y2) and torch.equal(s, s2)):
                raise AssertionError("K6 is not deterministic")
            wy, ws = selective_scan_plain(*args)
            tag = f"{dtype_name(dtype)} {name} ({Bt}, {T}, {d}, N {N})"
            e = max(check_close(f"{tag} y", y, wy, SCAN_TOL[dtype]),
                    check_close(f"{tag} final state", s, ws,
                                SCAN_TOL[torch.float32]))
            log(f"  {tag}: run twice: bitwise equal")
            if dtype == torch.float32:
                errs["selective_scan"] = max(errs["selective_scan"], e)


def phase_kernels_train(gen, errs):
    """K1 at the training and decode shapes, K2 forward and backward."""
    from repro_torch.kernels.block_matmul import (block_matmul_kernel,
                                                  block_matmul_plain)
    from repro_torch.kernels.flash_attention import (
        attn_core, flash_attention_bwd_kernel, flash_attention_kernel)
    f32 = torch.float32
    log("[kernels] K1 block_matmul vs plain (torch.matmul on fp32 operands); "
        "each run twice")
    for dtype in (f32, torch.bfloat16):
        for name, M, K, N, layout in MATMUL_SHAPES:
            a, b = matmul_inputs(gen, M, K, N, layout, dtype)
            got = block_matmul_kernel(a, b)
            e = check_rel(f"{dtype_name(dtype)} {name} ({M}, {K}) x ({K}, "
                          f"{N}) {layout}", got, block_matmul_plain(a, b),
                          MATMUL_TOL[dtype])
            if not torch.equal(got, block_matmul_kernel(a, b)):
                raise AssertionError(f"K1 {name}: two runs differ")
            del got
            if dtype == f32:
                errs["block_matmul"] = max(errs["block_matmul"], e)
            del a, b
    log("[kernels] K1 at the local shapes of the (1,2,2,1) mesh, float32")
    for name, M, K, N, layout in MESH_MATMUL_SHAPES:
        a, b = matmul_inputs(gen, M, K, N, layout, f32)
        e = check_rel(f"{name} ({M}, {K}) x ({K}, {N}) {layout}",
                      block_matmul_kernel(a, b), block_matmul_plain(a, b),
                      MATMUL_TOL[f32])
        errs["block_matmul"] = max(errs["block_matmul"], e)
        del a, b
    log("[kernels] K1 at the local shapes of training on (1,2,2,2), float32;"
        " the dW products also with bf16 operands and a float32 output (the "
        "weight gradient before its z reduce-scatter), each run twice")
    for name, M, K, N, layout in MESH_TRAIN_MATMUL_SHAPES:
        cases = [(f32, None)] + ([(torch.bfloat16, f32)] if layout == "TN"
                                 else [])
        for dtype, out in cases:
            a, b = matmul_inputs(gen, M, K, N, layout, dtype)
            got = block_matmul_kernel(a, b, out_dtype=out)
            tag = f"{dtype_name(dtype)}{' -> float32' if out else ''}"
            e = check_rel(f"{tag} {name} ({M}, {K}) x ({K}, {N}) {layout}",
                          got, block_matmul_plain(a, b, out_dtype=out),
                          MATMUL_TOL[f32])
            if got.dtype != f32 or not torch.equal(
                    got, block_matmul_kernel(a, b, out_dtype=out)):
                raise AssertionError(f"K1 {tag} {name}: not float32 or two "
                                     f"runs differ")
            if out is not None and not torch.equal(
                    got.to(dtype), block_matmul_kernel(a, b)):
                raise AssertionError(f"K1 {name}: the float32 output rounded "
                                     f"differs from the {dtype} output")
            errs["block_matmul"] = max(errs["block_matmul"], e)
            del a, b, got
    log("[kernels] K1 at the ring-hop shapes of the overlapped schedule on "
        "(1,2,2,2), float32, each run twice")
    for name, M, K, N, layout in RING_MATMUL_SHAPES:
        a, b = matmul_inputs(gen, M, K, N, layout, f32)
        out = f32 if layout == "TS" else None
        got = block_matmul_kernel(a, b, out_dtype=out)
        e = check_rel(f"float32 {name} ({M}, {K}) x ({K}, {N}) {layout}",
                      got, block_matmul_plain(a, b, out_dtype=out),
                      MATMUL_TOL[f32])
        if not torch.equal(got, block_matmul_kernel(a, b, out_dtype=out)):
            raise AssertionError(f"K1 {name}: two runs differ")
        errs["block_matmul"] = max(errs["block_matmul"], e)
        del a, b, got
    log("[kernels] K1 at the local shapes of Jamba on (1,2,2,1) and "
        "(2,1,2,1) (phase 14), float32, each run twice")
    for name, M, K, N, layout in HYBRID_MESH_MATMUL_SHAPES:
        a, b = matmul_inputs(gen, M, K, N, layout, f32)
        got = block_matmul_kernel(a, b)
        e = check_rel(f"float32 {name} ({M}, {K}) x ({K}, {N}) {layout}",
                      got, block_matmul_plain(a, b), MATMUL_TOL[f32])
        if not torch.equal(got, block_matmul_kernel(a, b)):
            raise AssertionError(f"K1 {name}: two runs differ")
        errs["block_matmul"] = max(errs["block_matmul"], e)
        del a, b, got
    log("[kernels] K2 flash attention forward and backward vs plain "
        "(autograd of the plain forward)")
    for dtype in (f32, torch.bfloat16):
        for name, case in ATTN_CASES.items():
            B, T, S, nq, nkv, hd, causal, window, kv_len = case
            q, k, v, dout = attn_inputs(gen, B, T, S, nq, nkv, hd, dtype)
            kw = dict(causal=causal, window=window, kv_len=kv_len)
            out, lse = flash_attention_kernel(q, k, v, **kw)
            again, _ = flash_attention_kernel(q, k, v, **kw)
            if not torch.equal(out, again):
                raise AssertionError("K2 forward is not deterministic")
            grads = flash_attention_bwd_kernel(q, k, v, out, lse, dout, **kw)
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            want = attn_core(*qkv, **kw)
            wgrads = torch.autograd.grad(want, qkv, dout)
            tag = f"{dtype_name(dtype)} {name}"
            e = check_rel(f"{tag} out", out, want.detach(), FLASH_TOL[dtype])
            eb = max(check_rel(f"{tag} d{n}", g, w, FLASH_TOL[dtype])
                     for n, g, w in zip("qkv", grads, wgrads))
            log(f"  {tag}: forward run twice: bitwise equal")
            if dtype == f32:
                errs["flash_attention"] = max(errs["flash_attention"], e)
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"], eb)


def phase_parity(model, cfg):
    """Full width, kernels vs plain versions through paged_step."""
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.launch import steps as ST
    from repro_torch.models.decoder import paged_step
    R, T, page, n_pages = 8, 32, 16, 128
    build = ST.make_paged_step(cfg, MeshAxes())
    _, ct = build(n_pages, page)
    pools = {m: ST.zeros_caches(ct, "cuda") for m in ("kernel", "plain")}
    gen = torch.Generator().manual_seed(SEED + 1)
    tokens = torch.randint(1, cfg.vocab_size, (R, T), generator=gen,
                           dtype=torch.int32)
    q_len = torch.tensor([32, 32, 20, 32, 7, 32, 0, 32], dtype=torch.int32)
    positions = torch.arange(T, dtype=torch.int32).expand(R, T).contiguous()
    table = torch.zeros((R, n_pages - 1), dtype=torch.int32)
    for r in range(R):
        table[r, :4] = 1 + 4 * r + torch.arange(4)
    table = table.cuda()
    log(f"[parity] full-width {cfg.name}, float32: 1 prefill chunk (T={T}) "
        f"+ 4 decode steps, kernels vs plain")
    agree = total = 0
    for step in range(5):
        args = [t.cuda() for t in (tokens, positions, q_len)]
        out = {}
        for mode in ("kernel", "plain"):
            logits, _ = paged_step(model, args[0], pools[mode], args[1],
                                   args[2], table, plain=(mode == "plain"))
            out[mode] = logits
        live = q_len.cuda() > 0
        d = max_err(out["kernel"][live], out["plain"][live])
        scale = float(out["plain"][live].abs().max())
        ids = {m: out[m][:, 0].argmax(-1) for m in out}
        same = int((ids["kernel"] == ids["plain"])[live].sum())
        agree, total = agree + same, total + int(live.sum())
        log(f"  step {step} (T={tokens.shape[1]}): max|dlogit| = {d:.3e}, "
            f"max|logit| = {scale:.3e}, greedy agree {same}/"
            f"{int(live.sum())}")
        if not (d <= 1e-3 * scale and math.isfinite(d)):
            raise AssertionError("kernel logits disagree with plain")
        last = positions.gather(1, torch.clamp(q_len.long() - 1, 0)[:, None])
        tokens = ids["plain"].cpu().to(torch.int32)[:, None]
        positions = (last + 1).to(torch.int32)
        q_len = (q_len > 0).to(torch.int32)
    log(f"  greedy-token agreement {agree}/{total}")


def phase_serve(model, cfg, smi):
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    log(f"[serve] {' '.join(SERVE_FLAGS)}")
    engine, stats, reqs, launches, transient = serve_run(model, cfg, args)
    if not all(r.state == "done" and len(r.generated) == r.max_new
               for r in reqs):
        raise AssertionError("a request did not complete")
    if not torch.isfinite(engine.last_logits).all():
        raise AssertionError("non-finite logits")
    L = cfg.n_layers
    # per step: per layer norm1, norm2, q/k-norm; 7 projections; the tied
    # head; attention over the pages (K5's split walk, then its combine).
    # No K2: the engine is paged only
    per_step = {"paged_attention": L, "paged_attention_combine": L,
                "rmsnorm": 4 * L + 1,
                "block_matmul": 7 * L + 1, "flash_attention": 0,
                "flash_attention_bwd": 0, "selective_scan": 0,
                "partial_attention": 0, "partial_attention_bwd": 0}
    check_launches(launches, per_step, stats.n_steps, "step")
    log(f"  served {stats.n_requests} requests / {stats.total_new_tokens} "
        f"tokens in {stats.wall_s:.3f}s ({stats.n_steps} steps, "
        f"{stats.n_preemptions} preemptions) on {smi}")
    log(f"  tokens/s {stats.tokens_per_s:.1f}  ttft p50/p99 "
        f"{stats.ttft_p50_ms:.1f}/{stats.ttft_p99_ms:.1f} ms  latency "
        f"p50/p99 {stats.latency_p50_ms:.1f}/{stats.latency_p99_ms:.1f} ms  "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB, {transient / 2**20:.1f} MiB above the resident")
    return engine, args, launches, ([r.generated for r in reqs], transient)


def serve_run(model, cfg, args):
    """An engine of ``args``' knobs, warmed up, then ``args``' requests
    served with the launch counts set to 0 just before: (engine, stats,
    requests, launches, bytes the run allocated above what was resident
    when it started)."""
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.serving import PagedEngine, ServeConfig
    engine = PagedEngine(cfg, MeshAxes(), model, ServeConfig(
        slots=args.slots, page_size=args.page_size,
        pages_per_shard=args.pages, chunk=args.chunk))
    t0 = time.time()
    engine.warmup()
    torch.cuda.synchronize()
    log(f"  warmup {time.time() - t0:.2f}s")
    reqs = serve.make_requests(args, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ops.reset_launches()
    stats = engine.run(reqs)
    launches = ops.launches()
    return (engine, stats, reqs, launches,
            torch.cuda.max_memory_allocated() - resident)


def phase_serve_pool(model, cfg, smi, base):
    """Phase 5's requests on a pool of POOL_PAGES pages. The engine sends
    K5 only the table columns its rows reach, so the tokens are phase 5's
    bit for bit and the memory the run allocates above the resident
    (activations, K5's workspace) does not grow with the pool."""
    from repro_torch.launch import serve
    flags = list(SERVE_FLAGS)
    flags[flags.index("--pages") + 1] = str(POOL_PAGES)
    args = serve.build_parser().parse_args(flags)
    log(f"[serve pool] {' '.join(flags)}")
    engine, stats, reqs, _, transient = serve_run(model, cfg, args)
    tokens, base_transient = base
    log(f"  served {stats.n_requests} requests / {stats.total_new_tokens} "
        f"tokens in {stats.wall_s:.3f}s ({stats.n_steps} steps, "
        f"{stats.n_preemptions} preemptions) on {smi}; tokens/s "
        f"{stats.tokens_per_s:.1f}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{transient / 2**20:.1f} MiB above the resident (phase 5: "
        f"{base_transient / 2**20:.1f} MiB)")
    if [r.generated for r in reqs] != tokens:
        raise AssertionError("a larger pool served other tokens")
    if transient > base_transient + 64 * 2**20:
        raise AssertionError("the serving run's memory grows with the pool")
    log("  tokens equal to phase 5's; memory above the resident within "
        "64 MiB of phase 5's")
    phase_profile(engine, args, cfg, "pool profile")


def check_launches(launches, per_unit, units, unit):
    """Each kernel's launches must be its expected count per ``unit``
    times ``units``; a kernel the path runs must have launched."""
    for k, n in per_unit.items():
        log(f"  {k}: {launches[k]} launches = {launches[k] / units:g} per "
            f"{unit} over {units} {unit}s (expected {n})")
        if launches[k] != n * units:
            raise AssertionError(f"{k}: unexpected launch count")


def time_paged(name, q, kps, vps, table, q_pos, q_len):
    """K5's times on float32 inputs, one pool per layer in ``kps``/``vps``
    taken in turn (as many layers' pools as exceed the 50 MB L2, so each
    call finds its pages cold, as in serving). The library yardstick is
    SDPA over pages gathered beforehand (the gather is not timed), KV
    heads repeated to the query heads, with the same boolean mask. The
    bound counts q and out once, the pages the valid rows' keys need, their
    table entries, q_pos and q_len; operations 4 hd per (valid row, query
    head, visible key). Every version gets the table's columns that hold
    the rows' pages, as the serving engine sends them."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        paged_attention_kernel, paged_attention_plain)
    R, T, nq, hd = q.shape
    page, nkv = kps[0].shape[1], kps[0].shape[2]
    rows = valid_rows(q_len, T)
    pos = q_pos.long()
    n_keys = int((pos[rows] + 1).sum())
    last = torch.where(rows, pos, torch.full_like(pos, -1)).amax(1)
    pages = [int(p) // page + 1 for p in last.tolist() if p >= 0]
    n_used = max(pages)
    S = n_used * page
    table = table[:, :n_used].contiguous()
    layer = [0]

    def rotate(fn):
        def call():
            i = layer[0] = (layer[0] + 1) % len(kps)
            return fn(i)
        return call
    idx = table.long()
    kg = [kp[idx].reshape(R, S, nkv, hd).transpose(1, 2)
          .repeat_interleave(nq // nkv, dim=1) for kp in kps]
    vg = [vp[idx].reshape(R, S, nkv, hd).transpose(1, 2)
          .repeat_interleave(nq // nkv, dim=1) for vp in vps]
    mask = (torch.arange(S, device="cuda")[None, None, :]
            <= pos[:, :, None])[:, None]                 # (R, 1, T, S)
    qs = q.transpose(1, 2)
    nbytes = (2 * int(rows.sum()) * nq * hd * 4
              + 2 * sum(pages) * page * nkv * hd * 4
              + sum(pages) * 4 + q_pos.numel() * 4 + R * 4)
    check_close(f"K5 {name} (the timed inputs)",
                paged_attention_kernel(q, kps[0], vps[0], table, q_pos,
                                       q_len),
                paged_attention_plain(q, kps[0], vps[0], table, q_pos, q_len),
                PAGED_TOL[torch.float32], rows)
    t, eager = timings(
        rotate(lambda i: paged_attention_kernel(q, kps[i], vps[i], table,
                                                q_pos, q_len)),
        rotate(lambda i: paged_attention_plain(q, kps[i], vps[i], table,
                                               q_pos, q_len)),
        rotate(lambda i: F.scaled_dot_product_attention(
            qs, kg[i], vg[i], attn_mask=mask)),
        nbytes, 4 * hd * nq * n_keys, torch.float32, iters=28)
    log(f"  paged_attention ({name}): " + fmt(t, eager)
        + f"; {t['ms'] / t['library_ms']:.2f}x SDPA")
    return t


def phase_timings(gen, n_layers):
    """Serving shapes (8 slots at 144 tokens of context; K5 also over
    Jamba's dense decode cache), then the training and K6 timings."""
    from repro_torch.layers.attention import DENSE_PAGE, dense_page_view
    f32 = torch.float32
    out = {}
    log("[timings] float32, decode-step shapes, CUDA events: device "
        "time from a replayed CUDA graph / eager calls back to back")
    out["rmsnorm"] = phase_timings_rmsnorm(gen)[(8, 2048)]
    split = phase_timings_rms_split(gen)
    out["rmsnorm_stats"], out["rmsnorm_apply"] = split[RMS_SPLIT_SHAPES[0]]

    # K5 at three shapes: decode and chunked prefill of continuous serving
    # (8 slots, 144 tokens of context, page 16), and the decode step of
    # Jamba's fixed serving over its dense cache
    for name, T, q_len in (("decode, 8 slots x 144 tokens, T=1", 1, 1),
                           ("chunked prefill, 8 slots, chunk 32, context "
                            "144", 32, 32)):
        q, kp, vp, table, q_pos, ql = paged_inputs(
            gen, ctx=[144] * 8, q_len=[q_len] * 8, T=T, dtype=f32,
            n_layers=n_layers)
        t = time_paged(name, q, list(kp), list(vp), table, q_pos, ql)
        out.setdefault("paged_attention", t)
        del q, kp, vp
    (B, nq, nkv, hd), ctx = DENSE_DECODE["Jamba"]
    ctx = max(ctx)
    pools, table = [], None
    for _ in range(4):      # Jamba's 4 attention layers, 71 MB over the L2
        kc, vc = (torch.randn((B, ctx, nkv, hd), generator=gen,
                              device="cuda") for _ in range(2))
        (kp, table), (vp, _) = dense_page_view(kc), dense_page_view(vc)
        pools.append((kp, vp))
    q = torch.randn((B, 1, nq, hd), generator=gen, device="cuda")
    q_pos = torch.full((B, 1), ctx - 1, dtype=torch.int32, device="cuda")
    time_paged(f"Jamba dense decode, B {B}, context {ctx}, {nq}/{nkv} heads, "
               f"page {DENSE_PAGE}", q, [p[0] for p in pools],
               [p[1] for p in pools], table, q_pos,
               torch.ones((B,), dtype=torch.int32, device="cuda"))
    del pools, kp, vp, kc, vc
    time_seqshard(gen)
    phase_timings_train(gen, out)
    log("[timings] K6 at the fixed-serving shapes: device time from a "
        "replayed CUDA graph / eager calls back to back")
    phase_timings_scan(gen, out)
    return out


def time_seqshard(gen):
    """K5 with its lse at 14b's shape, the row seeing every key of the
    shard (the ranks' view of the owning shard's and earlier shards'
    keys). The library yardstick is SDPA over the same keys, KV heads
    repeated to the query heads (as ``time_paged``'s); the bound reads K
    and V once (1.07 GB)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        paged_attention_kernel, paged_attention_plain)
    c = SEQ_K5
    args = seqshard_inputs(gen, torch.float32, c["keys"] - 1)
    q, kp, vp = args[:3]
    g = c["nq"] // c["nkv"]
    kg, vg = (p.reshape(1, c["keys"], c["nkv"], c["hd"]).transpose(1, 2)
              .repeat_interleave(g, dim=1) for p in (kp, vp))
    nbytes = (2 * c["keys"] * c["nkv"] * c["hd"] * 4
              + 2 * c["nq"] * c["hd"] * 4 + c["nq"] * 4
              + args[3].numel() * 4 + 8)
    t, eager = timings(
        lambda: paged_attention_kernel(*args, return_lse=True),
        lambda: paged_attention_plain(*args, return_lse=True),
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kg, vg),
        nbytes, 4 * c["hd"] * c["nq"] * c["keys"], torch.float32, iters=20,
        eager_iters=20)
    log(f"  paged_attention with lse (seq-sharded decode, 1 row, "
        f"{c['keys']} keys a shard, {c['nq']}/{c['nkv']} heads, "
        f"{args[3].shape[1]} pages of 32; workspace "
        f"{workspace_bytes(args) / 1e6:.1f} MB): " + fmt(t, eager)
        + f"; {t['ms'] / t['library_ms']:.2f}x SDPA")
    return t


def workspace_bytes(args):
    """Bytes of the fp32 workspace K5 allocates for these inputs."""
    from repro_torch.kernels.flash_attention import _launcher
    q, kp, _, table = args[:4]
    R, T, nq, hd = q.shape
    return 4 * _launcher()[1](R, T, nq, kp.shape[2], hd, table.shape[1],
                              kp.shape[1])


def phase_timings_rmsnorm(gen):
    """K3 at RMS_SHAPES, float32, beside F.rms_norm; returns each shape's
    times. The bound counts x and out once and gamma once."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain
    rms = {}
    for rows, d in RMS_SHAPES:
        x = torch.randn((rows, d), generator=gen, device="cuda")
        g = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        t, eager = timings(lambda: rmsnorm_kernel(x, g),
                           lambda: rmsnorm_plain(x, g),
                           lambda: F.rms_norm(x, (d,), g, 1e-6),
                           2 * x.numel() * 4 + d * 4, 4 * x.numel(),
                           torch.float32)
        rms[(rows, d)] = t
        log(f"  rmsnorm ({rows}, {d}): " + fmt(t, eager)
            + f"; {t['ms'] / t['library_ms']:.2f}x F.rms_norm, "
            f"{t['bound_ms'] / t['ms']:.3f} of the bound")
    return rms


def phase_timings_rms_split(gen):
    """K3's stats and apply passes at RMS_SPLIT_SHAPES, float32; returns
    each shape's (stats, apply) times. The stats pass's library call is
    ``torch.linalg.vecdot(x, x)`` (the same sums in one call); the apply
    pass has none, and ``F.rms_norm`` over the local row (another
    function: its own row's mean) is logged beside both as a yardstick.
    The bounds count x once and the sums once, and gamma and the output
    once for the apply pass."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (
        rmsnorm_apply_kernel, rmsnorm_apply_plain, rmsnorm_stats_kernel,
        rmsnorm_stats_plain)
    out = {}
    for rows, d in RMS_SPLIT_SHAPES:
        x = torch.randn((rows, d), generator=gen, device="cuda")
        g = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        ss = rmsnorm_stats_kernel(x) * 2
        n = x.numel()
        ts, es = timings(lambda: rmsnorm_stats_kernel(x),
                         lambda: rmsnorm_stats_plain(x),
                         lambda: torch.linalg.vecdot(x, x),
                         n * 4 + rows * 4, 2 * n, torch.float32)
        ta, ea = timings(lambda: rmsnorm_apply_kernel(x, g, ss,
                                                      full_dim=2 * d),
                         lambda: rmsnorm_apply_plain(x, g, ss,
                                                     full_dim=2 * d),
                         None, 2 * n * 4 + rows * 4 + d * 4, 2 * n,
                         torch.float32)
        yard = graph_ms(lambda: F.rms_norm(x, (d,), g, 1e-6))
        for name, t, e in (("stats", ts, es), ("apply", ta, ea)):
            log(f"  rmsnorm {name} ({rows}, {d}): " + fmt(t, e)
                + f"; F.rms_norm over the local row {yard * 1e3:.2f} us, "
                f"{t['bound_ms'] / t['ms']:.3f} of the bound")
        out[(rows, d)] = (ts, ta)
    return out


def phase_timings_train(gen, out):
    """K1 at the training and decode shapes; K2 forward and backward at the
    training shape. K2's backward runs eagerly for all three versions (the
    plain and library backwards are autograd's, which a graph captured
    apart from its forward cannot replay), as the median of 7 rounds (the
    plain version's of 5)."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_matmul import (block_matmul_kernel,
                                                  block_matmul_plain)
    from repro_torch.kernels.flash_attention import (
        attn_core, flash_attention_bwd_kernel, flash_attention_kernel)
    f32 = torch.float32
    log("[timings] float32, training shapes: device time from a replayed "
        "CUDA graph / eager calls back to back")
    bf16 = torch.bfloat16
    mesh = [c for c in MESH_TRAIN_MATMUL_SHAPES if c[0] in MESH_TRAIN_TIMED]
    shapes = [(f32, None, *c) for c in MATMUL_SHAPES + mesh
              + RING_MATMUL_SHAPES] + [
        (bf16, None, *c) for c in MATMUL_SHAPES
        if c[0] in MATMUL_BF16_TIMED] + [
        (bf16, out, *c) for c in mesh if c[4] == "TN" for out in (None, f32)]
    for dtype, out_dtype, name, M, K, N, layout in shapes:
        a, b = matmul_inputs(gen, M, K, N, layout, dtype)
        heavy = N > 100_000 and M > 64
        elt, out_elt = a.element_size(), (4 if out_dtype else
                                          a.element_size())
        t, eager = timings(lambda: block_matmul_kernel(a, b,
                                                       out_dtype=out_dtype),
                           lambda: block_matmul_plain(a, b,
                                                      out_dtype=out_dtype),
                           lambda: torch.matmul(a, b),
                           elt * (M * K + K * N) + out_elt * M * N,
                           2 * M * N * K, dtype, iters=5 if heavy else 50,
                           eager_iters=5 if heavy else 100)
        tag = dtype_name(dtype) + (" -> float32" if out_dtype else "")
        log(f"  block_matmul {tag} {name} ({M}, {K}) x ({K}, {N}) {layout}: "
            + fmt(t, eager) + f"; {2 * M * N * K / t['ms'] / 1e9:.1f} "
            f"TFLOP/s, {t['bound_ms'] / t['ms']:.3f} of the bound")
        if dtype == f32:
            out.setdefault("block_matmul", t)
        del a, b
    for case in (ATTN_JAMBA, ATTN_MAIN):
        B, T, S, nq, nkv, hd, causal, window, kv_len = case
        q, k, v, dout = attn_inputs(gen, B, T, S, nq, nkv, hd, f32)
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        pairs, fwd_bytes = attn_work(*case, 4)
        lse_bytes = B * nq * T * 4
        g = nq // nkv
        ks, vs = (t.transpose(1, 2).repeat_interleave(g, dim=1)
                  for t in (k, v))
        qs = q.transpose(1, 2)
        with sdpa_backend():
            t, eager = timings(
                lambda: flash_attention_kernel(q, k, v, **kw),
                lambda: attn_core(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                       is_causal=True),
                fwd_bytes + lse_bytes, 4 * hd * pairs, f32, iters=20,
                eager_iters=50)
        log(f"  flash_attention forward (B {B}, T {T}, {nq}/{nkv} heads, hd "
            f"{hd}, causal): " + fmt(t, eager)
            + f"; {t['ms'] / t['library_ms']:.2f}x {SDPA_NAME}; "
            f"{4 * hd * pairs / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['bound_ms'] / t['ms']:.3f} of the bound")
    out["flash_attention"] = t
    o, lse = flash_attention_kernel(q, k, v, **kw)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    plain_out = attn_core(*qkv, **kw)
    lib_in = [x.clone().requires_grad_() for x in (qs, ks, vs)]
    with sdpa_backend():
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True)
    dout_s = dout.transpose(1, 2)
    r = dict(
        ms=eager_rounds(lambda: flash_attention_bwd_kernel(
            q, k, v, o, lse, dout, **kw)),
        plain_ms=eager_rounds(lambda: torch.autograd.grad(
            plain_out, qkv, dout, retain_graph=True), 5, 10),
        library_ms=eager_rounds(lambda: torch.autograd.grad(
            lib_out, lib_in, dout_s, retain_graph=True)))
    bwd = dict({key: r[key]["median"] for key in r},
               **bound(2 * fwd_bytes + lse_bytes, 10 * hd * pairs, f32))
    log(f"  flash_attention backward (eager): kernel {spread(r['ms'])}, "
        f"plain {spread(r['plain_ms'])}, {SDPA_NAME} backward "
        f"{spread(r['library_ms'])}; kernel "
        f"{bwd['ms'] / bwd['library_ms']:.2f}x the library; "
        f"{10 * hd * pairs / bwd['ms'] / 1e9:.1f} TFLOP/s, bound "
        f"{bwd['bound_ms'] * 1e3:.3f} us ({bwd['bound_by']}), "
        f"{bwd['bound_ms'] / bwd['ms']:.3f} of it")
    out["flash_attention_bwd"] = bwd


def sm_clocks_mhz():
    """The SM clock nvidia-smi reads now and its maximum (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0]
    return tuple(float(v) for v in out.split(","))


def phase_timings_scan(gen, out):
    """K6 at the prefill and decode shapes in float32 and at the prefill
    in bfloat16. No PyTorch call computes a selective scan: the library
    column is null. The plain version's 512 steps make a long graph, so it
    is replayed fewer times. The bound counts bytes in x's dtype and the
    operations at the float32 rate (the arithmetic is float32 in either
    dtype). Beside it the log gives the SFU floor, Bt T d N exps at 16 a
    clock on each of the 132 SMs (SFU_PER_CLOCK): not a bound, since the
    FMA pipe could compute some exps."""
    from repro_torch.kernels.selective_scan import (selective_scan_kernel,
                                                    selective_scan_plain)
    f32 = torch.float32
    for dtype, (name, Bt, T, d, N, with_s0) in SCAN_TIMED:
        args = scan_inputs(gen, Bt, T, d, N, dtype, with_s0)
        t = dict(ms=graph_ms(lambda: selective_scan_kernel(*args),
                             20 if T > 1 else 100),
                 plain_ms=graph_ms(lambda: selective_scan_plain(*args),
                                   2 if T > 1 else 50),
                 library_ms=None, **bound(*scan_work(Bt, T, d, N, dtype,
                                                     with_s0), f32))
        now, top = sm_clocks_mhz()
        eager = cuda_ms(lambda: selective_scan_kernel(*args), 50, 5)
        sfu_us = [Bt * T * d * N / (SFU_PER_CLOCK * mhz) for mhz in (top,
                                                                     now)]
        log(f"  selective_scan {dtype_name(dtype)} {name} (Bt {Bt}, T {T}, "
            f"d {d}, N {N}): kernel {t['ms'] * 1e3:.2f}/{eager * 1e3:.2f} us "
            f"(device/eager), plain {t['plain_ms'] * 1e3:.2f} us (device), "
            f"no library call, bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of it; SFU "
            f"floor {sfu_us[0]:.3f} us at the maximum SM clock {top:.0f} "
            f"MHz ({sfu_us[1]:.3f} us at {now:.0f} MHz, read after the "
            f"timing)")
        if dtype == f32:
            out.setdefault("selective_scan", t)


def bound(nbytes, n_ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def fmt(t, eager):
    us = {k: (f"{t[k] * 1e3:.2f}/{eager[k] * 1e3:.2f}" if t[k] is not None
              else "none") for k in eager}
    return (f"kernel {us['ms']} us, plain {us['plain_ms']} us, library "
            f"{us['library_ms']} us (device/eager), bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")


KERNEL_GROUPS = (("sgemm_tile_kernel", "K1 block_matmul"),
                 ("gemv_n_kernel", "K1 block_matmul"),
                 ("gemv_k_kernel", "K1 block_matmul"),
                 ("split_sum_kernel", "K1 block_matmul"),
                 ("flash_fwd_kernel", "K2 flash_attention forward"),
                 ("flash_bwd", "K2 flash_attention backward"),
                 ("rmsnorm", "K3 rmsnorm"),
                 ("paged_split_kernel", "K5 paged_attention"),
                 ("paged_combine_kernel", "K5 paged_attention"),
                 ("selective_scan_kernel", "K6 selective_scan"))


def dev_us(e):
    """A profiler row's own device time (µs)."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def log_split(kernels, total, top):
    """Device time by kernel group, then the ``top`` kernels."""
    def group(name):
        for key, g in KERNEL_GROUPS:
            if key in name:
                return g
        if any(w in name.lower() for w in ("gemm", "gemv", "splitk")):
            return "GEMM (cuBLAS)"
        return "other PyTorch kernels"
    groups = {}
    for e in kernels:
        g = group(e.key)
        groups[g] = groups.get(g, 0.0) + dev_us(e)
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {us / 1e3:.2f} ms ({100 * us / total:.1f}% of device "
            f"time)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


def phase_profile(engine, args, cfg, label="profile"):
    """Where a serving run's device time goes, by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    args.requests, args.gen = 8, 8
    reqs = serve.make_requests(args, cfg.vocab_size)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        steps = engine.run(reqs).n_steps
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device kernels only: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev_us(e) for e in kernels)
    log(f"[{label}] 8 requests x 8 tokens (prompt 128), {steps} steps: wall "
        f"{wall * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms "
        f"({'not measured' if not total else f'{total / 1e4 / wall:.1f}%'})")
    log_split(kernels, total, 8)


def phase_train_parity(cfg):
    """Full width, float32: one microbatch's loss and gradients through the
    kernels and through the plain versions, before any optimizer state."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.decoder import lm_loss
    model = ST.init_model(cfg, seed=SEED, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    tokens, labels = (torch.randint(0, cfg.vocab_size, (2, 512),
                                    generator=gen).cuda() for _ in range(2))
    log(f"[train parity] full-width {cfg.name}, float32, one microbatch "
        f"(2 x 512), remat full: kernels vs plain, the kernels twice")
    res = {}
    for mode in ("kernel", "again", "plain"):
        t0 = time.time()
        loss, _ = lm_loss(model, tokens, labels, plain=(mode == "plain"))
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads.values())))
        res[mode] = (float(loss.detach()), norm, grads)
        log(f"  {mode}: loss {res[mode][0]:.6f}, grad norm {norm:.6f}, "
            f"{time.time() - t0:.2f}s")
    (lk, nk, gk), (lp, np_, gp) = res["kernel"], res["plain"]
    same = lk == res["again"][0] and all(
        torch.equal(gk[n], res["again"][2][n]) for n in gk)
    log(f"  kernels run twice: loss and all {len(gk)} gradients "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("a training microbatch does not repeat")
    del res["again"]
    worst = max(((float((gk[n] - gp[n]).abs().max())
                  / max(float(gp[n].abs().max()), 1e-30)), n) for n in gp)
    log(f"  |dloss|/loss {abs(lk - lp) / abs(lp):.3e} (tol "
        f"{TRAIN_TOL['loss']:g}), |dnorm|/norm {abs(nk - np_) / np_:.3e} "
        f"(tol {TRAIN_TOL['grad_norm']:g}), worst leaf max|dg|/max|g| "
        f"{worst[0]:.3e} at {worst[1]} (tol {TRAIN_TOL['leaf']:g})")
    if not (abs(lk - lp) <= TRAIN_TOL["loss"] * abs(lp)
            and abs(nk - np_) <= TRAIN_TOL["grad_norm"] * np_
            and worst[0] <= TRAIN_TOL["leaf"] and math.isfinite(lk)):
        raise AssertionError("kernel gradients disagree with plain")


def train_launch_counts(cfg):
    """Each kernel's launches per microbatch of the training step on one
    card (or a rank of a mesh with x, y and z 1): K1 = forward 7L + 1
    (tied head), remat recompute 7L, backward 2 (dX, dW) x (7L + 1); K2
    forward + recompute 2L, backward L; K3 = 4L + 1 forward (norm1, norm2,
    q/k-norm; final) + 4L recompute; no other kernel."""
    L = cfg.n_layers
    return {"block_matmul": 28 * L + 3, "flash_attention": 2 * L,
            "flash_attention_bwd": L, "rmsnorm": 8 * L + 1,
            "paged_attention": 0, "paged_attention_combine": 0,
            "selective_scan": 0, "partial_attention": 0,
            "partial_attention_bwd": 0}


def phase_train(cfg, smi):
    """The port's training entry point at full width, kernels counted."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    log(f"[train] python -m repro_torch.launch.train {' '.join(TRAIN_FLAGS)}")
    ops.reset_launches()
    res = train.main(TRAIN_FLAGS)
    launches = ops.launches()
    if not all(math.isfinite(x) for x in res.losses + res.grad_norms):
        raise AssertionError("non-finite loss or grad norm")
    args = train.build_parser().parse_args(TRAIN_FLAGS)
    check_launches(launches, train_launch_counts(cfg),
                   args.steps * args.overdecompose, "microbatch")
    steady = res.step_s[1:] or res.step_s
    step_s = sum(steady) / len(steady)
    tok_s = res.tokens_per_step / step_s
    share = 6 * res.n_params * res.tokens_per_step / step_s / PEAK_OPS_PER_S[
        torch.float32]
    log(f"  losses {res.losses}, grad norms {res.grad_norms}")
    log(f"  step times {[round(x, 4) for x in res.step_s]} s; steady step "
        f"{step_s:.4f} s, {tok_s:.1f} tokens/s, 6*N*tokens/step time = "
        f"{100 * share:.2f}% of the 67 TFLOP/s float32 peak, "
        f"max_memory_allocated {res.max_memory_bytes / 2**30:.2f} GiB on "
        f"{smi}")
    return launches, res


def phase_train_profile(cfg):
    """Where one full-width training step's device time goes, by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.data.synthetic import DataConfig, SyntheticText
    from repro_torch.launch import steps as ST
    from repro_torch.optim.adamw import AdamWConfig, init_state
    model = ST.init_model(cfg, seed=SEED, device="cuda")
    state = init_state(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, MeshAxes(), AdamWConfig(
        warmup_steps=1, total_steps=3), ST.TrainOptions(
        overdecompose=2, dtype=torch.float32))
    data = SyntheticText(DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                                    global_batch=4))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    float(step(model, state, batch)["loss"])          # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        float(step(model, state, batch)["loss"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]

    total = sum(dev_us(e) for e in kernels)
    log(f"[train profile] one step (4 x 512 tokens, 2 microbatches), under "
        f"the profiler: wall {wall * 1e3:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms ("
        f"{'not measured' if not total else f'{total / 1e4 / wall:.1f}%'})")
    if not total:
        return

    log_split(kernels, total, 12)


def fixed_launches(cfg, prefills, decodes):
    """Each kernel's launches in ``prefills`` prefills and ``decodes``
    decode steps of fixed-batch serving, counted from the code: per layer
    norm1 and norm2 (K3), an attention layer's q/k/v/o projections (K1),
    its q/k-norm (K3, if the config has it) and K2 at prefill or K5 (and
    its combine) at decode; a Mamba layer's w_in, w_gate, w_x, w_dt and w_out (K1) and one
    scan (K6); the MLP's three projections (K1); then the final norm (K3)
    and the head (K1), on the last row only at prefill."""
    n_attn = cfg.mixers().count("attn")
    n_mamba = cfg.mixers().count("mamba")
    fwd = prefills + decodes
    return {"block_matmul": fwd * (4 * n_attn + 5 * n_mamba
                                   + 3 * cfg.n_layers + 1),
            "rmsnorm": fwd * (2 * cfg.n_layers + 1
                              + (2 * n_attn if cfg.qk_norm else 0)),
            "selective_scan": fwd * n_mamba,
            "flash_attention": prefills * n_attn,
            "paged_attention": decodes * n_attn,
            "paged_attention_combine": decodes * n_attn,
            "flash_attention_bwd": 0, "partial_attention": 0,
            "partial_attention_bwd": 0}


def phase_fixed_parity(model, cfg):
    """Full width, kernels vs plain versions through the fixed-batch
    prefill and decode steps."""
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.launch import steps as ST
    B, T, steps = 4, 512, 4
    pre, ct = ST.make_prefill_step(cfg, MeshAxes())(B, T, T + steps + 1)
    dec, _ = ST.make_decode_step(cfg, MeshAxes())(B, T + steps + 1)
    caches = {m: ST.zeros_caches(ct, "cuda") for m in ("kernel", "plain")}
    gen = torch.Generator().manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           dtype=torch.int32).cuda()
    log(f"[fixed parity] full-width {cfg.name}, float32: prefill {B} x {T} "
        f"+ {steps} decode steps, kernels vs plain")
    for step in range(steps + 1):
        out = {}
        for mode in ("kernel", "plain"):
            t0 = time.time()
            if step == 0:
                out[mode], _ = pre(model, caches[mode], tokens,
                                   plain=(mode == "plain"))
            else:
                out[mode], _ = dec(model, caches[mode], tokens, T + step - 1,
                                   plain=(mode == "plain"))
            torch.cuda.synchronize()
            out[mode + "_s"] = time.time() - t0
        d = max_err(out["kernel"], out["plain"])
        scale = float(out["plain"].abs().max())
        ids = {m: out[m][:, -1].argmax(-1) for m in ("kernel", "plain")}
        same = int((ids["kernel"] == ids["plain"]).sum())
        log(f"  {'prefill' if step == 0 else f'decode {step}'}: "
            f"max|dlogit| = {d:.3e}, max|logit| = {scale:.3e}, greedy "
            f"agree {same}/{B}; kernels {out['kernel_s']:.3f}s, plain "
            f"{out['plain_s']:.3f}s")
        if not (d <= 1e-3 * scale and math.isfinite(d)):
            raise AssertionError("kernel logits disagree with plain")
        if same != B:
            raise AssertionError("kernel greedy ids differ from plain")
        tokens = ids["plain"].to(torch.int32)[:, None]
    worst = max((max_err(a, b) / max(float(b.abs().max()), 1e-30), i, k)
                for i, (la, lb) in enumerate(zip(caches["kernel"],
                                                 caches["plain"]))
                for k, (a, b) in ((k, (la[k], lb[k])) for k in la))
    log(f"  caches after the last step: worst max|d|/max|plain| "
        f"{worst[0]:.3e} (layer {worst[1]}, {worst[2]})")
    if not worst[0] <= 1e-3:
        raise AssertionError("kernel caches disagree with plain")


def phase_fixed_serve(model, cfg, smi):
    """``serve.py --mode fixed`` at full width, kernels counted."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(FIXED_FLAGS)
    log(f"[fixed serve] python -m repro_torch.launch.serve "
        f"{' '.join(FIXED_FLAGS)}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.run_fixed(args, model)
    launches = ops.launches()
    if not (torch.isfinite(res.logits).all()
            and res.ids.shape == (args.batch, args.gen)
            and 0 <= res.ids.min() and res.ids.max() < cfg.padded_vocab):
        raise AssertionError("non-finite logits or malformed ids")
    # warm-up: 1 prefill + 1 decode step; timed: 1 prefill + gen - 1 steps
    want = fixed_launches(cfg, prefills=2, decodes=args.gen)
    for k, n in want.items():
        log(f"  {k}: {launches[k]} launches (expected {n})")
        if launches[k] != n:
            raise AssertionError(f"{k}: unexpected launch count")
    log(f"  prefill {args.batch} x {args.prompt_len}: {res.prefill_s:.4f} s "
        f"({args.batch * args.prompt_len / res.prefill_s:.1f} tokens/s); "
        f"decode {args.gen - 1} steps x batch {args.batch}: "
        f"{res.decode_s:.4f} s, {res.decode_tokens_per_s:.1f} tokens/s, "
        f"{1e3 * res.decode_s / (args.gen - 1):.2f} ms/step; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB on {smi}")
    return launches


def phase_fixed_profile(model, cfg):
    """Where a prefill's and 8 decode steps' device time goes, by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.launch import steps as ST
    B, T, steps = 4, 512, 8
    pre, ct = ST.make_prefill_step(cfg, MeshAxes())(B, T, T + steps)
    dec, _ = ST.make_decode_step(cfg, MeshAxes())(B, T + steps)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.
                           Generator().manual_seed(SEED), dtype=torch.int32
                           ).cuda()
    caches = ST.zeros_caches(ct, "cuda")
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        logits, _ = pre(model, caches, tokens)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        walls["prefill"] = time.time() - t0
        t0 = time.time()
        for i in range(steps):
            logits, _ = dec(model, caches, tok, T + i)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        walls["decode"] = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev_us(e) for e in kernels)
    wall = sum(walls.values())
    log(f"[fixed profile] prefill {B} x {T} + {steps} decode steps, under "
        f"the profiler: wall {walls['prefill'] * 1e3:.1f} + "
        f"{walls['decode'] * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms "
        f"({'not measured' if not total else f'{total / 1e4 / wall:.1f}%'})")
    if total:
        log_split(kernels, total, 12)


# ---------------------------------------------------------------------- #
# context parallelism: K4 and two seq-ranks on the card
# ---------------------------------------------------------------------- #

def partial_inputs(gen, dtype):
    B, C, nq, nkv, hd, p = PARTIAL_MAIN

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (rand(B, C, nq, hd), rand(B, p * C, nkv, hd),
            rand(B, p * C, nkv, hd), rand(B, C, nq, hd))


def partial_mask(r, window):
    """(C, p C) visibility of rank r's queries over the gathered keys."""
    B, C, nq, nkv, hd, p = PARTIAL_MAIN
    i = torch.arange(C, device="cuda")[:, None] * p + r
    g = torch.arange(p * C, device="cuda")[None, :]
    j = (g % C) * p + g // C
    vis = i >= j
    if window:
        vis &= (i - j) < window
    return vis


def phase_kernels_partial(gen, errs):
    """K4 forward and backward against the plain chain and its autograd,
    at the seq path's shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (attn_partial_finalize,
                                                     attn_partial_init)
    from repro_torch.layers.attention import partial_chain, partial_chain_bwd
    f32 = torch.float32
    B, C, nq, nkv, hd, p = PARTIAL_MAIN
    log(f"[kernels] K4 partial attention forward and backward vs plain "
        f"(B {B}, {C} queries at r + {p} j, {p} gathered blocks of {C} keys, "
        f"{nq}/{nkv} heads, hd {hd}; backward vs the plain chain's "
        f"autograd on fp32 copies)")
    for dtype in (f32, torch.bfloat16):
        q, kg, vg, dout = partial_inputs(gen, dtype)
        for window in PARTIAL_WINDOWS:
            for r in range(p):
                carry = partial_chain(q, kg, vg, r, p, window=window)
                out = attn_partial_finalize(carry, dtype)
                grads = partial_chain_bwd(q, kg, vg, dout, out, carry, r, p,
                                          window=window)
                leaves = [t.float().requires_grad_() for t in (q, kg, vg)]
                wcarry = partial_chain(*leaves, r, p, window=window,
                                       plain=True)
                want = attn_partial_finalize(wcarry, f32)
                wgrads = torch.autograd.grad(want, leaves, dout.float())
                tag = f"{dtype_name(dtype)} r={r} window={window}"
                e = max(check_rel(f"{tag} {n}", g, w.detach(), 1e-4)
                        for n, g, w in zip(("m", "l", "acc"), carry,
                                           wcarry))
                e = max(e, check_rel(f"{tag} out", out, want.detach(),
                                     FLASH_TOL[dtype]))
                eb = max(check_rel(f"{tag} d{n}", g, w, FLASH_TOL[dtype])
                         for n, g, w in zip(("q", "k", "v"), grads, wgrads))
                again = partial_chain(q, kg, vg, r, p, window=window)
                if not all(torch.equal(a, b) for a, b in zip(again, carry)):
                    raise AssertionError("K4 forward is not deterministic")
                if not all(torch.equal(a, b) for a, b in zip(
                        partial_chain_bwd(q, kg, vg, dout, out, carry, r, p,
                                          window=window), grads)):
                    raise AssertionError("K4 backward is not deterministic")
                log(f"  {tag}: forward and backward run twice: bitwise "
                    f"equal")
                if r == 0:
                    # query 0 (position 0) sees no key of block 1 (keys at
                    # 1, 3, ...): its carry after block 0 passes through
                    first = ops.flash_attention_partial(
                        q, kg[:, :C], vg[:, :C],
                        *attn_partial_init(B, C, nq, hd, device="cuda"),
                        q_stride=p, k_stride=p, window=window)
                    if not all(torch.equal(a[:, :, 0], b[:, :, 0])
                               for a, b in zip(first, carry)):
                        raise AssertionError("a fully masked row's carry "
                                             "changed")
                    log(f"  {tag}: the row block 1 fully masks keeps its "
                        f"carry bitwise")
                if dtype == f32:
                    errs["partial_attention"] = max(
                        errs["partial_attention"], e)
                    errs["partial_attention_bwd"] = max(
                        errs["partial_attention_bwd"], eb)
        del q, kg, vg, dout


def phase_timings_partial(gen, out):
    """K4 forward and backward at the seq path's shape, float32, rank 0's
    chain over the p gathered blocks (p launches). The library call is
    SDPA over the gathered keys with the same boolean mask: it computes
    the finalised output, not the carry. The backward runs eagerly for
    all three versions (the plain and library backwards are autograd's),
    and the kernel's chain is also replayed from a CUDA graph, which
    leaves out the host's issue."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attn_partial_finalize,
                                                     attn_partial_init)
    from repro_torch.layers.attention import partial_chain, partial_chain_bwd
    f32 = torch.float32
    B, C, nq, nkv, hd, p = PARTIAL_MAIN
    q, kg, vg, dout = partial_inputs(gen, f32)
    init = attn_partial_init(B, C, nq, hd, device="cuda")
    vis = partial_mask(0, 0)
    pairs = int(vis.sum()) * B * nq
    carry_bytes = 2 * (2 * B * nq * C + B * nq * C * hd) * 4
    qkv_bytes = (B * C * nq + 2 * B * p * C * nkv) * hd * 4
    g = nq // nkv
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(g, dim=1) for t in (kg, vg))
    with sdpa_backend():
        t, eager = timings(
            lambda: partial_chain(q, kg, vg, 0, p, carry=init),
            lambda: partial_chain(q, kg, vg, 0, p, carry=init, plain=True),
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=vis),
            qkv_bytes + carry_bytes, 4 * hd * pairs, f32, iters=20,
            eager_iters=50)
    log(f"[timings] K4 forward, chain of {p} blocks (B {B}, {C} queries, "
        f"{p} x {C} keys, {nq}/{nkv} heads, hd {hd}, causal, stride {p}): "
        + fmt(t, eager) + f"; {t['ms'] / t['library_ms']:.2f}x {SDPA_NAME}; "
        f"{4 * hd * pairs / t['ms'] / 1e9:.1f} TFLOP/s, "
        f"{t['bound_ms'] / t['ms']:.3f} of the bound")
    out["partial_attention"] = t
    carry = partial_chain(q, kg, vg, 0, p, carry=init)
    o = attn_partial_finalize(carry, f32)
    leaves = [x.clone().requires_grad_() for x in (q, kg, vg)]
    plain_out = attn_partial_finalize(
        partial_chain(*leaves, 0, p, plain=True), f32)
    lib_in = [x.clone().requires_grad_() for x in (qs, ks, vs)]
    with sdpa_backend():
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=vis)
    dout_s = dout.transpose(1, 2)
    bwd_bytes = (qkv_bytes + 2 * B * C * nq * hd * 4          # q.. + dout
                 + 2 * B * nq * C * 4                         # lse, delta
                 + 2 * B * C * nq * hd * 4                    # dq in, out
                 + 2 * B * p * C * nkv * hd * 4)              # dk, dv
    r = dict(
        ms=eager_rounds(lambda: partial_chain_bwd(q, kg, vg, dout, o, carry,
                                                  0, p)),
        plain_ms=eager_rounds(lambda: torch.autograd.grad(
            plain_out, leaves, dout, retain_graph=True), 5, 10),
        library_ms=eager_rounds(lambda: torch.autograd.grad(
            lib_out, lib_in, dout_s, retain_graph=True)))
    bwd = dict({key: r[key]["median"] for key in r},
               **bound(bwd_bytes, 10 * hd * pairs, f32))
    replayed = graph_ms(lambda: partial_chain_bwd(q, kg, vg, dout, o, carry,
                                                  0, p), 20)
    log(f"[timings] K4 backward, chain of {p} blocks (eager): kernel "
        f"{spread(r['ms'])}, plain {spread(r['plain_ms'])}, {SDPA_NAME} "
        f"backward {spread(r['library_ms'])}; kernel "
        f"{bwd['ms'] / bwd['library_ms']:.2f}x the library; the chain "
        f"replayed from a CUDA graph {replayed * 1e3:.2f} us; "
        f"{10 * hd * pairs / bwd['ms'] / 1e9:.1f} TFLOP/s, bound "
        f"{bwd['bound_ms'] * 1e3:.3f} us ({bwd['bound_by']})")
    out["partial_attention_bwd"] = bwd


def seq_launches(cfg):
    """Each kernel's launches per microbatch on one seq-rank, counted from
    the code: K4 p per layer forward and again in remat's recompute, its
    backward p per layer; K1 and K3 as on one card (phase 8); no K2."""
    L, p = cfg.n_layers, SEQ_P
    return {"partial_attention": 2 * p * L, "partial_attention_bwd": p * L,
            "block_matmul": 28 * L + 3, "rmsnorm": 8 * L + 1,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "paged_attention": 0, "paged_attention_combine": 0,
            "selective_scan": 0}


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(args, label, ranks, timeout, env=None):
    """``python args`` as ``ranks`` ranks sharing this card, each process
    given its rank, the world size and rank 0's address on localhost in
    the environment, as ``torch.distributed.run --standalone`` gives them
    (and one OpenMP thread a rank, as it sets), but started from here:
    the launcher's own import of torch would add seconds to every launch.
    Each rank runs in a session of its own; when one fails, or the time
    limit passes, every rank is stopped. Returns rank 0's output lines,
    each logged with the seconds since the launch began, its JSON reports
    and served ids left out of the log. ``env``: more environment."""
    import contextlib
    import tempfile
    import threading
    log(f"[{label}] {ranks} ranks: python {' '.join(args)}")
    base = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [x for x in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if x]),
        WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    base.setdefault("OMP_NUM_THREADS", "1")
    t0 = time.time()
    lines, procs = [], []

    def read(stream):
        for ln in stream:
            ln = ln.rstrip("\n")
            lines.append(ln)
            if ln.strip() and not ln.startswith(
                    ('{"serve"', '{"train"', "req ")):
                log(f"  | {time.time() - t0:6.1f}s {ln}")

    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        errs = [st.enter_context(open(Path(tmp) / f"rank{r}.err", "w+"))
                for r in range(ranks)]
        try:
            for r in range(ranks):
                procs.append(subprocess.Popen(
                    [sys.executable, *args], cwd=ROOT,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=subprocess.PIPE if r == 0 else errs[r],
                    stderr=errs[r], text=True, start_new_session=True))
            reader = threading.Thread(target=read, args=(procs[0].stdout,))
            reader.start()
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll()), None)
                if time.time() - t0 > timeout:
                    failed = "time"
                time.sleep(0.2)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.returncode), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        reader.join()
        if failed == "time":
            raise AssertionError(f"{label} ran past {timeout} s")
        if failed is not None:
            errs[failed].seek(0)
            log(errs[failed].read()[-6000:])
            raise AssertionError(f"{label}: rank {failed} exited with "
                                 f"{procs[failed].returncode}")
    log(f"  {time.time() - t0:.1f}s with start-up")
    return lines


def depth_cut(cfg, layers):
    """``cfg`` at full width and ``layers`` layers."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=layers)


def serve_worker(layers: int, argv) -> int:
    """One rank of ``serve.py`` with the flags ``argv`` at ``layers``
    layers (started by :func:`launch_serve`):
    ``serve.main`` given the cut model's config."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    serve.main(argv, cfg=depth_cut(cfg, layers))
    return 0


def launch_serve(flags, layers, label):
    """``serve.py`` with ``flags`` on MESH_RANKS ranks sharing this card,
    its model cut to ``layers`` layers: rank 0's output lines."""
    return launch_ranks([str(ROOT / "chip_smoke.py"), "--serve-worker",
                         str(layers), *flags], label, MESH_RANKS,
                        MESH_TIMEOUT_S)


def phase_seq_train(cfg, smi, losses_one_card):
    """``launch/train.py``'s run on a seq axis of 2 (``train.train_on`` in
    the mesh-train worker): two gloo ranks on this card, each holding the
    whole model (``cfg``, MESH_LAYERS layers) and half of every sequence,
    held to one card's losses of the same model; 13b's run follows in the
    launch."""
    from repro_torch.launch import train
    rep = run_mesh_train("seq", "seq train, then 13b's (seq ring)", SEQ_P,
                         then=("seq-overlap",))
    log(f"  losses {rep['losses']}, "
        f"one card {losses_one_card}")
    gap = max(abs(a - b) for a, b in zip(rep["losses"], losses_one_card))
    if not (len(rep["losses"]) == len(losses_one_card)
            and all(math.isfinite(x) for x in rep["losses"])
            and gap <= SEQ_LOSS_TOL):
        raise AssertionError(f"seq-parallel losses differ from one card's "
                             f"by {gap:.3e} (tol {SEQ_LOSS_TOL:g})")
    log(f"  max |loss - one card| {gap:.3e} (tol {SEQ_LOSS_TOL:g}) ok")
    hashes = {r["param_sha256"] for r in rep["ranks"]}
    if len(hashes) != 1 or None in hashes:
        raise AssertionError(f"the ranks' parameters differ: {hashes}")
    log(f"  parameters of both ranks bitwise equal (sha256 "
        f"{hashes.pop()[:16]}...)")
    args = train.build_parser().parse_args(SEQ_FLAGS)
    for r in rep["ranks"]:
        log(f"  rank {r['rank']} on {r['device']}:")
        check_launches(r["launches"], seq_launches(cfg),
                       args.steps * args.overdecompose, "microbatch")
    steady = rep["step_s"][1:] or rep["step_s"]
    step_s = sum(steady) / len(steady)
    for r in rep["ranks"]:
        for kind in sorted(r["comm_by_kind"][-1]):
            per_step = [c.get(kind, {"seconds": 0.0, "bytes": 0})
                        for c in r["comm_by_kind"]]
            log(f"  rank {r['rank']} {kind}: "
                f"{[round(c['seconds'], 4) for c in per_step]} s, "
                f"{[round(c['bytes'] / 1e9, 4) for c in per_step]} GB per "
                f"step")
        mem = r["max_memory_bytes"]
        log(f"  rank {r['rank']}: seq-axis comm "
            f"{[round(x, 4) for x in r['comm_s']]} s and "
            f"{[round(b / 1e9, 4) for b in r['comm_bytes']]} GB staged per "
            f"step, max_memory_allocated "
            f"{'-' if mem is None else f'{mem / 2**30:.2f} GiB'}")
    log(f"  rank 0 step times {[round(x, 4) for x in rep['step_s']]} s; "
        f"steady step {step_s:.4f} s, {rep['tokens_per_step'] / step_s:.1f} "
        f"tokens/s over both ranks on {smi}")
    return rep["ranks"][0]["launches"], rep


# ---------------------------------------------------------------------- #
# serving on the 4D mesh: four gloo ranks sharing the card
# ---------------------------------------------------------------------- #

def mesh_launches(cfg, prefills, decodes):
    """Each kernel's launches on one rank of the (1,2,2,1) mesh in
    ``prefills`` prefills and ``decodes`` decode steps (a paged serving
    step is a decode step: one forward, K5 in each layer), counted from
    the code: the forward of one card (``fixed_launches``), but each
    residual norm (two a layer and the final one) runs K3's stats and
    apply passes around the psum over x instead of its single pass;
    qk-norm's rows are whole, one pass each."""
    want = fixed_launches(cfg, prefills, decodes)
    fwd = prefills + decodes
    want["rmsnorm"] = fwd * (2 * cfg.mixers().count("attn")
                             if cfg.qk_norm else 0)
    want["rmsnorm_stats"] = want["rmsnorm_apply"] = fwd * (
        2 * cfg.n_layers + 1)
    return want


def mesh_collectives(cfg):
    """Collective calls of one forward on a rank of (1,2,2,1), counted from
    the code: per attention layer the psums over x of q, k and v, of the
    two norms' sums of squares and of the MLP's gate and up, and over y of
    the attention's and the MLP's down projections (9); per Mamba layer
    the psums over x of w_in, w_gate, the two norms' and the MLP's gate
    and up, and over y of w_x, w_out and the MLP's down projection (9);
    then the embedding's psum over y, the final norm's over x, the head's
    over x and the logits' gather over y."""
    return 9 * cfg.n_layers + 4


def teacher_forced(model, seqs, n_out, *, slots=8, chunk=32, page=16):
    """The logits of the last ``n_out`` positions of each sequence of
    ``seqs`` (N, L) int32, every sequence fed whole through the paged path
    (``Decoder.hidden`` in mode "paged", then the head), ``slots`` at a
    time in chunks of ``chunk`` rows. On a mesh each rank runs its batch
    shard and the logits are gathered. Returns (N, n_out, V) float32 on
    the CPU."""
    from repro_torch.core import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.models.decoder import lm_logits
    cfg, axes, dev = model.cfg, model.axes, model.embed.device
    N, L = seqs.shape
    per = -(-L // page)
    _, ct = ST.make_paged_step(cfg, axes)(
        axes.batch_shards * (1 + slots * per), page)
    table = (1 + torch.arange(slots)[:, None] * per
             + torch.arange(per)[None]).to(torch.int32)
    out = []
    with torch.inference_mode():
        for b in range(0, N, slots):
            pools = ST.zeros_caches(ct, dev)
            rows = []
            for c0 in range(0, L, chunk):
                cl = min(chunk, L - c0)
                tokens = torch.zeros((slots, chunk), dtype=torch.int32)
                tokens[:, :cl] = seqs[b:b + slots, c0:c0 + cl]
                pos = (c0 + torch.arange(chunk, dtype=torch.int32)
                       ).expand(slots, chunk).contiguous()
                q_len = torch.full((slots,), cl, dtype=torch.int32)
                t, p, q, tab = (M.batch_shard(v, axes).to(dev) for v in
                                (tokens, pos, q_len, table))
                h = model.hidden(t, mode="paged", positions=p, pools=pools,
                                 paged={"table": tab, "q_len": q})
                lo = max(L - n_out - c0, 0)
                if lo < cl:
                    rows.append(ST.gather_logits(
                        lm_logits(model, h[:, lo:cl]), axes).float().cpu())
            out.append(torch.cat(rows, 1))
    return torch.cat(out, 0)


def mesh_expectations(cfg):
    """What phases 11 and 13c hold their ranks to, from the one-card model
    of ``cfg`` (qwen3-1.7b at MESH_SERVE_LAYERS layers, drawn from the
    seed): each rank's parameter-shard hash (the blocks of every parameter
    by its PartitionSpec, hashed in parameter order, as
    ``steps.param_sha256`` hashes a rank's own), the sequences and ids of
    the continuous run of phase 5's flags on one card, and their
    teacher-forced logits at the generated positions."""
    import hashlib
    import numpy as np
    from repro_torch.core import mesh as M
    from repro_torch.core.partition import param_spec
    from repro_torch.launch import serve
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import mesh_axes
    t0 = time.time()
    model = ST.init_model(cfg, seed=SEED, device="cuda")
    args = serve.build_parser().parse_args(SERVE_FLAGS)
    engine, _, reqs, _, _ = serve_run(model, cfg, args)
    del engine
    if not all(r.state == "done" and len(r.generated) == r.max_new
               for r in reqs):
        raise AssertionError("a request of the one-card run did not "
                             "complete")
    generated = [r.generated for r in reqs]
    axes = mesh_axes(MESH)
    hashes = []
    for r in range(MESH_RANKS):
        h = hashlib.sha256()
        for n, p in model.named_parameters():
            h.update(M.shard(p.detach(), axes, param_spec(n), r).contiguous(
            ).cpu().view(torch.uint8).numpy())
        hashes.append(h.hexdigest())
    seqs = torch.from_numpy(np.stack([
        np.concatenate([r.prompt, np.asarray(g[:-1], np.int32)])
        for r, g in zip(reqs, generated)]))
    logits = teacher_forced(model, seqs, args.gen)
    # the fixed-batch run of MESH_FIXED_FLAGS on one card, and the top-2
    # margins of its positions (its sequences teacher-forced)
    fargs = serve.build_parser().parse_args(
        MESH_FIXED_FLAGS[:MESH_FIXED_FLAGS.index("--mesh")])
    fixed = serve.run_fixed(fargs, model)
    fseqs = torch.from_numpy(np.concatenate(
        [fixed.prompts, fixed.ids[:, :-1]], axis=1).astype(np.int32))
    flogits = teacher_forced(model, fseqs, fargs.gen, slots=fargs.batch)
    log(f"[mesh expectations] {cfg.name} at {cfg.n_layers} layers on one "
        f"card: {MESH_RANKS} ranks' shard hashes, the continuous run of "
        f"phase 5's flags and the teacher-forced logits "
        f"{tuple(logits.shape)} of its sequences, the fixed run's ids "
        f"{fixed.ids.shape} with its margins, in {time.time() - t0:.1f}s")
    return dict(hashes=hashes, seqs=seqs, ids=generated, logits=logits,
                n_out=args.gen, fixed_ids=fixed.ids.tolist(),
                fixed_margin=top2_margin(flogits))


def top2_margin(logits):
    """The gap between the top two logits of each position."""
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def check_ids(got_ids, base_ids, margin, thr, label):
    """The mesh's greedy ids against one card's: equal at every position
    whose one-card top-2 margin exceeds ``thr``; a sequence may part from
    one card's at a near tie, and is compared no further."""
    diverged = compared = 0
    if len(got_ids) != len(base_ids):
        raise AssertionError(f"{label}: {len(got_ids)} sequences, one card "
                             f"served {len(base_ids)}")
    for i, (got, base) in enumerate(zip(got_ids, base_ids)):
        if len(got) != len(base):
            raise AssertionError(f"{label} sequence {i}: {len(got)} ids, "
                                 f"one card served {len(base)}")
        for j, (a, b) in enumerate(zip(got, base)):
            compared += 1
            if a == b:
                continue
            if margin[i, j] > thr:
                raise AssertionError(
                    f"{label} sequence {i} position {j}: the mesh chose {a},"
                    f" one card {b}, at a top-2 margin of "
                    f"{float(margin[i, j]):.3e} > {thr:.3e}")
            diverged += 1     # a near tie: the rest of it may differ
            break
    log(f"  {label}: greedy ids == one card's at {compared - diverged} of "
        f"{compared} positions compared; {int((margin <= thr).sum())} of "
        f"{margin.numel()} positions have a top-2 margin <= {thr:.3e}; "
        f"{diverged} sequences part at such a position")


def mesh_worker(outdir: Path) -> int:
    """One rank of the teacher-forced runs on the mesh (started by
    ``phase_mesh_serve``): the model of
    ``mesh_expectations`` drawn from seed 0 on (1,2,2,1), its one-card
    run's sequences fed through it, blocking and overlapped; then 14a's
    Jamba at HYBRID_MESH_LAYERS layers, the prompts and ids of its
    one-card fixed run (``hybrid_mesh_expectations``) fed through its
    fixed-batch steps. Rank 0 saves the gathered logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import close_mesh, init_mesh, mesh_axes
    axes = mesh_axes(MESH)
    run = init_mesh(axes, device="cuda")
    try:
        model = ST.init_model(depth_cut(get_config(ARCH),
                                        MESH_SERVE_LAYERS), axes,
                              seed=SEED, device=run["device"])
        job = torch.load(outdir / "seqs.pt")
        logits = teacher_forced(model, job["seqs"], job["n_out"])
        if run["rank"] == 0:
            torch.save(logits, outdir / "mesh_logits.pt")
        del logits
        # 13c: the same under the overlapped schedule of serve.py --overlap
        from repro_torch.core.overlap import OverlapConfig
        from repro_torch.models.decoder import overlap_bound
        with overlap_bound(model, OverlapConfig.all_on()):
            logits = teacher_forced(model, job["seqs"], job["n_out"])
        if run["rank"] == 0:
            torch.save(logits, outdir / "overlap_logits.pt")
        del model, logits
        # 14a: Jamba's one-card fixed run fed through its fixed-batch steps
        model = ST.init_model(depth_cut(get_config(HYBRID),
                                        HYBRID_MESH_LAYERS), axes,
                              seed=SEED, device=run["device"])
        job = torch.load(HYBRID_MESH_DIR / "job.pt")
        logits = fixed_teacher_forced(model, job["prompts"], job["ids"])
        if run["rank"] == 0:
            torch.save(logits, HYBRID_MESH_DIR / "mesh_logits.pt")
    finally:
        close_mesh()
    return 0


def mesh_serve_hops(cfg):
    """Ring hops of one forward on a rank of (1,2,2,1) under ``--overlap``,
    counted from the code: z is 1, so each activation all-reduce over two
    ranks is the GEMM and one exchange: per layer the x all-reduces of q,
    k, v and the MLP's gate and up, the y all-reduces of the two
    transposed projections (7), and the tied head's over x. The norms'
    psums, the embedding's psum and the logits' gather stay blocking; the
    calls in all are ``mesh_collectives``'."""
    return 7 * cfg.n_layers + 1


def mesh_report(lines, expect, want, units, unit, cfg, smi, hops=0):
    """Checks of a mesh serving run's ``{"serve": ...}`` line: each rank's
    shard hash against the one-card model's blocks, the same plans on
    every rank, each kernel's launches (``want`` per ``unit``) and the
    collective calls (``mesh_collectives`` per forward; a unit is a
    forward, or the run of ``--gen`` forwards) and, apart, the engine's
    broadcasts of rank 0's clock; then the timings. Returns the report."""
    rep = json.loads([ln for ln in lines
                      if ln.startswith('{"serve"')][-1])["serve"]
    ranks = sorted(rep["ranks"], key=lambda r: r["rank"])
    got = [r["param_sha256"] for r in ranks]
    if "hashes" not in expect:
        # Jamba's shards are not hashed on one card here;
        # tests/test_torch_mesh_hybrid.py checks the shards are slices
        if len(set(got)) != len(got):
            raise AssertionError(f"two ranks hold the same shards: {got}")
        log(f"  {len(got)} distinct parameter shards (sha256 "
            f"{', '.join(h[:12] for h in got)})")
    elif got != expect["hashes"]:
        raise AssertionError(f"the ranks' parameter shards are not the "
                             f"one-card model's blocks: {got} against "
                             f"{expect['hashes']}")
    else:
        log(f"  every rank's parameter shards == the one-card model's "
            f"blocks (sha256 {', '.join(h[:12] for h in got)})")
    plans = {r["plan_sha256"] for r in ranks}
    if len(plans) != 1:
        raise AssertionError(f"the ranks ran different plans: {plans}")
    log(f"  the same plans on every rank (sha256 {plans.pop()[:16]}...)")
    n, forwards = units(ranks[0])
    calls = mesh_collectives(cfg) * forwards // n
    for r in ranks:
        log(f"  rank {r['rank']} on {r['device']}:")
        check_launches(r["launches"], want, n, unit)
        fwd = [v for k, v in r["comm"].items() if k != "broadcast"]
        c = sum(v["calls"] for v in fwd)
        clock = r["comm"].get("broadcast", {"calls": 0, "seconds": 0.0})
        log(f"    collectives: {c} calls = {c / n:g} per {unit} (expected "
            f"{calls}), {sum(v['seconds'] for v in fwd) / n:.4f} s and "
            f"{sum(v['bytes'] for v in fwd) / n / 1e6:.3f} MB staged per "
            f"{unit}; the engine's clock broadcast {clock['calls']} calls, "
            f"{clock['seconds']:.4f} s; by axis "
            + ", ".join(f"{a} {v['calls']} calls {v['seconds']:.3f} s "
                        f"{v['bytes'] / 1e6:.2f} MB"
                        for a, v in sorted(r["comm_axes"].items()))
            + "; max_memory_allocated " + (
                "-" if r["max_memory_bytes"] is None
                else f"{r['max_memory_bytes'] / 2**30:.2f} GiB"))
        if c != calls * n:
            raise AssertionError(f"rank {r['rank']}: {c} collective calls, "
                                 f"expected {calls} per {unit}")
        got = r["comm"].get("ppermute", {"calls": 0})["calls"]
        want_hops = hops * forwards
        if got != want_hops:
            raise AssertionError(f"rank {r['rank']}: {got} ring hops, "
                                 f"expected {want_hops}")
        if hops:
            log(f"    of them ring hops: {got} = {hops} per forward, as the "
                f"code counts")
        # the engine reads rank 0's clock once an iteration of its loop,
        # and a step is one iteration; the fixed run reads no clock
        if not (clock["calls"] >= n if unit == "step"
                else clock["calls"] == 0):
            raise AssertionError(f"rank {r['rank']}: {clock['calls']} clock "
                                 f"broadcasts in {n} {unit}s")
    log(f"  tokens/s {rep['tokens_per_s']:.1f}, ttft p50/p99 "
        f"{rep['ttft_p50_ms']:.1f}/{rep['ttft_p99_ms']:.1f} ms, latency "
        f"p50/p99 {rep['latency_p50_ms']:.1f}/{rep['latency_p99_ms']:.1f} ms"
        f", {n} {unit}s, on {smi}")
    return rep


def phase_mesh_serve(cfg, smi, expect, hybrid_expect):
    """``serve.py`` on the (1,2,2,1) mesh of ``cfg`` (MESH_SERVE_LAYERS
    layers), four gloo ranks on this card: the teacher-forced logits of
    the one-card run's sequences against one card's, then the continuous
    run of phase 5's flags (its greedy ids held to one card's above the
    margin) and a fixed-batch run. 14a's teacher-forced run of
    ``hybrid_expect``'s job follows in the first launch."""
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(dict(seqs=expect["seqs"], n_out=expect["n_out"]),
               MESH_DIR / "seqs.pt")
    HYBRID_MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(dict(prompts=hybrid_expect["prompts"],
                    ids=hybrid_expect["ids"]), HYBRID_MESH_DIR / "job.pt")
    launch_ranks([str(ROOT / "chip_smoke.py"), "--mesh-worker",
                  str(MESH_DIR)], "mesh teacher-forced, then 14a's",
                 MESH_RANKS, MESH_TIMEOUT_S)
    mesh = torch.load(MESH_DIR / "mesh_logits.pt")
    one = expect["logits"]
    err, scale = max_err(mesh, one), float(one.abs().max())
    log(f"  teacher-forced logits {tuple(mesh.shape)}: max|mesh - one "
        f"card| = {err:.3e}, max|logit| = {scale:.3e}, {err / scale:.3e} of"
        f" it (tol {MESH_TF_TOL:g}); TF32 off")
    if not (math.isfinite(err) and err <= MESH_TF_TOL * scale):
        raise AssertionError("the mesh's logits differ from one card's")
    margin = top2_margin(one)
    thr = MESH_MARGIN * err
    del mesh, one

    lines = launch_serve(MESH_SERVE_FLAGS, cfg.n_layers, "mesh serve")
    rep = mesh_report(lines, expect, mesh_launches(cfg, 0, 1),
                      lambda r: (r["n_steps"], r["n_steps"]), "step", cfg,
                      smi)
    check_ids(rep["ids"], expect["ids"], margin, thr,
              f"continuous, against one card's (margin {MESH_MARGIN} x "
              f"{err:.3e})")

    lines = launch_serve(MESH_FIXED_FLAGS, cfg.n_layers, "mesh fixed serve")
    gen = int(MESH_FIXED_FLAGS[MESH_FIXED_FLAGS.index("--gen") + 1])
    fixed = mesh_report(lines, expect, mesh_launches(cfg, 1, gen - 1),
                        lambda r: (1, gen), "run", cfg, smi)
    check_ids(fixed["ids"], expect["fixed_ids"], expect["fixed_margin"], thr,
              "fixed, against the one-card fixed run")
    log(f"  fixed: prefill {fixed['prefill_s']:.4f} s, decode "
        f"{fixed['decode_s']:.4f} s for {gen - 1} steps "
        f"({1e3 * fixed['decode_s'] / (gen - 1):.2f} ms/step)")
    return (sorted(rep["ranks"], key=lambda r: r["rank"])[0]["launches"],
            dict(fixed=fixed, thr=thr, tf_err=err))


def phase_overlap_serve(cfg, smi, expect, blocking):
    """13c: ``serve.py --mesh 1,2,2,1 --overlap`` in fixed mode with phase
    11's flags, four gloo ranks on this card. The teacher-forced logits
    under the overlapped schedule (taken by phase 11's worker) within
    OVERLAP_TF_TOL of max|logit| of one card's, every greedy id equal to
    the blocking mesh run's (``blocking``, phase 11's) and held to one
    card's as phase 11 holds them; launches, collective calls and ring
    hops the code's count; the two schedules' times side by side."""
    mesh = torch.load(MESH_DIR / "overlap_logits.pt")
    block = torch.load(MESH_DIR / "mesh_logits.pt")
    one = expect["logits"]
    err, scale = max_err(mesh, one), float(one.abs().max())
    log(f"[overlap serve] teacher-forced logits under the overlapped "
        f"schedule: max|mesh - one card| = {err:.3e}, {err / scale:.3e} of "
        f"max|logit| (tol {OVERLAP_TF_TOL:g}); bitwise the blocking mesh's: "
        f"{torch.equal(mesh, block)}")
    if not (math.isfinite(err) and err <= OVERLAP_TF_TOL * scale):
        raise AssertionError("the overlapped mesh's logits differ from one "
                             "card's")
    del mesh, block
    flags = MESH_FIXED_FLAGS + ["--overlap"]
    lines = launch_serve(flags, cfg.n_layers, "overlap fixed serve")
    gen = int(flags[flags.index("--gen") + 1])
    rep = mesh_report(lines, expect, mesh_launches(cfg, 1, gen - 1),
                      lambda r: (1, gen), "run", cfg, smi,
                      hops=mesh_serve_hops(cfg))
    if rep["ids"] != blocking["fixed"]["ids"]:
        raise AssertionError("the overlapped fixed run's ids differ from the "
                             "blocking mesh run's")
    check_ids(rep["ids"], expect["fixed_ids"], expect["fixed_margin"],
              blocking["thr"], "overlapped fixed, against the one-card fixed "
              "run")
    log("  greedy ids == the blocking mesh run's at every position")
    for key, r in (("blocking", blocking["fixed"]), ("overlapped", rep)):
        comm = [sum(v["seconds"] for k, v in x["comm"].items()
                    if k != "broadcast")
                for x in sorted(r["ranks"], key=lambda x: x["rank"])]
        log(f"  {key}: prefill {r['prefill_s']:.4f} s, decode "
            f"{r['decode_s']:.4f} s for {gen - 1} steps; comm per rank "
            f"{[round(c, 3) for c in comm]} s, on {smi}")


# ---------------------------------------------------------------------- #
# training on the 4D mesh: eight gloo ranks sharing the card
# ---------------------------------------------------------------------- #

def mesh_train_launches(cfg):
    """Each kernel's launches per microbatch on one rank of a mesh with x
    above 1, counted from the code: K1 and K2 as on one card (phase 8);
    each residual norm (two a layer, forward and remat's recompute, and
    the final one) runs K3's stats and apply passes around the psum over
    x, qk-norm's whole rows one pass each (q and k, forward and
    recompute)."""
    L = cfg.n_layers
    return {"block_matmul": 28 * L + 3, "flash_attention": 2 * L,
            "flash_attention_bwd": L, "rmsnorm": 4 * L,
            "rmsnorm_stats": 4 * L + 1, "rmsnorm_apply": 4 * L + 1,
            "paged_attention": 0, "paged_attention_combine": 0,
            "selective_scan": 0, "partial_attention": 0,
            "partial_attention_bwd": 0}


def mesh_train_collectives(cfg, axes, microbatches):
    """Collective calls of one train step on a rank, by axis (the keys of
    ``core.mesh.COMM_AXES``), counted from the code for a dense decoder
    with qk-norm whose KV heads split over y. A microbatch: per layer, the
    forward (again in remat's recompute) gathers its 7 weights over z,
    psums q, k, v, the MLP's gate and up (its "normal" layers) and the two
    norms' sums of squares over x and the two "transposed" outputs over
    y; the backward re-gathers the 7 weights over z and reduce-scatters
    their gradients there, psums dX over the output axis (y for the 5
    normal layers, x for the 2 transposed) and each norm's two sums over
    x. Outside the layers: the embedding's gather over z and psum over y,
    the final norm's psum over x, the tied head's gather over z and psum
    over x, the loss's pmax and two psums over y and its two means over
    the token axes; backward, the head's re-gather and reduce-scatter
    over z and its dh over y, the final norm's two psums over x, the
    embedding's reduce-scatter over z. Then the step: each of the 11 L + 2
    gradients psum'd over (data, seq), q_norm and k_norm over y, the
    gains (4 L + 1, the qk-norm ones among them) over z, and the gradient
    norm's psum of each set of axes a spec shards over (x, y, z and x
    alone; the replicated gains need none). A size-1 axis costs no
    call. Without qk-norm, 2 L leaves fewer: none over y, 2 L + 1 gains
    over z."""
    L, qk = cfg.n_layers, int(cfg.qk_norm)
    live = {a: axes.size(a) > 1 for a in ("data", "x", "y", "z", "seq")}
    per_mb = {"z": 28 * L + 5, "x": 20 * L + 4, "y": 9 * L + 5,
              "data+z+seq": 2}
    per_mb["data+z+seq"] *= live["data"] or live["z"] or live["seq"]
    want = {k: v * microbatches for k, v in per_mb.items()
            if all(live[a] for a in k.split("+")) or k == "data+z+seq"}
    sync = {"data+seq": ((9 + 2 * qk) * L + 2)
            * (live["data"] or live["seq"]),
            "y": 2 * L * qk * live["y"], "z": ((2 + 2 * qk) * L + 1)
            * live["z"],
            "x+y+z": int(live["x"] or live["y"] or live["z"]),
            "x": int(live["x"])}
    for k, v in sync.items():
        want[k] = want.get(k, 0) + v
    return {k: v for k, v in want.items() if v}


def ar_ring_hops(p, chunks=1, fed=False):
    """Hops of one activation all-reduce over p ranks under
    ``overlap.all_reduce`` (the reduced dim splits over p): none over one
    rank, one exchange at p == 2, else a reduce-scatter ring of p - 1 hops
    (per sub-ring where the GEMM feeds it, ``fed``) and an all-gather ring
    of p - 1."""
    if p == 1:
        return 0
    if p == 2:
        return 1
    return (p - 1) * (chunks if fed else 1) + (p - 1)


def mesh_train_hops(cfg, axes, microbatches, *, z_chunks=1, ar_chunks=1):
    """(ring hops, blocking calls) of one train step on a rank under
    ``OverlapConfig.all_on(z_chunks, ar_chunks)``, each by axis, counted
    from the code for the decoder of ``mesh_train_collectives`` (the
    blocks' widths split over every ring). Each tp matmul (5 "normal" and
    2 "transposed" a layer, forward twice with remat's recompute; the tied
    head, forward once, counts as a normal one): with z above 1, a z ring
    of (g_z - 1) z_chunks hops in the forward, two in the backward (dX's
    accumulate ring, dW's reduce-scatter ring), and the activation
    all-reduces as rings (forward over the contraction axis, dX over the
    output axis); with z of 1 the GEMM feeds the all-reduce rings. The
    embedding's table is gathered by one z ring of g_z - 1 hops; its
    gradient's reduce-scatter stays blocking. On a seq axis of p, each
    layer's K and V take p - 1 hops each in the forward and in the
    recompute, and their gradients p - 1 each back. Every ring site takes
    the place of one blocking call of ``mesh_train_collectives``; the
    norms' and the softmax's psums, the loss's means and the step's
    reductions stay blocking."""
    L, gz = cfg.n_layers, axes.gz
    hops = dict.fromkeys(("x", "y", "z", "seq"), 0)
    sites = dict.fromkeys(("x", "y", "z"), 0)

    def matmul(in_ax, out_ax, fwd):
        z_ring = (gz - 1) * z_chunks
        if gz > 1:
            hops["z"] += (fwd + 2) * z_ring
            hops[in_ax] += fwd * ar_ring_hops(axes.size(in_ax))
            hops[out_ax] += ar_ring_hops(axes.size(out_ax))
        else:
            hops[in_ax] += fwd * ar_ring_hops(axes.size(in_ax), ar_chunks,
                                              fed=True)
            hops[out_ax] += ar_ring_hops(axes.size(out_ax), ar_chunks,
                                         fed=True)
        sites["z"] += fwd + 2
        sites[in_ax] += fwd
        sites[out_ax] += 1
    for _ in range(L):
        for _ in range(5):
            matmul("x", "y", 2)
        for _ in range(2):
            matmul("y", "x", 2)
    matmul("x", "y", 1)                  # the tied head
    hops["z"] += gz - 1                  # the embedding's table
    sites["z"] += 1
    hops["seq"] += 6 * (axes.gseq - 1) * L
    blocking = mesh_train_collectives(cfg, axes, microbatches)
    for a, n in sites.items():
        if a in blocking:
            blocking[a] -= n * microbatches
    return ({a: n * microbatches for a, n in hops.items() if n},
            {a: n for a, n in blocking.items() if n})


def check_mesh_losses(rep, one, label, t=MESH_TRAIN_TOL):
    """Step 1's loss and grad norm within ``t`` (relative) of the one-card
    run's, the later losses within its absolute bound."""
    d_loss = abs(rep["losses"][0] - one.losses[0]) / abs(one.losses[0])
    d_gn = abs(rep["grad_norms"][0] - one.grad_norms[0]) / one.grad_norms[0]
    later = max((abs(a - b) for a, b in zip(rep["losses"][1:],
                                            one.losses[1:])), default=0.0)
    log(f"  {label}: losses {rep['losses']}, grad norms {rep['grad_norms']};"
        f" one card {one.losses}, {one.grad_norms}")
    log(f"  step 1 |dloss|/loss {d_loss:.3e} (tol {t['loss']:g}), "
        f"|dnorm|/norm {d_gn:.3e} (tol {t['grad_norm']:g}); later steps "
        f"max|dloss| {later:.3e} (tol {t['later_loss']:g})")
    if not (len(rep["losses"]) == len(one.losses)
            and all(math.isfinite(x) for x in rep["losses"]
                    + rep["grad_norms"])
            and d_loss <= t["loss"] and d_gn <= t["grad_norm"]
            and later <= t["later_loss"]):
        raise AssertionError(f"{label}: the mesh's training differs from "
                             f"one card's")


def phase_mesh_train(cfg, smi, one):
    """12a: train.py's run on (1,2,2,2), eight gloo ranks on this card,
    with phase 8's flags at full width and MESH_LAYERS layers (``cfg``),
    held to one card's run ``one`` of the same model."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import mesh_axes
    # 13a's run follows in the same launch
    rep = run_mesh_train("mesh", f"mesh train, then 13a's ({MESH_TRAIN}, "
                         f"{MESH_LAYERS} layers)", MESH_TRAIN_RANKS,
                         then=("mesh-overlap", "mesh-overlap-profile"))
    check_mesh_losses(rep, one, "(1,2,2,2) against one card")
    args = train.build_parser().parse_args(MESH_TRAIN_FLAGS)
    want = mesh_train_collectives(cfg, mesh_axes(MESH_TRAIN),
                                  args.overdecompose)
    share = torch.cuda.get_device_properties(0).total_memory \
        / MESH_TRAIN_RANKS
    ranks = sorted(rep["ranks"], key=lambda r: r["rank"])
    for r in ranks:
        log(f"  rank {r['rank']} on {r['device']}:")
        check_launches(r["launches"], mesh_train_launches(cfg),
                       args.steps * args.overdecompose, "microbatch")
        for i, by_axis in enumerate(r["comm_by_axis"]):
            got = {a: c["calls"] for a, c in by_axis.items()}
            if got != want:
                raise AssertionError(f"rank {r['rank']} step {i}: collective"
                                     f" calls {got}, expected {want}")
        last = r["comm_by_axis"][-1]
        log(f"    collectives per step == the code's {sum(want.values())} "
            f"({want}); last step by axis: "
            + ", ".join(f"{a} {c['seconds']:.3f} s {c['bytes'] / 1e9:.3f} GB"
                        for a, c in sorted(last.items()))
            + f"; in all {[round(x, 3) for x in r['comm_s']]} s, "
            f"{[round(b / 1e9, 3) for b in r['comm_bytes']]} GB per step")
        mem = r["max_memory_bytes"]
        log(f"    max_memory_allocated {mem / 2**30:.2f} GiB (its share of "
            f"the card {share / 2**30:.2f} GiB)")
        if mem > share:
            raise AssertionError(f"rank {r['rank']} took {mem} bytes, more "
                                 f"than its share {share:.0f}")
    steady = rep["step_s"][1:] or rep["step_s"]
    step_s = sum(steady) / len(steady)
    log(f"  rank 0 step times {[round(x, 3) for x in rep['step_s']]} s; "
        f"steady step {step_s:.3f} s, {rep['tokens_per_step'] / step_s:.1f} "
        f"tokens/s over the 8 ranks, {rep['n_params'] / 1e9:.3f} B "
        f"parameters, on {smi}")
    return ranks[0]["launches"], rep


def overlap_train_launches(cfg, axes):
    """``mesh_train_launches`` under ``OverlapConfig.all_on()``: every K1
    product of a tp matmul and of the tied head runs once per z block (g_z
    GEMMs a ring, one per hop and one on the rank's own block)."""
    want = mesh_train_launches(cfg)
    want["block_matmul"] *= axes.gz
    return want


def check_step_calls(rep, hops, blocking):
    """Every rank's ring hops and blocking calls of every step, by axis,
    against the code's count."""
    for r in rep["ranks"]:
        for i, (by_axis, by_hop) in enumerate(zip(r["comm_by_axis"],
                                                  r["hops_by_axis"])):
            got_hops = {a: c["calls"] for a, c in by_hop.items()}
            rest = {a: c["calls"] - by_hop.get(a, {"calls": 0})["calls"]
                    for a, c in by_axis.items()}
            rest = {a: n for a, n in rest.items() if n}
            if got_hops != hops or rest != blocking:
                raise AssertionError(
                    f"rank {r['rank']} step {i}: hops {got_hops}, blocking "
                    f"{rest}; the code counts {hops} and {blocking}")
    log(f"  every rank, every step: ring hops {hops} and blocking calls "
        f"{blocking} by axis, as the code counts")


def compare_schedules(label, runs, smi):
    """The blocking and overlapped runs side by side: rank 0's steady step
    time, each rank's exposed comm seconds (the host's time blocked in
    collectives and hops) and staged bytes per steady step, and rank 0's
    last step by axis."""
    log(f"  {label}, on {smi}:")
    for key, rep in runs:
        steady = rep["step_s"][1:] or rep["step_s"]
        ranks = sorted(rep["ranks"], key=lambda r: r["rank"])
        n = len(steady)
        comm = [sum(r["comm_s"][1:] or r["comm_s"]) / n for r in ranks]
        gb = [sum(r["comm_bytes"][1:] or r["comm_bytes"]) / n / 1e9
              for r in ranks]
        last = ranks[0]["comm_by_axis"][-1]
        log(f"    {key}: step {sum(steady) / n:.3f} s (times "
            f"{[round(x, 3) for x in rep['step_s']]}); exposed comm per rank "
            f"{[round(x, 3) for x in comm]} s, mean "
            f"{sum(comm) / len(comm):.3f} s; staged {[round(x, 3) for x in gb]} GB; rank 0 by axis "
            + ", ".join(f"{a} {c['calls']} calls {c['seconds']:.3f} s "
                        f"{c['bytes'] / 1e9:.3f} GB"
                        for a, c in sorted(last.items())))


def phase_overlap_train(cfg, smi, one, blocking):
    """13a: 12a's run (MESH_LAYERS layers, ``cfg``) with
    ``OverlapConfig.all_on()``, held to one card's run ``one`` of the same
    model within OVERLAP_TRAIN_TOL; launches, hops and blocking calls the
    code's; side by side with 12a (``blocking``)."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import mesh_axes
    log(f"[overlap train ({MESH_TRAIN}, {MESH_LAYERS} layers)] the run after "
        f"12a's, in its launch")
    rep = mesh_train_report("mesh-overlap")
    check_mesh_losses(rep, one, "overlapped (1,2,2,2) against one card",
                      OVERLAP_TRAIN_TOL)
    args = train.build_parser().parse_args(MESH_TRAIN_FLAGS)
    axes = mesh_axes(MESH_TRAIN)
    share = torch.cuda.get_device_properties(0).total_memory \
        / MESH_TRAIN_RANKS
    for r in sorted(rep["ranks"], key=lambda r: r["rank"]):
        log(f"  rank {r['rank']} on {r['device']}:")
        check_launches(r["launches"], overlap_train_launches(cfg, axes),
                       args.steps * args.overdecompose, "microbatch")
        mem = r["max_memory_bytes"]
        log(f"    max_memory_allocated {mem / 2**30:.2f} GiB (its share "
            f"{share / 2**30:.2f} GiB)")
        if mem > share:
            raise AssertionError(f"rank {r['rank']} took {mem} bytes, more "
                                 f"than its share {share:.0f}")
    check_step_calls(rep, *mesh_train_hops(cfg, axes, args.overdecompose))
    hashes = {r["param_sha256"] for r in rep["ranks"]}
    if len(hashes) != MESH_TRAIN_RANKS:
        raise AssertionError(f"(1,2,2,2) has no replicas, yet ranks share "
                             f"parameter bits: {hashes}")
    log(f"  {len(hashes)} distinct blocks, one a rank (no replicas on "
        f"{MESH_TRAIN})")
    compare_schedules(f"{MESH_TRAIN}, 12a against 13a",
                      (("blocking (12a)", blocking), ("overlapped (13a)",
                                                      rep)), smi)
    return sorted(rep["ranks"], key=lambda r: r["rank"])[0]["launches"]


def phase_overlap_seq(cfg, smi, one, blocking):
    """13b: phase 10's run with the seq ring (``OverlapConfig(
    ring_attention=True)``), two gloo ranks on this card (after phase 10
    in its launch): losses within SEQ_LOSS_TOL of one card's run ``one``
    of the same model and of phase 10's (``blocking``), both ranks'
    parameters bitwise equal, K4 forward and backward launches per hop the
    code's, the seq hops and blocking calls the code's, and the exposed
    seq seconds beside phase 10's."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import mesh_axes
    rep = mesh_train_report("seq-overlap")
    for ref, losses in (("one card", one.losses),
                        ("phase 10", blocking["losses"])):
        gap = max(abs(a - b) for a, b in zip(rep["losses"], losses))
        log(f"  losses {rep['losses']} against {ref}'s {losses}: max "
            f"|dloss| {gap:.3e} (tol {SEQ_LOSS_TOL:g})")
        if not (len(rep["losses"]) == len(losses)
                and all(math.isfinite(x) for x in rep["losses"])
                and gap <= SEQ_LOSS_TOL):
            raise AssertionError(f"the seq ring's losses differ from {ref}'s")
    hashes = {r["param_sha256"] for r in rep["ranks"]}
    if len(hashes) != 1:
        raise AssertionError(f"the seq ranks' parameters differ: {hashes}")
    log("  parameters of both ranks bitwise equal")
    args = train.build_parser().parse_args(SEQ_FLAGS)
    for r in sorted(rep["ranks"], key=lambda r: r["rank"]):
        log(f"  rank {r['rank']} on {r['device']}:")
        check_launches(r["launches"], seq_launches(cfg),
                       args.steps * args.overdecompose, "microbatch")
        seq = [h.get("seq", {"seconds": 0.0})["seconds"]
               for h in r["hops_by_axis"]]
        log(f"    seq hops' exposed seconds per step "
            f"{[round(x, 4) for x in seq]}")
    axes = mesh_axes(SEQ_FLAGS[SEQ_FLAGS.index("--mesh") + 1])
    check_step_calls(rep, *mesh_train_hops(cfg, axes, args.overdecompose))
    compare_schedules("seq (1,1,1,1,2), phase 10 against 13b",
                      (("blocking (10)", blocking), ("seq ring (13b)", rep)),
                      smi)
    return sorted(rep["ranks"], key=lambda r: r["rank"])[0]["launches"]


def cut_config(cfg):
    return depth_cut(cfg, MESH_LAYERS)


def mesh_train_worker(outdir: Path, which: str) -> int:
    """One rank of training runs on a mesh (started by ``run_mesh_train``
    through ``launch_ranks``): ``train.train_on`` with the flags, depth
    and schedule of each run of ``which`` ("mesh": 12a, "data": 12b,
    "mesh-overlap": 13a, "mesh-overlap-profile": 18, "seq-overlap": 13b,
    "zero": 15a, "ckpt-a": 15b's
    run A, which checkpoints into ``outdir``, "zero3": 16a,
    "zero3-prefetch": 16b, "zero3-ckpt-a" and "zero3-ckpt-b": 16c's runs A
    and B, through ``outdir``'s "zero3.npz"; several runs on one mesh
    joined by "+", one after the other on the mesh set up once, each
    run's memory freed before the next); rank 0 saves each run's
    report."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.overlap import OverlapConfig
    from repro_torch.launch import train
    from repro_torch.launch.mesh import close_mesh, init_mesh, mesh_axes
    blocking = OverlapConfig()
    runs = {
        "mesh": (MESH_TRAIN_FLAGS + calib_flags(outdir, "mesh"),
                 MESH_LAYERS, blocking, None),
        "data": (MESH_DATA_FLAGS, MESH_LAYERS, blocking, None),
        "mesh-overlap": (MESH_TRAIN_FLAGS, MESH_LAYERS,
                         OverlapConfig.all_on(), None),
        "mesh-overlap-profile": (MESH_TRAIN_FLAGS + ["--profile-steps",
                                                     PROFILE_STEPS],
                                 MESH_LAYERS, OverlapConfig.all_on(), None),
        "seq": (SEQ_FLAGS, MESH_LAYERS, blocking, None),
        "seq-overlap": (SEQ_FLAGS, MESH_LAYERS,
                        OverlapConfig(ring_attention=True), None),
        "zero": (ZERO_FLAGS, MESH_LAYERS, blocking, None),
        "ckpt-a": (CKPT_FLAGS + ["--mesh", CKPT_A_MESH, "--backend", "gloo",
                                 "--zero", "--ckpt",
                                 str(outdir / "ckpt.npz")], None, blocking,
                   CKPT_A_STEPS),
        "zero3": (ZERO3_FLAGS + calib_flags(outdir, "zero3"), None, blocking,
                  None),
        "zero3-prefetch": (ZERO3_PREFETCH_FLAGS, None, blocking, None),
        "zero3-ckpt-a": (with_flag(CKPT_FLAGS, "--overdecompose", 1) + [
            "--mesh", ZERO3_CKPT_A_MESH, "--backend", "gloo", "--zero3",
            "--ckpt", str(outdir / "zero3.npz")], None, blocking,
            CKPT_A_STEPS),
        "zero3-ckpt-b": (CKPT_FLAGS + [
            "--mesh", ZERO3_CKPT_B_MESH, "--backend", "gloo", "--zero",
            "--ckpt", str(outdir / "zero3.npz"), "--resume"], None,
            blocking, None)}
    names = which.split("+")
    parser = train.build_parser()
    first = parser.parse_args(runs[names[0]][0])
    axes = mesh_axes(first.mesh)
    run = init_mesh(axes, backend=first.backend, device=first.device)
    try:
        for name in names:
            flags, layers, ov, stop = runs[name]
            args = parser.parse_args(flags)
            if args.mesh != first.mesh:
                raise ValueError(f"{which}: one mesh for all runs")
            cfg = (dataclasses.replace(get_config(ARCH), n_layers=layers)
                   if layers else preset_cfg(args))
            res = train.train_on(args, axes, cfg, run, ov, stop)
            if run["rank"] == 0:
                (outdir / f"{name}.json").write_text(json.dumps(dict(
                    losses=res.losses, grad_norms=res.grad_norms,
                    step_s=res.step_s, tokens_per_step=res.tokens_per_step,
                    n_params=res.n_params, ckpt=res.ckpt,
                    first_step=res.first_step, predicted=res.predicted,
                    profile=res.profile,
                    ranks=res.ranks)))
            del res
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        close_mesh()
    return 0


def preset_cfg(args):
    """The model of ``--arch`` and ``--preset``, as ``train.main`` builds
    it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    return train.preset_config(get_config(args.arch), args.preset)


def run_mesh_train(which, label, ranks, outdir=MESH_TRAIN_DIR, env=None,
                   then=()):
    """``mesh_train_worker``'s run ``which`` on ``ranks`` ranks sharing
    this card, and after it in the same launch the runs ``then`` (read
    later with :func:`mesh_train_report`); ``which``'s report. This
    process's cached memory is freed first."""
    free_memory()
    outdir.mkdir(parents=True, exist_ok=True)
    launch_ranks([str(ROOT / "chip_smoke.py"), "--mesh-train-worker",
                  str(outdir), "+".join((which, *then))], label, ranks,
                 MESH_TRAIN_TIMEOUT_S, env=env)
    return mesh_train_report(which, outdir)


def mesh_train_report(which, outdir=MESH_TRAIN_DIR):
    """The report of the run ``which`` of an earlier launch."""
    return json.loads((outdir / f"{which}.json").read_text())


def phase_mesh_data(cfg, smi, one):
    """12b: the data axis beside x and y, (2,2,2,1) at full width and
    MESH_LAYERS layers (``cfg``), eight gloo ranks on this card: the data
    replicas of every block end bitwise equal, and the run matches one
    card's run ``one`` of the same model."""
    from repro_torch.launch.mesh import mesh_axes
    # 15a's run follows in the same launch; eight ranks' caching
    # allocators share the card: segments that grow in place keep each
    # one's reserve near its allocation
    rep = run_mesh_train("data", f"mesh train data ({MESH_DATA}, "
                         f"{MESH_LAYERS} layers), then 15a's --zero",
                         MESH_TRAIN_RANKS, then=("zero",),
                         env={"PYTORCH_CUDA_ALLOC_CONF":
                              "expandable_segments:True"})
    check_mesh_losses(rep, one, f"({MESH_DATA}) against one card")
    axes = mesh_axes(MESH_DATA)
    blocks = {}
    for r in rep["ranks"]:
        blocks.setdefault(axes.coords(r["rank"])[1:], set()).add(
            r["param_sha256"])
    if not (all(len(h) == 1 for h in blocks.values())
            and len(blocks) == MESH_TRAIN_RANKS // axes.dp):
        raise AssertionError(f"the data replicas differ: {blocks}")
    log(f"  the {axes.dp} data replicas of each of the {len(blocks)} blocks "
        f"bitwise equal after {len(rep['losses'])} steps")
    for r in sorted(rep["ranks"], key=lambda r: r["rank"]):
        by_axis = r["comm_by_axis"][-1]
        log(f"  rank {r['rank']}: last step by axis "
            + ", ".join(f"{a} {c['calls']} calls {c['seconds']:.3f} s "
                        f"{c['bytes'] / 1e9:.3f} GB"
                        for a, c in sorted(by_axis.items()))
            + f"; max_memory_allocated "
            f"{r['max_memory_bytes'] / 2**30:.2f} GiB on {smi}")


# ---------------------------------------------------------------------- #
# phase 14: Jamba on the 4D mesh, and long-context seq-sharded decode
# ---------------------------------------------------------------------- #

def fixed_teacher_forced(model, prompts, ids):
    """Fixed-batch serving's logits at each position a greedy run of
    ``ids`` (B, gen) chose its id: the prompts (B, T) prefilled, then
    ids[:, j] fed at T + j for j < gen - 1. On a mesh each rank runs its
    batch shard and the logits are gathered. Returns (B, gen, V) float32
    on the CPU."""
    from repro_torch.launch import steps as ST
    cfg, axes, dev = model.cfg, model.axes, model.embed.device
    B, T = prompts.shape
    gen = ids.shape[1]
    pre, ct = ST.make_prefill_step(cfg, axes)(B, T, T + gen)
    dec, _ = ST.make_decode_step(cfg, axes)(B, T + gen)
    caches = ST.zeros_caches(ct, dev)
    logits, caches = pre(model, caches, prompts.to(dev))
    out = [ST.gather_logits(logits, axes).float().cpu()]
    for j in range(gen - 1):
        logits, caches = dec(model, caches, ids[:, j:j + 1].to(dev), T + j)
        out.append(ST.gather_logits(logits, axes).float().cpu())
    return torch.cat(out, 1)


def hybrid_mesh_expectations(cfg):
    """What 14a holds its ranks to, from the one-card model of ``cfg``
    (Jamba at HYBRID_MESH_LAYERS layers, drawn from the seed): the fixed
    run of HYBRID_MESH_FLAGS on one card (its prompts and greedy ids) and
    the teacher-forced logits of its positions."""
    from repro_torch.launch import serve
    from repro_torch.launch import steps as ST
    t0 = time.time()
    model = ST.init_model(cfg, seed=SEED, device="cuda")
    args = serve.build_parser().parse_args(
        HYBRID_MESH_FLAGS[:HYBRID_MESH_FLAGS.index("--mesh")])
    fixed = serve.run_fixed(args, model)
    prompts = torch.from_numpy(fixed.prompts)
    ids = torch.from_numpy(fixed.ids.astype("int32"))
    logits = fixed_teacher_forced(model, prompts, ids)
    del model
    log(f"[hybrid mesh expectations] {cfg.name} at {cfg.n_layers} layers: "
        f"the one-card fixed run's ids {tuple(ids.shape)} and teacher-forced"
        f" logits "
        f"{tuple(logits.shape)}, in {time.time() - t0:.1f}s")
    return dict(prompts=prompts, ids=ids, logits=logits,
                margin=top2_margin(logits))


def phase_hybrid_mesh(cfg, smi, expect):
    """14a: ``serve.py --mode fixed`` of Jamba at full width and
    HYBRID_MESH_LAYERS layers (``cfg``) on (1,2,2,1), four gloo ranks on
    this card, each holding its shard of every weight (the Mamba layers'
    inner channels over y). The teacher-forced logits of the one-card
    run (taken in phase 11's first launch) against one card's
    (MESH_TF_TOL of max|logit|), then the served
    run: its greedy ids held to one card's above the margin, launches (K6
    once a Mamba layer a forward) and collective calls per forward the
    code's, prefill and decode times, comm by axis and each rank's peak
    memory."""
    mesh = torch.load(HYBRID_MESH_DIR / "mesh_logits.pt")
    one = expect["logits"]
    err, scale = max_err(mesh, one), float(one.abs().max())
    log(f"[hybrid mesh teacher-forced] taken in phase 11's launch: "
        f"logits {tuple(mesh.shape)}: max|mesh - one "
        f"card| = {err:.3e}, max|logit| = {scale:.3e}, {err / scale:.3e} of"
        f" it (tol {MESH_TF_TOL:g}); TF32 off")
    if not (math.isfinite(err) and err <= MESH_TF_TOL * scale):
        raise AssertionError("the mesh's Jamba logits differ from one card's")
    thr = MESH_MARGIN * err
    del mesh
    lines = launch_serve(HYBRID_MESH_FLAGS, cfg.n_layers,
                         "hybrid mesh fixed serve")
    gen = int(HYBRID_MESH_FLAGS[HYBRID_MESH_FLAGS.index("--gen") + 1])
    rep = mesh_report(lines, {}, mesh_launches(cfg, 1, gen - 1),
                      lambda r: (1, gen), "run", cfg, smi)
    check_ids(rep["ids"], expect["ids"].tolist(), expect["margin"], thr,
              "hybrid fixed, against the one-card model's")
    B, T = expect["prompts"].shape
    log(f"  prefill {B} x {T}: {rep['prefill_s']:.4f} s; decode {gen - 1} "
        f"steps x batch {B}: {rep['decode_s']:.4f} s, "
        f"{rep['tokens_per_s']:.2f} tokens/s, "
        f"{1e3 * rep['decode_s'] / (gen - 1):.1f} ms/step, on {smi}")
    return sorted(rep["ranks"], key=lambda r: r["rank"])[0]["launches"]


def long_config(cfg):
    """14b's model: ``cfg`` at full width, one period of its pattern."""
    return depth_cut(cfg, LONG_LAYERS)


def long_caches(cfg, axes, device):
    """14b's caches for one sequence of LONG_CONTEXT positions, drawn from
    the seed as whole (global) tensors in layer order, each rank keeping
    its shard of them: the attention layer's K and V random below LONG_P0
    and 0 from it on (positions over data, KV heads over y), the Mamba
    layers' conv inputs and scan states random (their channels over y,
    replicated over data)."""
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.core.partition import keep_shard
    from repro_torch.layers.attention import SEQ_CACHE_SPEC
    from repro_torch.layers.mamba import SEQ_STATE_SPECS
    from repro_torch.models.decoder import decoder_cache_specs
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    caches = []
    for layer in decoder_cache_specs(cfg, MeshAxes(), 1, LONG_CONTEXT):
        out = {}
        for name, (shape, dt) in layer.items():
            v = torch.randn(shape, generator=gen, device=device, dtype=dt)
            if name in ("k", "v"):
                v[:, LONG_P0:] = 0
                spec = SEQ_CACHE_SPEC
            else:
                v.mul_(0.5 if name == "conv" else 0.1)
                spec = SEQ_STATE_SPECS[name]
            out[name] = keep_shard(v, axes, spec)
            del v
        caches.append(out)
    return caches


def long_collectives(cfg):
    """Collective calls by axis of one step of 14b on a rank of (2,1,2,1)
    (x of 1: no norm psums), counted from the code: over data the
    attention layer's pmax of the shards' lse and psum of (num, den);
    over y the psums of each Mamba layer's w_x, w_out and MLP down
    projection, of each attention layer's output and MLP down
    projections, the embedding's psum and the logits' gather."""
    n_attn = cfg.mixers().count("attn")
    n_mamba = cfg.mixers().count("mamba")
    return {"data": 2 * n_attn, "y": 3 * n_mamba + 2 * n_attn + 2}


def long_worker(outdir: Path) -> int:
    """One rank of 14b (started by ``phase_long_context`` through
    ``launch_ranks``): the cut Jamba drawn from seed 0 on (2,1,2,1)
    with its shard of the seeded caches, LONG_STEPS steps of
    ``make_decode_step(seqshard=True)`` fed one card's ids; each rank
    saves its report, rank 0 the logits gathered over y."""
    from repro_torch.configs import get_config
    from repro_torch.core import mesh as M
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import close_mesh, init_mesh, mesh_axes
    axes = mesh_axes(LONG_MESH)
    run = init_mesh(axes, device="cuda")
    try:
        dev = run["device"]
        cfg = long_config(get_config(HYBRID))
        model = ST.init_model(cfg, axes, seed=SEED, device=dev)
        caches = long_caches(cfg, axes, dev)
        step, ct = ST.make_decode_step(cfg, axes, seqshard=True)(
            1, LONG_CONTEXT)
        shapes = [{k: tuple(v.shape) for k, v in c.items()} for c in caches]
        if shapes != [{k: v[0] for k, v in c.items()} for c in ct]:
            raise AssertionError(f"caches {shapes} against the specs {ct}")
        toks = torch.load(outdir / "job.pt")["tokens"]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        M.reset_comm()
        logits, step_s = [], []
        for j in range(LONG_STEPS):
            t0 = time.time()
            lg, caches = step(model, caches, toks[j].to(dev), LONG_P0 + j)
            lg = ST.gather_logits(lg, axes, seqshard=True)
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            logits.append(lg.float().cpu())
        rep = dict(rank=run["rank"], step_s=step_s,
                   launches=ops.launches(), comm_axes=M.COMM_AXES,
                   resident=resident,
                   peak=torch.cuda.max_memory_allocated(dev),
                   cache_bytes=sum(v.numel() * v.element_size()
                                   for c in caches for v in c.values()))
        torch.save(rep, outdir / f"rank{run['rank']}.pt")
        if run["rank"] == 0:
            torch.save(torch.cat(logits, 1), outdir / "logits.pt")
    finally:
        close_mesh()
    return 0


def phase_long_context(hcfg, smi):
    """14b: ``make_decode_step(seqshard=True)`` of one sequence at 524,288
    positions on (2,1,2,1), four gloo ranks on this card (two data shards
    of the cache's positions, two y shards of the heads and channels),
    Jamba at full width cut to one period (LONG_LAYERS). First one card's
    ``make_decode_step`` (mode "decode": K5 over the whole cache) takes
    LONG_STEPS greedy steps from LONG_P0 on the same weights and caches;
    then the ranks take the same steps fed its ids. Every step's logits
    within LOGIT_TOL of one card's and their greedy ids equal above the
    margin; launches (K5 one a step with its lse, K6 7) and collectives
    by axis the code's; ms a step and memory a rank."""
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    cfg = long_config(hcfg)
    n_attn = cfg.mixers().count("attn")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = ST.init_model(cfg, seed=SEED, device="cuda")
    caches = long_caches(cfg, MeshAxes(), "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    cache_gb = sum(v.numel() * v.element_size() for c in caches
                   for v in c.values()) / 1e9
    log(f"[long context] {cfg.name} at full width cut to one period "
        f"({LONG_LAYERS} layers: {cfg.mixers().count('mamba')} Mamba, "
        f"{n_attn} attention; {n_params / 1e9:.3f} B parameters), one "
        f"sequence at {LONG_CONTEXT} positions (long_500k), keys seeded "
        f"below {LONG_P0}; caches {cache_gb:.2f} GB; built in "
        f"{time.time() - t0:.1f}s")
    step, _ = ST.make_decode_step(cfg, MeshAxes())(1, LONG_CONTEXT)
    tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=torch.
                        Generator().manual_seed(SEED + 14),
                        dtype=torch.int32).cuda()
    toks, one, one_s = [], [], []
    ops.reset_launches()
    for j in range(LONG_STEPS):
        toks.append(tok.cpu())
        t0 = time.time()
        lg, caches = step(model, caches, tok, LONG_P0 + j)
        torch.cuda.synchronize()
        one_s.append(time.time() - t0)
        one.append(lg.float().cpu())
        tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
    check_launches(ops.launches(), dict(fixed_launches(cfg, 0, 1),
                                        rmsnorm_stats=0, rmsnorm_apply=0),
                   LONG_STEPS, "step")
    one = torch.cat(one, 1)
    log(f"  one card (mode decode, K5 over {LONG_CONTEXT} keys): "
        f"{1e3 * sum(one_s[1:]) / (LONG_STEPS - 1):.2f} ms a step after the "
        f"first ({1e3 * one_s[0]:.2f} ms), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {smi}")
    del model, caches, step
    free_memory()
    LONG_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(dict(tokens=toks), LONG_DIR / "job.pt")
    launch_ranks([str(ROOT / "chip_smoke.py"), "--long-worker",
                  str(LONG_DIR)], "long context seqshard decode "
                 f"({LONG_MESH})", MESH_RANKS, LONG_TIMEOUT_S)
    mesh = torch.load(LONG_DIR / "logits.pt")
    err, scale = max_err(mesh, one), float(one.abs().max())
    ok = torch.allclose(mesh, one, **LOGIT_TOL)
    log(f"  logits of {LONG_STEPS} steps {tuple(mesh.shape)}: max|seqshard "
        f"- one card| = {err:.3e}, max|logit| = {scale:.3e} (rtol "
        f"{LOGIT_TOL['rtol']:g}, atol {LOGIT_TOL['atol']:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the seq-sharded decode's logits differ from "
                             "one card's")
    check_ids([mesh[0].argmax(-1).tolist()], [one[0].argmax(-1).tolist()],
              top2_margin(one), MESH_MARGIN * err,
              "seq-sharded greedy ids, against one card's")
    want = dict(fixed_launches(cfg, 0, 1), rmsnorm_stats=0, rmsnorm_apply=0)
    calls = long_collectives(cfg)
    for r in range(MESH_RANKS):
        rep = torch.load(LONG_DIR / f"rank{r}.pt")
        log(f"  rank {r}:")
        check_launches(rep["launches"], want, LONG_STEPS, "step")
        got = {a: v["calls"] / LONG_STEPS for a, v in
               rep["comm_axes"].items()}
        log("    collectives a step by axis: " + ", ".join(
            f"{a} {v['calls'] / LONG_STEPS:g} calls "
            f"{1e3 * v['seconds'] / LONG_STEPS:.2f} ms "
            f"{v['bytes'] / LONG_STEPS / 1e3:.2f} kB"
            for a, v in sorted(rep["comm_axes"].items()))
            + f" (expected calls {calls})")
        if got != calls:
            raise AssertionError(f"rank {r}: collectives a step {got}, "
                                 f"expected {calls}")
        s = rep["step_s"]
        log(f"    {1e3 * sum(s[1:]) / (len(s) - 1):.2f} ms a step after the "
            f"first ({1e3 * s[0]:.2f} ms); K5 {rep['launches']['paged_attention']}"
            f" launches, each with its lse; caches {rep['cache_bytes'] / 1e9:.3f}"
            f" GB, resident {rep['resident'] / 2**30:.2f} GiB, "
            f"max_memory_allocated {rep['peak'] / 2**30:.2f} GiB, on {smi}")


# ---------------------------------------------------------------------- #
# phase 15: ZeRO-1 on the mesh, checkpoints across meshes, remat "dots"
# ---------------------------------------------------------------------- #

def log_data_axis(r):
    """A rank's data-axis traffic: the bucketed sync's reduce-scatters and
    all-gathers (calls, bytes, seconds) of each step, and the data axis's
    collectives in all."""
    for i, (dp, by_axis) in enumerate(zip(r["dp_sync"], r["comm_by_axis"])):
        data = by_axis.get("data", {})
        log(f"    step {i}: "
            + ", ".join(f"{k} {c['calls']} calls {c['bytes'] / 1e9:.3f} GB "
                        f"{c['seconds']:.3f} s" for k, c in sorted(dp.items()))
            + f"; data axis in all {data.get('calls', 0)} calls "
            f"{data.get('bytes', 0) / 1e9:.3f} GB "
            f"{data.get('seconds', 0.0):.3f} s")


def phase_zero_train(cfg, smi, one):
    """15a: ``train.py --zero`` on (2,2,2,1), eight gloo ranks on this
    card, at full width and MESH_LAYERS layers (``cfg``; run after 12b in
    its launch), held to one card's run ``one`` of the same model for its
    ZERO_STEPS steps; the data replicas bitwise equal."""
    import types
    from repro_torch.launch.mesh import mesh_axes
    rep = mesh_train_report("zero")
    check_mesh_losses(rep, types.SimpleNamespace(
        losses=one.losses[:ZERO_STEPS], grad_norms=one.grad_norms[
            :ZERO_STEPS]), f"({ZERO_MESH}) --zero against one card")
    axes = mesh_axes(ZERO_MESH)
    blocks = {}
    for r in rep["ranks"]:
        blocks.setdefault(axes.coords(r["rank"])[1:], set()).add(
            r["param_sha256"])
    if not (all(len(h) == 1 for h in blocks.values())
            and len(blocks) == MESH_TRAIN_RANKS // axes.dp):
        raise AssertionError(f"the data replicas differ: {blocks}")
    log(f"  the {axes.dp} data replicas of each of the {len(blocks)} blocks "
        f"bitwise equal after {len(rep['losses'])} steps")
    for r in sorted(rep["ranks"], key=lambda r: r["rank"]):
        sb = r["state_bytes"]
        log(f"  rank {r['rank']}: max_memory_allocated "
            f"{r['max_memory_bytes'] / 2**30:.2f} GiB; parameters "
            f"{sb['params'] / 2**30:.3f} GiB, optimizer state (ZeRO-1 "
            f"shards) {sb['opt_state'] / 2**30:.3f} GiB; comm in all "
            f"{[round(x, 3) for x in r['comm_s']]} s "
            f"{[round(b / 1e9, 3) for b in r['comm_bytes']]} GB per step")
        log_data_axis(r)
    steady = rep["step_s"][1:] or rep["step_s"]
    log(f"  rank 0 step times {[round(x, 3) for x in rep['step_s']]} s; "
        f"steady step {sum(steady) / len(steady):.3f} s, "
        f"{rep['n_params'] / 1e9:.3f} B parameters, on {smi}")


def verify_ckpt(path, run):
    """Verify the checkpoint ``path`` that ``run`` (a launch's report)
    saved after its step CKPT_A_STEPS - 1; log its size and times."""
    from repro_torch.checkpoint import ckpt
    t0 = time.perf_counter()
    info = ckpt.verify(str(path))
    verify_s = time.perf_counter() - t0
    log(f"  {path.name}: verify {info}, {verify_s:.3f} s; "
        f"{path.stat().st_size} bytes ({path.stat().st_size / 2**20:.1f} "
        f"MiB); save {[round(x, 3) for x in run['ckpt']['save_s']]} s "
        f"(rank 0)")
    if not (info["checksummed"] and info["step"] == CKPT_A_STEPS - 1):
        raise AssertionError(f"checkpoint {info}")


def phase_ckpt_resume(smi):
    """15b and 16c at --preset 100m: 16c's run A (3 of 4 steps, --zero3
    --ckpt, (4,1,1,1)); then one launch on (2,1,2,1) of 15b's run A (3 of
    4 steps, --zero --ckpt) and 16c's run B (A's ZeRO-3 file resumed with
    --zero for the 4th step); run C, the 4 steps on one card. Each file
    verified; both removed after. (15b's run B, a resume without --zero
    on (1,1,2,1), is cut for the script's time: 16c's B resumes across
    modes and meshes.)"""
    import shutil
    import tempfile
    from repro_torch.launch import train
    outdir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                   dir=ROOT / "build"))
    try:
        z3a = run_mesh_train("zero3-ckpt-a", f"zero3 ckpt A "
                             f"({ZERO3_CKPT_A_MESH}, --zero3 --ckpt, "
                             f"{CKPT_A_STEPS} of 4 steps)", 4, outdir)
        verify_ckpt(outdir / "zero3.npz", z3a)
        a = run_mesh_train("ckpt-a", f"ckpt A ({CKPT_A_MESH}, --zero "
                           f"--ckpt, {CKPT_A_STEPS} of 4 steps), then zero3 "
                           f"ckpt B (--resume with --zero)", 4, outdir,
                           then=("zero3-ckpt-b",))
        z3b = mesh_train_report("zero3-ckpt-b", outdir)
        verify_ckpt(outdir / "ckpt.npz", a)
        free_memory()
        log(f"[ckpt C] one card, python -m repro_torch.launch.train "
            f"{' '.join(CKPT_FLAGS)}")
        c = train.main(CKPT_FLAGS)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    later = MESH_TRAIN_TOL["later_loss"]
    gaps = [abs(x - y) for x, y in zip(a["losses"], c.losses)]
    log(f"  15b: A {a['losses']} (steps 0-{CKPT_A_STEPS - 1}), C {c.losses};"
        f" max |loss - C| {max(gaps):.3e} (tol {later:g})")
    if not (len(gaps) == CKPT_A_STEPS and max(gaps) <= later):
        raise AssertionError("15b's run A differs from one card's")
    gaps = [abs(x - y) for x, y in zip(z3a["losses"] + z3b["losses"],
                                       c.losses)]
    same = z3b["losses"][0] == c.losses[-1]
    log(f"  16c: A {z3a['losses']} (steps 0-{CKPT_A_STEPS - 1}), B "
        f"{z3b['losses']} (from step {z3b['first_step']}); max |loss - C| "
        f"{max(gaps):.3e} (tol {later:g}); B's step {z3b['first_step']} "
        f"{z3b['losses'][0]!r} against C's {c.losses[-1]!r} "
        f"({'bitwise' if same else 'not bitwise'}); restore "
        f"{z3b['ckpt']['restore_s']:.3f} s, on {smi}")
    if not (z3b["first_step"] == CKPT_A_STEPS and len(gaps) == 4
            and max(gaps) <= later):
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")


def phase_dots_train(cfg, smi, one, one_launches):
    """15c: phase 8's run through ``make_train_step`` under remat "dots":
    losses bitwise phase 8's ("full"), K1 21L + 3 a microbatch. (The
    same run under "full", whose parameters the "dots" run's were held
    to bitwise, is cut for the script's time.)"""
    from repro_torch.core.mesh import MeshAxes
    from repro_torch.data.synthetic import DataConfig, SyntheticText, \
        make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig, init_state
    import numpy as np
    args = train.build_parser().parse_args(TRAIN_FLAGS)
    data = SyntheticText(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch))
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                      total_steps=args.steps)
    from repro_torch.models.decoder import lm_loss
    runs = {}
    for policy in ("dots",):
        free_memory()
        model = ST.init_model(cfg, seed=0, device="cuda")
        # one microbatch of the first batch alone: what the forward leaves
        # for the backward (the tapes of "dots" among it), and the peak
        mb = {k: torch.from_numpy(v[:args.batch // args.overdecompose]
                                  ).cuda() for k, v in make_batch(
            cfg, 0, data, dtype=np.float32).items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = lm_loss(model, mb["tokens"], mb["labels"], remat=True,
                          remat_policy=policy)
        kept = torch.cuda.memory_allocated() - base
        taped = sum(o.numel() * o.element_size() for t in gc.get_objects()
                    if isinstance(t, ops.K1Tape) for o, _ in t.saved)
        loss.backward()
        torch.cuda.synchronize()
        probe = (kept, taped, torch.cuda.max_memory_allocated() - base)
        del loss, mb
        model.zero_grad(set_to_none=True)
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(dict(model.named_parameters()))
        step = ST.make_train_step(cfg, MeshAxes(), opt, ST.TrainOptions(
            overdecompose=args.overdecompose, dtype=torch.float32,
            remat_policy=policy))
        ops.reset_launches()
        losses, times = [], []
        for i in range(args.steps):
            batch = {k: torch.from_numpy(v).cuda() for k, v in make_batch(
                cfg, i, data, dtype=np.float32).items()}
            t0 = time.perf_counter()
            losses.append(float(step(model, state, batch)["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        del state
        runs[policy] = (losses, times, launches, peak)
        del model
        log(f"  [{policy}] losses {losses}, step times "
            f"{[round(x, 4) for x in times]} s, K1 "
            f"{launches['block_matmul'] / (args.steps * args.overdecompose):g}"
            f" a microbatch, max_memory_allocated {peak / 2**30:.2f} GiB; "
            f"one microbatch's forward keeps {probe[0] / 2**30:.3f} GiB "
            f"(K1 tapes {probe[1] / 2**30:.3f}), its forward and backward "
            f"peak {probe[2] / 2**30:.3f} GiB above the parameters")
    ld, td, kd, pd = runs["dots"]
    del runs
    free_memory()
    L = cfg.n_layers
    per_mb = {"block_matmul": 21 * L + 3, "flash_attention": 2 * L,
              "flash_attention_bwd": L, "rmsnorm": 8 * L + 1}
    check_launches(kd, per_mb, args.steps * args.overdecompose,
                   "microbatch")
    units = args.steps * args.overdecompose
    steady = lambda t: sum(t[1:]) / len(t[1:])  # noqa: E731
    same_losses = ld == one.losses
    pf = one.max_memory_bytes
    log(f"  dots: losses {'bitwise equal' if same_losses else 'DIFFER'}"
        f" to phase 8's (remat 'full'); K1 a microbatch "
        f"{kd['block_matmul'] / units:g} against phase 8's "
        f"{one_launches['block_matmul'] / units:g}; steady step "
        f"{steady(td):.4f} s against phase 8's {steady(one.step_s):.4f} s; "
        f"max_memory_allocated {pd / 2**30:.2f} GiB against phase 8's "
        f"{pf / 2**30:.2f} GiB (+{(pd - pf) / 2**30:.2f}) on {smi}")
    if not same_losses:
        raise AssertionError("remat 'dots' differs from 'full'")


# ---------------------------------------------------------------------- #
# phase 16: ZeRO-3 parameter-shard streaming, with and without prefetch
# ---------------------------------------------------------------------- #

def zero3_volumes(cfg):
    """(bytes, streamed bytes) the data axis counts a rank and step (each
    hop's bytes sent and received) in 16a and 16b, by the copied
    ``comm_model.dp_sync_volume`` over the leaf plan's padded buffers: a
    streamed leaf (one that stacks layers) 3 passes a microbatch, 2 with
    prefetch; a resident one 2. The plan is that of a ZeRO-3 model drawn
    on this card (its shards alone, 0.80 GiB), freed after."""
    import dataclasses
    from repro_torch.core import comm_model as CM
    from repro_torch.core.gradsync import GradSyncConfig
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.launch.mesh import mesh_axes
    axes = mesh_axes(ZERO3_MESH)
    model = ST.init_model(cfg, axes, seed=SEED, device="cuda", zero3=True)
    out = {}
    for which, flags in (("zero3", ZERO3_FLAGS),
                         ("zero3-prefetch", ZERO3_PREFETCH_FLAGS)):
        args = train.build_parser().parse_args(flags)
        gs = GradSyncConfig(zero3=True, prefetch=args.zero3_prefetch,
                            bucket_mb=args.dp_bucket_mb)
        plan = ST.train_plan(dict(model.named_parameters()), cfg, axes, gs)
        vol = {True: 0.0, False: 0.0}
        for b in plan.buckets:
            streamed = b.stack > 1
            mine = gs if streamed else dataclasses.replace(gs, prefetch=True)
            vol[streamed] += CM.dp_sync_volume(
                axes.dp, b.padded * b.stack, mine, args.overdecompose)
        out[which] = (2 * 4 * (vol[True] + vol[False]), 2 * 4 * vol[True])
    del model
    free_memory()
    return out


def phase_zero3_train(cfg, smi):
    """16a and 16b: ``train.py --zero3`` on (8,1,1,1) at full width and
    depth for ZERO3_STEPS steps, then ``--zero3 --zero3-prefetch`` for one,
    eight gloo ranks on this card in one launch; both held to one card's
    run of the same batch (taken first in this process, its memory freed
    before the launch); 16b's step bitwise 16a's first; every rank's
    gathered parameters hashing alike; K1 28L + 3 a microbatch; the data
    axis's bytes the plan's count (``zero3_volumes``)."""
    import types
    from repro_torch.launch import train
    import resource
    want = zero3_volumes(cfg)
    log(f"  this process's peak host RSS so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
        f" GiB")
    log(f"[zero3 one card] python -m repro_torch.launch.train "
        f"{' '.join(ZERO3_ONE_FLAGS)}")
    one = train.main(ZERO3_ONE_FLAGS)
    one_peak = one.max_memory_bytes
    free_memory()
    rep = run_mesh_train("zero3", f"zero3 train ({ZERO3_MESH}, full depth, "
                         f"--zero3; then --zero3-prefetch)", ZERO3_RANKS,
                         env={"PYTORCH_CUDA_ALLOC_CONF":
                              "expandable_segments:True"},
                         then=("zero3-prefetch",))
    pre = mesh_train_report("zero3-prefetch")
    check_mesh_losses(rep, one, f"({ZERO3_MESH}) --zero3 against one card")
    check_mesh_losses(pre, types.SimpleNamespace(
        losses=one.losses[:1], grad_norms=one.grad_norms[:1]),
        f"({ZERO3_MESH}) --zero3 --zero3-prefetch against one card")
    log(f"  one card: step times {[round(x, 3) for x in one.step_s]} s, "
        f"max_memory_allocated {one_peak / 2**30:.2f} GiB")
    same = (pre["losses"][0] == rep["losses"][0]
            and pre["grad_norms"][0] == rep["grad_norms"][0])
    log(f"  16b's step {pre['losses'][0]!r} / {pre['grad_norms'][0]!r} "
        f"against 16a's first {rep['losses'][0]!r} / "
        f"{rep['grad_norms'][0]!r}: {'bitwise' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("prefetch changed the step")
    args = train.build_parser().parse_args(ZERO3_FLAGS)
    units = {"zero3": args.steps * args.overdecompose, "zero3-prefetch": 1}
    counted = {}
    for which, r_ in (("zero3", rep), ("zero3-prefetch", pre)):
        hashes = {r["param_sha256"] for r in r_["ranks"]}
        log(f"  [{which}] the {len(r_['ranks'])} ranks' gathered parameters"
            f" hash {'alike' if len(hashes) == 1 else 'APART'}: "
            f"{sorted(hashes)[0][:16]}")
        if len(hashes) != 1:
            raise AssertionError(f"{which}: the ranks' parameters differ")
        total, streamed = want[which]
        for r in sorted(r_["ranks"], key=lambda r: r["rank"]):
            sb = r["state_bytes"]
            log(f"  rank {r['rank']}: max_memory_allocated "
                f"{r['max_memory_bytes'] / 2**30:.2f} GiB; parameter shards "
                f"{sb['params'] / 2**30:.3f} GiB, optimizer state "
                f"{sb['opt_state'] / 2**30:.3f} GiB; peak host RSS "
                f"{r['max_rss_bytes'] / 2**30:.2f} GiB")
            check_launches(r["launches"], train_launch_counts(cfg),
                           units[which], "microbatch")
            for i, (dp, t) in enumerate(zip(r["dp_sync"], r_["step_s"])):
                got = sum(c["bytes"] for c in dp.values())
                secs = sum(c["seconds"] for c in dp.values())
                log(f"    step {i}: " + ", ".join(
                    f"{k} {c['calls']} calls {c['bytes'] / 1e9:.3f} GB "
                    f"{c['seconds']:.3f} s" for k, c in sorted(dp.items()))
                    + f"; data axis {got / 1e9:.3f} GB (the plan's "
                    f"{total / 1e9:.3f}), {secs:.3f} s exposed of a "
                    f"{t:.3f} s step ({100 * secs / t:.1f}%)")
                if got != total:
                    raise AssertionError(f"{which} rank {r['rank']} step {i}"
                                         f": data-axis bytes {got}, the "
                                         f"plan's {total}")
        counted[which] = streamed
        steady = r_["step_s"][1:] or r_["step_s"]
        log(f"  [{which}] rank 0 step times "
            f"{[round(x, 3) for x in r_['step_s']]} s; steady "
            f"{sum(steady) / len(steady):.3f} s, {r_['n_params'] / 1e9:.3f} B "
            f"parameters, on {smi}")
    ratio = counted["zero3-prefetch"] / counted["zero3"]
    log(f"  streamed leaves' data-axis bytes a step: 16b "
        f"{counted['zero3-prefetch'] / 1e9:.3f} GB against 16a's "
        f"{counted['zero3'] / 1e9:.3f} GB ({ratio:.4f}; 2/3 expected)")
    if abs(ratio - 2 / 3) > 1e-9:
        raise AssertionError("prefetch did not drop remat's re-gather")


# ---------------------------------------------------------------------- #
# phase 17: the analytical model calibrated on the card
# ---------------------------------------------------------------------- #

def phase_calibrate(smi):
    """17a and 17c: ``launch/calibrate.py --quick --validate`` on
    CALIB_MESH, eight gloo ranks on this card; the fitted profile's
    constants, probes and counted hops checked and logged; the fig5 grid's
    rank correlations and best decompositions."""
    from repro_torch.core import calibrate as CB
    CALIB_PROFILE.parent.mkdir(parents=True, exist_ok=True)
    lines = launch_ranks(
        ["-m", "repro_torch.launch.calibrate", "--mesh", CALIB_MESH,
         "--quick", "--out", str(CALIB_PROFILE), "--validate", "--steps",
         str(CALIB_VALIDATE_STEPS)],
        f"calibrate ({CALIB_MESH}, --quick), then 17c's --validate",
        CALIB_RANKS, CALIB_TIMEOUT_S)
    prof = CB.CalibrationProfile.load(str(CALIB_PROFILE))
    per_card = prof.probes.get("ranks_per_card")
    log(f"  [17a] on {smi}, {'-' if per_card is None else f'{per_card:g}'} "
        f"ranks per card over gloo, mesh "
        f"{prof.mesh_shape}: gamma {prof.gamma:.4e} s/call, alpha "
        f"{prof.alpha:.4e} s/hop, link_bw {prof.link_bw:.4e} B/s, flops "
        f"{prof.flops:.4e} FLOP/s (K1 fp32, one rank's share of the card), "
        f"r2 {prof.fit_r2:.4f}, {len(prof.samples)} samples")
    for f in prof.axis_fits:
        log(f"    axis {f.axis} (p={f.p}): gamma {f.gamma:.4e} alpha "
            f"{f.alpha:.4e} link_bw {f.link_bw:.4e} r2 {f.r2:.4f} "
            f"n={f.n_samples}")
    log(f"    overlap_efficiency {prof.overlap_efficiency:.4f} (z ring "
        f"{prof.probes['overlap_z_hidden']:.4f}, all-reduce ring "
        f"{prof.probes['overlap_ar_hidden']:.4f} hidden), z_claims_first "
        f"{prof.z_claims_first}, cross_step_efficiency "
        f"{prof.cross_step_efficiency:.4f}"
        + ("; link_bw taken from the largest message (beta fit to 0)"
           if "link_bw_of_largest_message" in prof.probes else ""))
    bad = [k for k, v in (("gamma", prof.gamma), ("alpha", prof.alpha),
                          ("flops", prof.flops))
           if not (math.isfinite(v) and v >= 0)]
    if bad or not (0 < prof.link_bw < math.inf and prof.flops > 0):
        raise AssertionError(f"the fitted profile is not physical: {bad}, "
                             f"link_bw {prof.link_bw}, flops {prof.flops}")
    p_of = {f.axis: f.p for f in prof.axis_fits}
    hops = {k[len("hops:"):]: v for k, v in prof.probes.items()
            if k.startswith("hops:")}
    if len(hops) != len(CB._KINDS) * len(p_of):
        raise AssertionError(f"hops counted for {sorted(hops)}")
    for key, counted in sorted(hops.items()):
        kind, axis = key.split("@")
        code = CB.ring_hops(kind, p_of[axis])
        log(f"    hops {key}: counted {counted:g} a call, the code's {code} "
            f"(the model's geometry "
            f"{CB.collective_geometry(kind, p_of[axis], 1.0)[0]})")
        if counted != code:
            raise AssertionError(f"{key}: {counted} hops a call, the code "
                                 f"makes {code}")
    rows = {}
    for ln in lines:
        if ln.startswith("fig5_measured/"):
            label, val, derived = ln.split(",", 2)
            rows[label[len("fig5_measured/"):]] = (float(val), derived)
    need = ("best", "predicted_best", "rank_correlation",
            "rank_correlation_decomp")
    if any(k not in rows or not math.isfinite(rows[k][0]) for k in need):
        raise AssertionError(f"17c printed {sorted(rows)}")
    log(f"  [17c] fig5 grid ({len(rows) - len(need)} configurations, "
        f"{CALIB_VALIDATE_STEPS} steps x 3 rounds): rank_correlation "
        f"{rows['rank_correlation'][0]:.4f}, decompositions at S=64 "
        f"{rows['rank_correlation_decomp'][0]:.4f}; measured best "
        f"{rows['best'][1]} at {rows['best'][0]:.1f} us/step, predicted "
        f"{rows['predicted_best'][1]} at "
        f"{rows['predicted_best'][0]:.1f} us/step, on {smi}")


def model_counts(args, cfg):
    """(collective calls, ring hops, wire bytes) a rank and step that the
    analytical model charges the run ``args`` makes of ``cfg``: its step
    priced (``train.predict_step``, blocking) with one unit constant at a
    time and nothing hidden."""
    from repro_torch.core import calibrate as CB
    from repro_torch.launch import train

    def price(**unit):
        base = dict(backend="cuda", n_devices=1, mesh_shape=(1, 1, 1, 1),
                    alpha=0.0, gamma=0.0, link_bw=1e300, flops=1e300,
                    overlap_efficiency=0.0, cross_step_efficiency=0.0)
        prof = CB.CalibrationProfile(**dict(base, **unit))
        return train.predict_step(prof, args, cfg).exposed_comm
    return price(gamma=1.0), price(alpha=1.0), price(link_bw=1.0)


def phase_calib_steps(smi):
    """17b: 12a's and 16a's telemetry files valid; for phases 10, 12a, 13a,
    15a and 16a the model's step time on 17a's profile, priced with each
    run's flags, depth and schedule, against the run's measured steady
    step (the first step excluded), and the Spearman correlation of the
    two over the five."""
    from repro_torch.configs import get_config
    from repro_torch.core import calibrate as CB
    from repro_torch.core.overlap import OverlapConfig
    from repro_torch.launch import telemetry as TL
    from repro_torch.launch import train
    log("[17b] the calibrated model against the measured mesh steps")
    prof = CB.CalibrationProfile.load(str(CALIB_PROFILE))
    for which in ("mesh", "zero3"):
        path = MESH_TRAIN_DIR / f"{which}.jsonl"
        log(f"  [17b] {path.name}: {TL.validate_file(str(path))} telemetry "
            f"records, valid")
    cut = cut_config(get_config(ARCH))
    phases = [("10", "seq", SEQ_FLAGS, cut, OverlapConfig()),
              ("12a", "mesh", MESH_TRAIN_FLAGS, cut, OverlapConfig()),
              ("13a", "mesh-overlap", MESH_TRAIN_FLAGS, cut,
               OverlapConfig.all_on()),
              ("15a", "zero", ZERO_FLAGS, cut, OverlapConfig()),
              ("16a", "zero3", ZERO3_FLAGS, get_config(ARCH),
               OverlapConfig())]
    pred, meas = [], []
    for label, which, flags, cfg, ov in phases:
        args = train.build_parser().parse_args(flags)
        p = train.predict_step(prof, args, cfg, ov)
        rep = mesh_train_report(which)
        own = rep.get("predicted")
        if own is not None and own["total"] != p.total:
            raise AssertionError(f"{label}: the run predicted {own}, the "
                                 f"script {p}")
        steady = rep["step_s"][1:] or rep["step_s"]
        m = sum(steady) / len(steady)
        pred.append(p.total)
        meas.append(m)
        log(f"  [17b] {label} ({args.mesh}, {cfg.n_layers} layers"
            + (", overlapped" if ov.any_enabled else "")
            + (", --zero3" if args.zero3 else ", --zero" if args.zero
               else "")
            + f"): predicted {p.total:.4f} s (compute {p.compute:.4f} + "
            f"exposed {p.exposed_comm:.4f}, hidden {p.hidden_comm:.4f}), "
            f"measured {m:.4f} s ({len(steady)} steady steps), measured/"
            f"predicted {m / p.total:.4f}"
            + (" [the run's own prediction, bitwise]" if own else ""))
        calls, hops, wire = model_counts(args, cfg)
        last = rep["ranks"][0]["comm_by_kind"][-1]
        log(f"        the model charges {calls:.0f} calls, {hops:.0f} hops, "
            f"{wire / 1e9:.4f} GB sent a step (blocking); rank 0 made "
            f"{sum(c['calls'] for c in last.values())} calls (ring hops "
            f"{last.get('ppermute', {}).get('calls', 0)}), "
            f"{sum(c['bytes'] for c in last.values()) / 2e9:.4f} GB sent "
            f"(half of sent + received) in its last step")
    log(f"  [17b] Spearman(predicted, measured) over phases 10, 12a, 13a, "
        f"15a, 16a: {CB.spearman(pred, meas):.4f}, on {smi}")
    for k, v in sorted(prof.probes.items()):
        if k.startswith("drift:"):
            log(f"    {k} {v:.4f} (telemetry's rolling measured/predicted)")


# ---------------------------------------------------------------------- #
# phase 18: the tracing half
# ---------------------------------------------------------------------- #

PROFILE_STEPS = "2:2"
# ranges rank 0's trace must hold: a z gather ring's second hop, the dW
# ring's first, a hop's GEMM, the embedding's z gather
PROFILE_LABELS = ("ring_ag[z]/hop1", "ring_rs[z]/hop0", "gemm/chunk0",
                  "embed_gather[z]")
K1_KERNELS = tuple(k for k, g in KERNEL_GROUPS if g == "K1 block_matmul")


def trace_spans(path):
    """One rank's chrome trace (``torch.profiler``'s export): the names of
    its ``record_function`` ranges; the host seconds inside each scope
    class's ranges (a class's ranges can hold another's: ``gemm/chunk``
    inside ``ring_ag[z]/hop``); and K1's kernels (its tiles, decode
    kernels and split sums: a wrapper launch can run two) and their device
    seconds, in all and those whose launch call (found by the kernel's
    correlation id) lies inside a ``gemm/chunk`` range of its thread."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    # the scopes' ranges (gloo's own ranges, "gloo:send" and the like,
    # carry a colon, which no scope label has)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("ph") == "X" and ":" not in e["name"]]
    host, gemm = {}, {}
    for e in ranges:
        cls = e["name"].split("/", 1)[0]
        host[cls] = host.get(cls, 0.0) + e["dur"] / 1e6
        if e["name"].startswith("gemm/"):
            gemm.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") == "cuda_runtime"
             and "correlation" in e.get("args", {})}
    k1 = {"kernels": 0, "s": 0.0, "in_gemm": 0, "in_gemm_s": 0.0}
    for e in events:
        if e.get("cat") != "kernel" or not any(
                k in e.get("name", "") for k in K1_KERNELS):
            continue
        k1["kernels"] += 1
        k1["s"] += e["dur"] / 1e6
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is not None and any(
                a <= call["ts"] <= b
                for a, b in gemm.get((call["pid"], call["tid"]), ())):
            k1["in_gemm"] += 1
            k1["in_gemm_s"] += e["dur"] / 1e6
    return {e["name"] for e in ranges}, host, k1


def window_comm(r, steps, first_step=0):
    """``mesh.COMM``'s calls and bytes by kind over the window ``steps``
    (A, B) of rank report ``r``: {kind: {"calls", "bytes"}}, kinds with
    calls only."""
    out = {}
    for i in range(steps[0] - first_step, steps[1] - first_step + 1):
        for k, c in r["comm_by_kind"][i].items():
            row = out.setdefault(k, {"calls": 0, "bytes": 0.0})
            row["calls"] += c["calls"]
            row["bytes"] += c["bytes"]
    return {k: v for k, v in out.items() if v["calls"]}


def phase_profile_train(cfg, smi):
    """18: 13a's run with ``--profile-steps 2:2`` (the last run of 12a's
    launch): every rank's trace on disk, rank 0's ranges, the hook's calls
    by scope summing to its totals and those equal to ``mesh.COMM``'s for
    the window, the losses bitwise 13a's; the tally, the unscoped remainder
    beside the model's charge, the totals against 13a's, the overhead."""
    from repro_torch.launch import train
    log(f"[18 profile] 13a's run ({MESH_TRAIN}, {MESH_LAYERS} layers, "
        f"overlapped) with --profile-steps {PROFILE_STEPS}, the last run "
        f"of 12a's launch")
    rep = mesh_train_report("mesh-overlap-profile")
    base = mesh_train_report("mesh-overlap")
    if (rep["losses"], rep["grad_norms"]) != (base["losses"],
                                              base["grad_norms"]):
        raise AssertionError(f"the profiled run's losses {rep['losses']} / "
                             f"{rep['grad_norms']} are not 13a's "
                             f"{base['losses']} / {base['grad_norms']}")
    log(f"  losses {rep['losses']} and grad norms {rep['grad_norms']}: "
        f"13a's, bit for bit")
    window, first = rep["profile"]["steps"], rep["first_step"]
    pdir = ROOT / rep["profile"]["dir"]
    missing = [r for r in range(MESH_TRAIN_RANKS)
               if not (pdir / f"rank{r}.json").is_file()]
    if missing:
        raise AssertionError(f"no trace in {pdir} for ranks {missing}")
    log(f"  {MESH_TRAIN_RANKS} traces in {rep['profile']['dir']}: "
        + ", ".join(f"{(pdir / f'rank{r}.json').stat().st_size / 1e6:.1f}"
                    for r in range(MESH_TRAIN_RANKS)) + " MB")
    ranks = sorted(rep["ranks"], key=lambda r: r["rank"])
    for r in ranks:
        counts = r["collectives"]["counts"]
        total = sum(counts.values())
        if not total:
            raise AssertionError(f"rank {r['rank']}: the hook saw no "
                                 f"collective in the window")
        scoped = sum(x["calls"] for x in r["comm_by_scope"] if x["scope"])
        unscoped = sum(x["calls"] for x in r["comm_by_scope"]
                       if not x["scope"])
        if scoped + unscoped != total:
            raise AssertionError(f"rank {r['rank']}: {scoped} scoped + "
                                 f"{unscoped} unscoped calls, the hook "
                                 f"{total}")
        got = {k: (v["calls"], v["bytes"])
               for k, v in r["collectives_mesh"].items()}
        want = {k: (v["calls"], v["bytes"])
                for k, v in window_comm(r, window, first).items()}
        if got != want:
            raise AssertionError(f"rank {r['rank']}: the hook's calls and "
                                 f"bytes {got}, mesh.COMM's {want}")
        log(f"  rank {r['rank']}: the hook recorded {total} calls ({scoped} "
            f"scoped, {unscoped} not) = mesh.COMM's calls and bytes by kind "
            + ", ".join(f"{k} {n} calls {b / 1e9:.4f} GB"
                        for k, (n, b) in sorted(want.items()))
            + f"; by HLO kind {counts}")
    names, host, k1 = trace_spans(pdir / "rank0.json")
    lacking = [n for n in PROFILE_LABELS if n not in names]
    if lacking:
        raise AssertionError(f"rank 0's trace lacks the ranges {lacking}")
    log(f"  rank 0's trace holds {', '.join(PROFILE_LABELS)} among "
        f"{len(names)} distinct ranges")
    r0 = ranks[0]
    log(f"  rank 0's window by scope class, kind and axis (calls, raw MB, "
        f"wire MB; host s in the class's ranges), on {smi}:")
    for row in r0["comm_by_scope"]:
        cls = row["scope"]
        log(f"    {cls or '(no scope)':<22} {row['kind']:<19} "
            f"{row['axis'] or '-':<16} p {row['group_size']}: "
            f"{row['calls']:5d} calls {row['raw_bytes'] / 1e6:10.3f} MB raw "
            f"{row['wire_bytes'] / 1e6:10.3f} MB wire"
            + (f"; host {host.get(cls, 0.0):.4f} s" if cls else ""))
    log("    host s by scope class: " + ", ".join(
        f"{c} {s_:.4f}" for c, s_ in sorted(host.items())))
    log(f"    K1: {k1['kernels']} kernels, {k1['s'] * 1e3:.3f} ms on the "
        f"device in the window; launched inside a gemm/chunk range: "
        f"{k1['in_gemm']}, {k1['in_gemm_s'] * 1e3:.3f} ms"
        + ("" if k1["kernels"] else " (the trace holds no K1 kernel: "
           "device time not measured)"))
    args = train.build_parser().parse_args(MESH_TRAIN_FLAGS)
    calls, hops, wire = model_counts(args, cfg)
    rest = {}
    for row in r0["comm_by_scope"]:
        if not row["scope"]:
            k = (row["kind"], row["group_size"])
            n, b = rest.get(k, (0, 0.0))
            rest[k] = (n + row["calls"], b + row["wire_bytes"])
    log(f"  rank 0's unscoped remainder (kind, group size: calls, wire GB): "
        + ", ".join(f"{k} p {p}: {n} calls {b / 1e9:.4f} GB"
                    for (k, p), (n, b) in sorted(rest.items()))
        + f"; {sum(n for n, _ in rest.values())} calls "
        f"{sum(b for _, b in rest.values()) / 1e9:.4f} GB in all, beside the "
        f"model's charge for the step: {calls:.0f} calls, {hops:.0f} hops, "
        f"{wire / 1e9:.4f} GB sent (blocking; phase 17b's count)")
    stats = r0["collectives"]
    base_calls = sum(c["calls"] for c in
                     base["ranks"][0]["comm_by_kind"][-1].values())
    log(f"  rank 0's hook totals {sum(stats['counts'].values())} calls, "
        f"{sum(stats['bytes_by_kind'].values()) / 1e9:.4f} GB wire, against "
        f"13a's last step: {base_calls} calls (mesh.COMM)")
    i = window[0] - first
    log(f"  overhead: the profiled step {rep['step_s'][i]:.3f} s against "
        f"step 1's {rep['step_s'][1]:.3f} s ("
        f"{rep['step_s'][i] / rep['step_s'][1]:.3f}x); 13a's step {i} "
        f"{base['step_s'][i]:.3f} s; step times {rep['step_s']}, on {smi}")


def free_memory():
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST

    ST.resolve_device("cuda")          # float32 products stay float32
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = phase_kernels(gen)

    cfg = get_config(ARCH)
    t0 = time.time()
    model = ST.init_model(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name} full width, float32, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"parameters, init {time.time() - t0:.1f}s")
    phase_parity(model, cfg)
    engine, args, serve_launches, served = phase_serve(model, cfg, smi)
    phase_profile(engine, args, cfg)
    del engine
    free_memory()
    phase_serve_pool(model, cfg, smi, served)
    del model
    free_memory()
    mesh_expect = mesh_expectations(depth_cut(cfg, MESH_SERVE_LAYERS))
    free_memory()
    times = phase_timings(gen, cfg.n_layers)
    free_memory()
    phase_train_parity(cfg)
    free_memory()
    train_launches, train_res = phase_train(cfg, smi)
    free_memory()
    phase_train_profile(cfg)
    free_memory()

    hcfg = get_config(HYBRID)
    t0 = time.time()
    hybrid = ST.init_model(hcfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {hcfg.name} full width and depth, float32, "
        f"{sum(p.numel() for p in hybrid.parameters()) / 1e9:.3f} B "
        f"parameters, init {time.time() - t0:.1f}s")
    phase_fixed_parity(hybrid, hcfg)
    fixed_launches_run = phase_fixed_serve(hybrid, hcfg, smi)
    phase_fixed_profile(hybrid, hcfg)
    del hybrid
    free_memory()
    hybrid_expect = hybrid_mesh_expectations(
        depth_cut(hcfg, HYBRID_MESH_LAYERS))
    free_memory()

    phase_kernels_partial(gen, errs)
    phase_timings_partial(gen, times)
    free_memory()
    from repro_torch.launch import train
    cut = cut_config(cfg)
    log(f"[mesh train] one card, the {MESH_LAYERS}-layer model of phases "
        f"10, 12, 13a, 13b and 15a, phase 8's flags")
    one_cut = train.main(TRAIN_FLAGS, cfg=cut)
    free_memory()
    phase_calibrate(smi)
    seq_launches_run, seq_rep = phase_seq_train(cut, smi, one_cut.losses)
    free_memory()
    scfg = depth_cut(cfg, MESH_SERVE_LAYERS)
    mesh_launches_run, mesh_fixed = phase_mesh_serve(scfg, smi, mesh_expect,
                                                     hybrid_expect)
    free_memory()
    _, mesh_train_rep = phase_mesh_train(cut, smi, one_cut)
    phase_mesh_data(cut, smi, one_cut)
    phase_overlap_train(cut, smi, one_cut, mesh_train_rep)
    phase_overlap_seq(cut, smi, one_cut, seq_rep)
    free_memory()
    phase_overlap_serve(scfg, smi, mesh_expect, mesh_fixed)
    free_memory()
    phase_hybrid_mesh(depth_cut(hcfg, HYBRID_MESH_LAYERS), smi,
                      hybrid_expect)
    del hybrid_expect
    free_memory()
    phase_long_context(hcfg, smi)
    free_memory()
    phase_zero_train(cut, smi, one_cut)
    phase_ckpt_resume(smi)
    free_memory()
    log("[dots] remat 'dots' through make_train_step, phase 8's run")
    phase_dots_train(cfg, smi, train_res, train_launches)
    free_memory()
    phase_zero3_train(cfg, smi)
    phase_calib_steps(smi)
    phase_profile_train(cut, smi)

    # launches: each kernel's count on the path this repo ported it for
    # (serving: K3, K5; training: K1, K2; fixed-batch hybrid serving: K6;
    # seq-parallel training, rank 0: K4); the log has every path's counts
    launches = dict(serve_launches, **{
        k: train_launches[k] for k in ("block_matmul", "flash_attention",
                                       "flash_attention_bwd")},
        selective_scan=fixed_launches_run["selective_scan"],
        **{k: seq_launches_run[k] for k in ("partial_attention",
                                            "partial_attention_bwd")},
        **{k: mesh_launches_run[k] for k in ("rmsnorm_stats",
                                             "rmsnorm_apply")})
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:19",
                "rmsnorm_stats": "src/repro/kernels/rmsnorm.py:19",
                "rmsnorm_apply": "src/repro/kernels/rmsnorm.py:19",
                "paged_attention": "src/repro/kernels/flash_attention.py:240",
                "block_matmul": "src/repro/kernels/block_matmul.py:34",
                "flash_attention": "src/repro/kernels/flash_attention.py:297",
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:297",
                "selective_scan": "src/repro/kernels/selective_scan.py:45",
                "partial_attention":
                    "src/repro/kernels/flash_attention.py:127",
                "partial_attention_bwd":
                    "src/repro/kernels/flash_attention.py:127"}
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"rmsnorm": csrc + "rmsnorm.cu",
               "rmsnorm_stats": csrc + "rmsnorm.cu",
               "rmsnorm_apply": csrc + "rmsnorm.cu",
               "paged_attention": csrc + "paged_attention.cu",
               "block_matmul": csrc + "block_matmul.cu",
               "flash_attention": csrc + "flash_attention.cu",
               "flash_attention_bwd": csrc + "flash_attention.cu",
               "selective_scan": csrc + "selective_scan.cu",
               "partial_attention": csrc + "partial_attention.cu",
               "partial_attention_bwd": csrc + "partial_attention.cu"}
    kernels = [dict(name=k, route="cuda", source=sources[k],
                    replaces=replaces[k], launches=launches[k],
                    max_abs_err=errs[k], **times[k])
               for k in replaces]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--mesh-train-worker"]:
        sys.exit(mesh_train_worker(Path(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--serve-worker"]:
        sys.exit(serve_worker(int(sys.argv[2]), sys.argv[3:]))
    if sys.argv[1:2] == ["--long-worker"]:
        sys.exit(long_worker(Path(sys.argv[2])))
    sys.exit(main())
