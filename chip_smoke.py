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
     K3 RMSNorm, K5 paged attention (chunked == one-shot bitwise; also
     over Jamba's dense decode cache seen as 32-row pages), K1 block
     matmul in the three layouts of training, at the Mamba layer's widths
     and in the middle band of M (each run twice: the same bits), K2
     flash attention forward and backward (also at Jamba's
     prefill shape; the forward run twice gives the same bits, as
     rematerialization needs), K6 selective scan at the prefill and
     decode shapes (y and final state; two runs give the same bits);
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
     shapes, beside bfloat16 ``torch.matmul``; K5 at serving's decode and
     chunked-prefill shapes and at Jamba's dense decode (each also held
     to its plain version), K2's forward also at Jamba's prefill shape;
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
     bits), K4's times; then ``launch/train.py --mesh 1,1,1,1,2`` as two
     gloo ranks sharing the card under ``torch.distributed.run`` (qwen3-1.7b
     at full width and depth, the flags, seed and data of phase 8): losses
     within 1e-3 of phase 8's, both ranks' parameters bitwise equal, each
     kernel's launches per rank exactly the code's per microbatch;
 11. a summary: one ``{"kernels": [...]}`` line, the card's name and power
     limit, and as the last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
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
# K6 against its sequential plain version: y and the state of f32 within
# the 2e-4 of tests/test_kernels.py (exp and the FMA contractions round
# otherwise than PyTorch's kernels); bf16 y rounds once more on the way out
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# K6 at the fixed-serving path's shapes: (name, Bt, T, d, N, with s0)
SCAN_SHAPES = [("prefill", 4, 512, 8192, 16, False),
               ("decode", 4, 1, 8192, 16, True)]
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
                  ATTN_JAMBA}
# context parallelism: the seq axis, and K4 at its path's shape, per rank
# and microbatch (B 2, C = 512 / p queries, p gathered blocks of C keys,
# 16/8 heads, hd 128), causal and with a window
SEQ_P = 2
PARTIAL_MAIN = (2, 512 // SEQ_P, 16, 8, 128, SEQ_P)
PARTIAL_WINDOWS = (0, 128)
SEQ_FLAGS = TRAIN_FLAGS + ["--mesh", f"1,1,1,1,{SEQ_P}", "--backend", "gloo"]
SEQ_TIMEOUT_S = 600
# the seq run's losses against phase 8's, absolute: the reference holds
# seq-parallel against unsharded training to the same 1e-3
# (tests/test_ring_attention.py::test_train_loss_parity_seq_vs_unsharded)
SEQ_LOSS_TOL = 1e-3
# K5 over the dense decode cache of Jamba's attention layers: (batch, nq,
# nkv, hd) and each row's keys after the step (prompt 512 + up to 32 new)
DENSE_DECODE = (4, 32, 8, 128)
DENSE_CTX = [513, 527, 538, 544]


def log(msg: str) -> None:
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
             library_ms=graph_ms(library, iters), **bound(nbytes, n_ops,
                                                          dtype))
    warm = min(20, eager_iters)
    eager = dict(ms=cuda_ms(kernel, eager_iters, warm),
                 plain_ms=cuda_ms(plain, eager_iters, warm),
                 library_ms=cuda_ms(library, eager_iters, warm))
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
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    a = (rand(K, M).t() if layout == "TN" else rand(M, K + 32)[:, :K]
         if layout == "SN" else rand(M, K))
    b = rand(N, K).t() if layout == "NT" else rand(K, N)
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
    errs = dict.fromkeys(("rmsnorm", "paged_attention", "block_matmul",
                          "flash_attention", "flash_attention_bwd",
                          "selective_scan", "partial_attention",
                          "partial_attention_bwd"), 0.0)
    log("[kernels] K3 rmsnorm vs plain")
    R, T, nq = 8, 32, 16
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in ((R * T, 2048), (R * T * nq, 128), (R, 2048),
                        (R * nq, 128), (R * 8, 128)):
            x = torch.randn((rows, d), generator=gen, device="cuda"
                            ).to(dtype)
            g = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
                 ).to(dtype)
            e = check_close(f"{str(dtype)[6:]} ({rows}, {d})",
                            rmsnorm_kernel(x, g), rmsnorm_plain(x, g),
                            RMS_TOL[dtype])
            if dtype == torch.float32:
                errs["rmsnorm"] = max(errs["rmsnorm"], e)
    log("[kernels] K5 paged attention vs plain (nq 16, nkv 8, hd 128, "
        "page 16, table width 127)")
    cases = {1: dict(ctx=[0, 1, 17, 40, 100, 160, 33, 250],
                     q_len=[0, 1, 1, 1, 1, 1, 1, 1]),
             32: dict(ctx=[0, 32, 45, 160, 200, 17, 300, 64],
                      q_len=[0, 32, 13, 32, 32, 17, 32, 5])}
    for dtype in (torch.float32, torch.bfloat16):
        for T, c in cases.items():
            q, kp, vp, table, q_pos, q_len = paged_inputs(
                gen, T=T, dtype=dtype, **c)
            kp, vp = kp[0], vp[0]
            got = paged_attention_kernel(q, kp, vp, table, q_pos, q_len)
            want = paged_attention_plain(q, kp, vp, table, q_pos, q_len)
            rows = valid_rows(q_len, T)
            e = check_close(f"{str(dtype)[6:]} T={T}", got, want,
                            PAGED_TOL[dtype], rows)
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
                log(f"  {str(dtype)[6:]} chunked (0-5, 5-17, 17-32) == "
                    f"one-shot: bitwise")
    phase_kernels_dense_decode(gen, errs)
    phase_kernels_train(gen, errs)
    phase_kernels_scan(gen, errs)
    return errs


def phase_kernels_dense_decode(gen, errs):
    """K5 as fixed-batch decode runs it: the dense cache seen as pages of
    DENSE_PAGE rows through the table the attention layer builds."""
    from repro_torch.kernels.flash_attention import (
        paged_attention_kernel, paged_attention_plain)
    from repro_torch.layers.attention import DENSE_PAGE, dense_page_view
    B, nq, nkv, hd = DENSE_DECODE
    S = -(-max(DENSE_CTX) // DENSE_PAGE) * DENSE_PAGE
    log(f"[kernels] K5 over the dense decode cache (B {B}, nq {nq}, nkv "
        f"{nkv}, hd {hd}, {S} rows as pages of {DENSE_PAGE}, keys "
        f"{DENSE_CTX}, T 1)")
    q_pos = torch.tensor(DENSE_CTX, dtype=torch.int32,
                         device="cuda")[:, None] - 1
    q_len = torch.ones((B,), dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        q, kc, vc = rand(B, 1, nq, hd), rand(B, S, nkv, hd), rand(B, S, nkv,
                                                                   hd)
        (kp, table), (vp, _) = dense_page_view(kc), dense_page_view(vc)
        e = check_close(f"{dtype_name(dtype)} dense decode",
                        paged_attention_kernel(q, kp, vp, table, q_pos, q_len),
                        paged_attention_plain(q, kp, vp, table, q_pos, q_len),
                        PAGED_TOL[dtype])
        if dtype == torch.float32:
            errs["paged_attention"] = max(errs["paged_attention"], e)


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
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain
    from repro_torch.layers.attention import DENSE_PAGE, dense_page_view
    f32 = torch.float32
    out = {}
    log("[timings] float32, decode-step shapes, CUDA events: device "
        "time from a replayed CUDA graph / eager calls back to back")
    rms = {}
    for rows, d in ((8, 2048), (8 * 16, 128)):
        x = torch.randn((rows, d), generator=gen, device="cuda")
        g = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        nbytes = 2 * x.numel() * 4 + d * 4
        ops_ = 4 * x.numel()
        t, eager = timings(lambda: rmsnorm_kernel(x, g),
                           lambda: rmsnorm_plain(x, g),
                           lambda: F.rms_norm(x, (d,), g, 1e-6),
                           nbytes, ops_, f32)
        rms[(rows, d)] = t
        log(f"  rmsnorm ({rows}, {d}): " + fmt(t, eager))
    out["rmsnorm"] = rms[(8, 2048)]

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
    B, nq, nkv, hd = DENSE_DECODE
    ctx = max(DENSE_CTX)
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
    phase_timings_train(gen, out)
    log("[timings] float32, K6 at the fixed-serving shapes: device time "
        "from a replayed CUDA graph / eager calls back to back")
    phase_timings_scan(gen, out)
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
    shapes = [(f32, *c) for c in MATMUL_SHAPES] + [
        (torch.bfloat16, *c) for c in MATMUL_SHAPES
        if c[0] in MATMUL_BF16_TIMED]
    for dtype, name, M, K, N, layout in shapes:
        a, b = matmul_inputs(gen, M, K, N, layout, dtype)
        heavy = N > 100_000 and M > 64
        elt = a.element_size()
        t, eager = timings(lambda: block_matmul_kernel(a, b),
                           lambda: block_matmul_plain(a, b),
                           lambda: torch.matmul(a, b),
                           elt * (M * K + K * N + M * N), 2 * M * N * K,
                           dtype, iters=5 if heavy else 50,
                           eager_iters=5 if heavy else 100)
        log(f"  block_matmul {dtype_name(dtype)} {name} ({M}, {K}) x ({K}, "
            f"{N}) {layout}: " + fmt(t, eager) + f"; "
            f"{2 * M * N * K / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['bound_ms'] / t['ms']:.3f} of the bound")
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


def phase_timings_scan(gen, out):
    """K6 at the prefill and decode shapes. No PyTorch call computes a
    selective scan: the library column is null. The plain version's 512
    steps make a long graph, so it is replayed fewer times."""
    from repro_torch.kernels.selective_scan import (selective_scan_kernel,
                                                    selective_scan_plain)
    f32 = torch.float32
    for name, Bt, T, d, N, with_s0 in SCAN_SHAPES:
        args = scan_inputs(gen, Bt, T, d, N, f32, with_s0)
        t = dict(ms=graph_ms(lambda: selective_scan_kernel(*args),
                             20 if T > 1 else 100),
                 plain_ms=graph_ms(lambda: selective_scan_plain(*args),
                                   2 if T > 1 else 50),
                 library_ms=None, **bound(*scan_work(Bt, T, d, N, f32,
                                                     with_s0), f32))
        eager = cuda_ms(lambda: selective_scan_kernel(*args), 50, 5)
        log(f"  selective_scan {name} (Bt {Bt}, T {T}, d {d}, N {N}): kernel "
            f"{t['ms'] * 1e3:.2f}/{eager * 1e3:.2f} us (device/eager), plain "
            f"{t['plain_ms'] * 1e3:.2f} us (device), no library call, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
        out.setdefault("selective_scan", t)


def bound(nbytes, n_ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def fmt(t, eager):
    us = {k: f"{t[k] * 1e3:.2f}/{eager[k] * 1e3:.2f}" for k in eager}
    return (f"kernel {us['ms']} us, plain {us['plain_ms']} us, library "
            f"{us['library_ms']} us (device/eager), bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")


KERNEL_GROUPS = (("sgemm_tile_kernel", "K1 block_matmul"),
                 ("gemv_n_kernel", "K1 block_matmul"),
                 ("gemv_k_kernel", "K1 block_matmul"),
                 ("split_sum_kernel", "K1 block_matmul"),
                 ("flash_fwd_kernel", "K2 flash_attention forward"),
                 ("flash_bwd", "K2 flash_attention backward"),
                 ("rmsnorm_kernel", "K3 rmsnorm"),
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
    L = cfg.n_layers
    # per microbatch: K1 = forward 7L + 1 (tied head), remat recompute 7L,
    # backward 2 (dX, dW) x (7L + 1); K2 forward + recompute 2L, backward
    # L; K3 = 4L + 1 forward (norm1, norm2, q/k-norm; final) + 4L recompute
    per_mb = {"block_matmul": 28 * L + 3, "flash_attention": 2 * L,
              "flash_attention_bwd": L, "rmsnorm": 8 * L + 1,
              "paged_attention": 0, "paged_attention_combine": 0,
              "selective_scan": 0, "partial_attention": 0,
              "partial_attention_bwd": 0}
    args = train.build_parser().parse_args(TRAIN_FLAGS)
    check_launches(launches, per_mb, args.steps * args.overdecompose,
                   "microbatch")
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
    return launches, res.losses


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
    all three versions (the plain and library backwards are autograd's)."""
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
    log(f"[timings] K4 backward, chain of {p} blocks (eager): kernel "
        f"{spread(r['ms'])}, plain {spread(r['plain_ms'])}, {SDPA_NAME} "
        f"backward {spread(r['library_ms'])}; bound "
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


def phase_seq_train(cfg, smi, losses_one_card):
    """``launch/train.py`` on a seq axis of 2: two gloo ranks on this card,
    started by torch.distributed.run, each holding the whole model and
    half of every sequence."""
    from repro_torch.launch import train
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(SEQ_P), "-m", "repro_torch.launch.train",
           *SEQ_FLAGS]
    log(f"[seq train] python -m torch.distributed.run --standalone "
        f"--nproc-per-node {SEQ_P} -m repro_torch.launch.train "
        f"{' '.join(SEQ_FLAGS)}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [x for x in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if x]))
    t0 = time.time()
    # a session of its own, so that a timeout stops the launcher and both
    # ranks together
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SEQ_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"seq-parallel training ran past "
                             f"{SEQ_TIMEOUT_S} s")
    lines = out.strip().splitlines()
    for ln in lines:
        if not ln.startswith('{"train"'):
            log(f"  | {ln}")
    if proc.returncode:
        log(err[-6000:])
        raise AssertionError(f"seq-parallel training exited with "
                             f"{proc.returncode}")
    rep = json.loads([ln for ln in lines
                      if ln.startswith('{"train"')][-1])["train"]
    log(f"  {time.time() - t0:.1f}s with start-up; losses {rep['losses']}, "
        f"one card (phase 8) {losses_one_card}")
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
    return rep["ranks"][0]["launches"]


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
    times = phase_timings(gen, cfg.n_layers)
    free_memory()
    phase_train_parity(cfg)
    free_memory()
    train_launches, train_losses = phase_train(cfg, smi)
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

    phase_kernels_partial(gen, errs)
    phase_timings_partial(gen, times)
    free_memory()
    seq_launches_run = phase_seq_train(cfg, smi, train_losses)

    # launches: each kernel's count on the path this repo ported it for
    # (serving: K3, K5; training: K1, K2; fixed-batch hybrid serving: K6;
    # seq-parallel training, rank 0: K4); the log has every path's counts
    launches = dict(serve_launches, **{
        k: train_launches[k] for k in ("block_matmul", "flash_attention",
                                       "flash_attention_bwd")},
        selective_scan=fixed_launches_run["selective_scan"],
        **{k: seq_launches_run[k] for k in ("partial_attention",
                                            "partial_attention_bwd")})
    replaces = {"rmsnorm": "src/repro/kernels/rmsnorm.py:19",
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
    sys.exit(main())
