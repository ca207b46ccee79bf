"""K6's backward CUDA source run on the CPU.

``csrc/selective_scan.cu`` is compiled with g++ against the CPU stand-ins
of ``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn; the
warp shuffles of the dB/dC reduction pass through the emulator's per-warp
buffer) and launched through its C interface on CPU tensors: the forward
with its chunk states (``selective_scan_states_launch``), then the
backward (``selective_scan_bwd_launch``: each chunk's walk from zero, the
carry of dL/ds down the chunks, each chunk's walk from its carry, and the
sum of the partials). Every gradient (dx, ddt, dA, dB, dC and, from an
s0, ds0) is held to ``selective_scan_bwd_plain`` and, through ``jax.vjp``
of the JAX package's ``ssm_scan_chunked``, to the reference, in float32
and bfloat16, on the 16-byte path (B and C at Jamba's column offsets) and
the element-by-element one (row stride 5 + 2N, d 100 or 68), with and
without s0 and a cotangent of the final state, at T of one chunk, of a
ragged second chunk and of three whole chunks (the final state's
cotangent and ds0 carried across all three), and at T not a multiple of
32. The forward's chunk states are the plain scan's states at each
chunk's start, and asking for them leaves y and the final state's bits as
they were. Outputs and the workspace (the carries among it) start as NaN,
so an element no thread wrote shows; two calls give the same bits (the
cases with a final-state cotangent), and so do the two load paths.

Tolerances: ``chip_smoke.py``'s SCAN_TOL, relative, and as an absolute
bound that share of each gradient's largest entry (the gradients sum
hundreds of terms of both signs, so an entry near zero carries the
rounding of the large ones).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cuda_emu import compile_source
from repro.layers.mamba import ssm_scan_chunked
from repro_torch.kernels.selective_scan import (
    CHUNK, bind, selective_scan_bwd_plain, selective_scan_plain)

F32, BF16 = torch.float32, torch.bfloat16
DTYPE = {F32: 0, BF16: 1}
SCAN_TOL = {F32: 2e-4, BF16: 2e-2}  # chip_smoke.py's
N = 16
NAMES = ("dx", "ddt", "dA", "dB", "dC", "ds0")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return bind(compile_source("selective_scan",
                               tmp_path_factory.mktemp("k6_bwd_emulated")))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_args(x, dt, A, B, C):
    return (x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(),
            dt.stride(0), dt.stride(1), A.data_ptr(), B.data_ptr(),
            B.stride(0), B.stride(1), C.data_ptr(), C.stride(0),
            C.stride(1))


def nan(shape, dtype=F32):
    return torch.full(shape, math.nan, dtype=dtype)


def forward(lib, x, dt, A, B, C, s0, states=True):
    """The forward's (y, final state, chunk states or None)."""
    Bt, T, d = x.shape
    y, s = nan((Bt, T, d), x.dtype), nan((Bt, d, N))
    chunks = nan((Bt, -(-T // CHUNK), d, N)) if states else None
    assert lib.selective_scan_states_launch(
        *_fwd_args(x, dt, A, B, C), _ptr(s0), y.data_ptr(), s.data_ptr(),
        _ptr(chunks), Bt, T, d, N, DTYPE[x.dtype], None) == 0
    return y, s, chunks


def backward(lib, x, dt, A, B, C, s0, chunks, dy, gT):
    Bt, T, d = x.shape
    dx, ddt = nan((Bt, T, d), x.dtype), nan((Bt, T, d))
    dA, dB, dC = nan((d, N)), nan((Bt, T, N), x.dtype), nan((Bt, T, N),
                                                             x.dtype)
    ds0 = None if s0 is None else nan((Bt, d, N))
    ws = nan((max(1, lib.selective_scan_bwd_workspace(Bt, T, d, N)),))
    assert lib.selective_scan_bwd_launch(
        *_fwd_args(x, dt, A, B, C), chunks.data_ptr(), dy.data_ptr(),
        dy.stride(0), dy.stride(1), _ptr(gT), dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), _ptr(ds0),
        ws.data_ptr(), Bt, T, d, N, DTYPE[x.dtype], None) == 0
    return dx, ddt, dA, dB, dC, ds0


def values(seed, Bt, T, d, with_s0, with_gT):
    """fp32 numpy values as the Mamba layer makes them (dt a softplus, A
    = -exp(.)), the cotangent dy, and the final state's where asked."""
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, T, d)
    dt = np.log1p(np.exp(rng.randn(Bt, T, d) - 2.0))
    A = -np.exp(0.5 * rng.randn(d, N))
    bc = rng.randn(Bt, T, 2 * N)
    s0 = 0.5 * rng.randn(Bt, d, N) if with_s0 else None
    dy = rng.randn(Bt, T, d)
    gT = rng.randn(Bt, d, N) if with_gT else None
    return x, dt, A, bc, s0, dy, gT


def layout(vals, dtype, lead, x_pad=0):
    """Torch tensors: B and C column views of a (Bt, T, lead + 2N) buffer
    at offset ``lead`` (256: Jamba's dt_rank, 16-byte rows; 5: off 16
    bytes), x, dt and dy views of rows ``x_pad`` wider."""
    x, dt, A, bc, s0, dy, gT = vals
    Bt, T, d = x.shape

    def rows(v, tdtype):
        buf = torch.zeros((Bt, T, d + x_pad), dtype=tdtype)
        buf[..., :d] = torch.tensor(v, dtype=F32).to(tdtype)
        return buf[..., :d]
    xdbc = torch.zeros((Bt, T, lead + 2 * N), dtype=dtype)
    xdbc[..., lead:] = torch.tensor(bc, dtype=F32).to(dtype)
    opt = (lambda v: None if v is None else torch.tensor(v, dtype=F32))
    return dict(x=rows(x, dtype), dt=rows(dt, F32),
                A=torch.tensor(A, dtype=F32),
                B=xdbc[..., lead:lead + N], C=xdbc[..., lead + N:],
                s0=opt(s0), dy=rows(dy, dtype), gT=opt(gT))


def _close(got, want, tol, what):
    got, want = got.float(), want.float()
    assert not torch.isnan(got).any(), what
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * max(1.0, float(want.abs().max())),
                               msg=what)


def _jax_grads(t):
    """The reference's gradients: jax.vjp of ssm_scan_chunked (chunk 128,
    so one associative scan over T < 128) on the same values in float32."""
    f = {k: None if v is None else jnp.asarray(v.float().numpy())
         for k, v in t.items()}
    s0 = f["s0"] if f["s0"] is not None else jnp.zeros(
        (f["x"].shape[0], f["x"].shape[2], N), jnp.float32)
    _, pull = jax.vjp(lambda x, dt, A, B, C, s0: ssm_scan_chunked(
        x, dt, A, B, C, s0=s0), f["x"], f["dt"], f["A"], f["B"], f["C"], s0)
    gT = f["gT"] if f["gT"] is not None else jnp.zeros_like(s0)
    return [torch.from_numpy(np.array(g)) for g in pull((f["dy"], gT))]


# (Bt, T, d, dtype, lead, with_s0, with_gT, x_pad): the 16-byte path
# (lead 256) and the scalar one (lead 5); T of one whole chunk, over two
# and three 32-step chunks with a ragged last one, of three whole chunks,
# and inside one sub-chunk; d not a multiple of the block's 64 channels;
# x, dt and dy through a row stride wider than d
CASES = {
    "f32 16-byte T 70 d 64": (1, 70, 64, F32, 256, False, False, 0),
    "f32 16-byte T 45 d 96 s0 gT": (1, 45, 96, F32, 256, True, True, 0),
    "bf16 16-byte T 40 d 64 s0": (1, 40, 64, BF16, 256, True, False, 0),
    "f32 16-byte T 33 strided gT": (1, 33, 64, F32, 256, False, True, 8),
    "bf16 16-byte T 40 d 64 strided": (1, 40, 64, BF16, 256, False, False,
                                       8),
    "f32 scalar T 37 d 100 s0": (1, 37, 100, F32, 5, True, False, 0),
    "bf16 scalar T 33 d 68 gT": (1, 33, 68, BF16, 5, False, True, 0),
    "f32 16-byte T 5 d 64 Bt 2 s0": (2, 5, 64, F32, 256, True, False, 0),
    "f32 16-byte T 32 d 64 gT": (1, 32, 64, F32, 256, False, True, 0),
    "f32 16-byte T 96 d 64 s0 gT": (1, 96, 64, F32, 256, True, True, 0),
    "bf16 scalar T 96 d 64 s0 gT": (1, 96, 64, BF16, 5, True, True, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_bwd_source_matches_plain_and_jax_on_the_cpu(lib, case):
    Bt, T, d, dtype, lead, with_s0, with_gT, x_pad = CASES[case]
    t = layout(values(len(case), Bt, T, d, with_s0, with_gT), dtype, lead,
               x_pad)
    ins = [t[k] for k in ("x", "dt", "A", "B", "C")]
    y, s, chunks = forward(lib, *ins, t["s0"])
    got = backward(lib, *ins, t["s0"], chunks, t["dy"], t["gT"])
    want = selective_scan_bwd_plain(*ins, t["dy"], t["s0"], t["gT"])
    tol = SCAN_TOL[dtype]
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _close(g, w, tol, f"{name} against the plain backward")
    for name, g, w in zip(NAMES, got, _jax_grads(t)):
        if g is not None:
            _close(g, w, tol, f"{name} against jax.vjp")
    if with_gT:
        again = backward(lib, *ins, t["s0"], chunks, t["dy"], t["gT"])
        for name, g, h in zip(NAMES, got, again):
            assert g is None or torch.equal(g, h), name


@pytest.mark.parametrize("case", ["f32 16-byte T 70 d 64",
                                  "bf16 16-byte T 40 d 64 s0",
                                  "f32 scalar T 37 d 100 s0"])
def test_k6_chunk_states_are_the_scan_state_and_leave_y_alone(lib, case):
    """The forward's chunk states are the plain scan's states before each
    32-step chunk (s0, or zeros, first); y and the final state are those of
    the launch without them, bit for bit."""
    Bt, T, d, dtype, lead, with_s0, with_gT, x_pad = CASES[case]
    t = layout(values(len(case), Bt, T, d, with_s0, with_gT), dtype, lead,
               x_pad)
    ins = [t[k] for k in ("x", "dt", "A", "B", "C")]
    y, s, chunks = forward(lib, *ins, t["s0"])
    y0, s0, none = forward(lib, *ins, t["s0"], states=False)
    assert none is None and torch.equal(y, y0) and torch.equal(s, s0)
    assert chunks.shape == (Bt, -(-T // CHUNK), d, N)
    for k in range(chunks.shape[1]):
        cut = [v[:, :k * CHUNK] for v in ins[:2]] + [ins[2]] + [
            v[:, :k * CHUNK] for v in ins[3:]]
        _, want = selective_scan_plain(*cut, t["s0"])
        _close(chunks[:, k], want, SCAN_TOL[F32], f"chunk {k}")


@pytest.mark.parametrize("dtype,T,with_s0", [(F32, 45, True),
                                             (BF16, 40, False)])
def test_k6_bwd_source_paths_give_the_same_bits(lib, dtype, T, with_s0):
    """The same values through the 16-byte path (B and C at Jamba's
    aligned offsets) and the scalar path (row stride 5 + 2N) give the same
    gradients, bit for bit."""
    vals = values(T, 1, T, 64, with_s0, True)
    outs = []
    for lead in (256, 5):
        t = layout(vals, dtype, lead)
        ins = [t[k] for k in ("x", "dt", "A", "B", "C")]
        _, _, chunks = forward(lib, *ins, t["s0"])
        outs.append(backward(lib, *ins, t["s0"], chunks, t["dy"], t["gT"]))
    for name, g, h in zip(NAMES, *outs):
        assert (g is None and h is None) or torch.equal(g, h), name
