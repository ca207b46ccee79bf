"""K6's CUDA source run on the CPU.

``csrc/selective_scan.cu`` is compiled with g++ against the CPU stand-ins
of ``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through its C interface on CPU tensors. Both of its load paths
(16-byte copies where every row is 16-byte aligned, as the Mamba layer's
B and C column views at offsets 256 and 256 + N are; element by element
for anything else, such as the row stride 5 + 2N of the GPU tests, or d
100 and 130) are held to the plain version with ``chip_smoke.py``'s
SCAN_TOL, and, from a zero state, to the JAX package's Pallas kernel in
interpret mode; the two paths give the same bits for the same values. The
outputs start as NaN, so an element no thread wrote shows. This checks the
kernel's indexing and arithmetic (its exp is the C library's exp2f here,
MUFU.EX2 on the card), not its speed or its behaviour under the real
compiler; the card runs the same source in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_emu import compile_source
from repro.kernels import ops as jops
from repro_torch.kernels.selective_scan import selective_scan_plain

F32, BF16 = torch.float32, torch.bfloat16
DTYPE = {F32: 0, BF16: 1}
SCAN_TOL = {F32: 2e-4, BF16: 2e-2}  # chip_smoke.py's
N = 16


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    lib = compile_source("selective_scan",
                         tmp_path_factory.mktemp("k6_emulated"))
    fn = lib.selective_scan_states_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, ll, p, ll, ll, p, p, ll, ll, p, ll, ll, p, p, p,
                   p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int

    def run(x, dt, A, B, C, s0=None):
        Bt, T, d = x.shape
        y = torch.full((Bt, T, d), math.nan, dtype=x.dtype)
        s = torch.full((Bt, d, N), math.nan)
        assert fn(x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(),
                  dt.stride(0), dt.stride(1), A.data_ptr(), B.data_ptr(),
                  B.stride(0), B.stride(1), C.data_ptr(), C.stride(0),
                  C.stride(1), None if s0 is None else s0.data_ptr(),
                  y.data_ptr(), s.data_ptr(), None, Bt, T, d, N,
                  DTYPE[x.dtype], None) == 0
        return y, s
    return run


def values(seed, Bt, T, d, with_s0):
    """fp32 numpy values as the Mamba layer makes them: dt a softplus, A =
    -exp(.), B and C of the size of x's rows' projections."""
    rng = np.random.RandomState(seed)
    x = rng.randn(Bt, T, d)
    dt = np.log1p(np.exp(rng.randn(Bt, T, d) - 2.0))
    A = -np.exp(0.5 * rng.randn(d, N))
    bc = rng.randn(Bt, T, 2 * N)
    s0 = 0.5 * rng.randn(Bt, d, N) if with_s0 else None
    return x, dt, A, bc, s0


def layout(vals, dtype, lead, x_pad=0):
    """Torch tensors: B and C column views of a (Bt, T, lead + 2N) buffer
    at offset ``lead`` (256: Jamba's dt_rank, every row 16-byte aligned; 5:
    off 16 bytes), x and dt views of rows ``x_pad`` wider."""
    x, dt, A, bc, s0 = vals
    Bt, T, d = x.shape

    def rows(v, tdtype):
        buf = torch.zeros((Bt, T, d + x_pad), dtype=tdtype)
        buf[..., :d] = torch.tensor(v, dtype=torch.float32).to(tdtype)
        return buf[..., :d]
    xdbc = torch.zeros((Bt, T, lead + 2 * N), dtype=dtype)
    xdbc[..., lead:] = torch.tensor(bc, dtype=torch.float32).to(dtype)
    return (rows(x, dtype), rows(dt, F32), torch.tensor(A, dtype=F32),
            xdbc[..., lead:lead + N], xdbc[..., lead + N:],
            None if s0 is None else torch.tensor(s0, dtype=F32))


# (Bt, T, d, dtype, lead, with_s0, x_pad): the 16-byte path (lead 256) and
# the scalar one (lead 5; d 130 in bf16 is off 16 bytes too), T over two
# and three 32-step chunks with a ragged last one, d not a multiple of the
# block's 64 channels, decode (T 1 from s0), T 0, and x and dt through a
# row stride wider than d
CASES = {
    "f32 16-byte T 70 d 128": (2, 70, 128, F32, 256, False, 0),
    "bf16 16-byte T 70 d 128 s0": (2, 70, 128, BF16, 256, True, 0),
    "f32 16-byte T 35 d 96 s0": (2, 35, 96, F32, 256, True, 0),
    "f32 16-byte T 64 x and dt strided": (2, 64, 64, F32, 256, False, 8),
    "bf16 16-byte T 40 d 64 x and dt strided": (1, 40, 64, BF16, 256,
                                                False, 8),
    "f32 scalar T 40 d 100 s0": (2, 40, 100, F32, 5, True, 0),
    "bf16 scalar T 33 d 130": (1, 33, 130, BF16, 5, False, 0),
    "f32 scalar T 50 d 100": (1, 50, 100, F32, 5, False, 0),
    "f32 16-byte decode T 1 d 192 s0": (4, 1, 192, F32, 256, True, 0),
    "bf16 16-byte decode T 1 d 128 s0": (2, 1, 128, BF16, 256, True, 0),
    "bf16 scalar decode T 1 d 130 s0": (3, 1, 130, BF16, 5, True, 0),
    "f32 T 0 s0": (2, 0, 64, F32, 256, True, 0),
    "bf16 scalar T 0 d 100": (1, 0, 100, BF16, 5, False, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_source_matches_plain_and_pallas_on_the_cpu(scan, case):
    Bt, T, d, dtype, lead, with_s0, x_pad = CASES[case]
    args = layout(values(len(case), Bt, T, d, with_s0), dtype, lead, x_pad)
    y, s = scan(*args)
    wy, ws = selective_scan_plain(*args)
    assert y.dtype == dtype and y.shape == (Bt, T, d)
    torch.testing.assert_close(y, wy, rtol=SCAN_TOL[dtype],
                               atol=SCAN_TOL[dtype])
    torch.testing.assert_close(s, ws, rtol=SCAN_TOL[F32], atol=SCAN_TOL[F32])
    if not with_s0 and T > 0:
        x, dt, A, B, C, _ = (a.float().numpy() if a is not None else None
                             for a in args)
        want = jops.selective_scan(*(jnp.asarray(v) for v in (x, dt, A, B,
                                                              C)))
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want),
                                   rtol=SCAN_TOL[dtype],
                                   atol=SCAN_TOL[dtype])
    y2, s2 = scan(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("T,with_s0", [(45, True), (1, True), (70, False)])
def test_k6_source_paths_give_the_same_bits(scan, dtype, T, with_s0):
    """The same values through the 16-byte path (B and C at Jamba's
    aligned offsets) and the scalar path (row stride 5 + 2N) give the same
    y and final state, bit for bit."""
    vals = values(T, 2, T, 64, with_s0)
    y16, s16 = scan(*layout(vals, dtype, 256))
    y1, s1 = scan(*layout(vals, dtype, 5))
    assert torch.equal(y16, y1) and torch.equal(s16, s1)
