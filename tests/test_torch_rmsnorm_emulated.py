"""K3's CUDA source run on the CPU.

``csrc/rmsnorm.cu`` is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through its C interface on CPU tensors. Each of its three layouts
(a block per row at d 2048 and 4096, a warp per row at d 64 and 128, the
strided loop at d 120 and on rows off 16 bytes) is held to the plain
version with ``chip_smoke.py``'s RMS_TOL, and to the JAX package's Pallas
kernel (interpret mode) where ``full_dim`` is the row's width; a row gives
the same bits alone as among 1,024 rows. The stats pass (each row's fp32
sum of squares) and the apply pass (the scaling by a sum given from
outside), which run an x-sharded row around a psum, are held to their
plain versions at the mesh path's local widths (128, 1024) and at 120, in
both dtypes and on rows off 16 bytes; stats then apply on a whole row
gives the single pass's bits. The output starts as NaN, so an element no
thread wrote shows. This checks the kernel's indexing and
arithmetic, not its speed or its behaviour under the real compiler; the
card runs the same source in ``tests/test_torch_gpu.py`` and
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
from repro_torch.kernels.rmsnorm import (rmsnorm_apply_plain, rmsnorm_plain,
                                         rmsnorm_stats_plain)

F32, BF16 = torch.float32, torch.bfloat16
DTYPE = {F32: 0, BF16: 1}
RMS_TOL = {F32: 2e-4, BF16: 2e-2}  # chip_smoke.py's, test_kernels.py's


@pytest.fixture(scope="module")
def rms(tmp_path_factory):
    lib = compile_source("rmsnorm", tmp_path_factory.mktemp("k3_emulated"))
    fn = lib.rmsnorm_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, p]
    fn.restype = ctypes.c_int

    stats = lib.rmsnorm_stats_launch
    stats.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
    stats.restype = ctypes.c_int
    apply = lib.rmsnorm_apply_launch
    apply.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_int, p]
    apply.restype = ctypes.c_int

    def run(x, g, full_dim=None):
        d = x.shape[-1]
        out = torch.full_like(x, math.nan)
        assert fn(x.data_ptr(), g.data_ptr(), out.data_ptr(),
                  x.numel() // d, d, float(full_dim or d), 1e-6,
                  DTYPE[x.dtype], None) == 0
        return out

    def run_stats(x):
        d = x.shape[-1]
        ss = torch.full(x.shape[:-1], math.nan)
        assert stats(x.data_ptr(), ss.data_ptr(), x.numel() // d, d,
                     DTYPE[x.dtype], None) == 0
        return ss

    def run_apply(x, g, ss, full_dim):
        d = x.shape[-1]
        out = torch.full_like(x, math.nan)
        assert apply(x.data_ptr(), g.data_ptr(), ss.data_ptr(),
                     out.data_ptr(), x.numel() // d, d, float(full_dim),
                     1e-6, DTYPE[x.dtype], None) == 0
        return out
    run.stats, run.apply = run_stats, run_apply
    return run


def inputs(seed, rows, d, dtype, offset=0):
    """x (rows, d) and gamma from numpy; ``offset`` elements in front of x
    in its buffer move its rows off 16 bytes (x stays contiguous)."""
    rng = np.random.RandomState(seed)
    buf = torch.from_numpy(rng.randn(rows * d + offset)).to(dtype)
    g = torch.from_numpy(1 + 0.1 * rng.randn(d)).to(dtype)
    return buf[offset:].view(rows, d), g


# (rows, d, dtype, full_dim, offset): every layout in both dtypes, full_dim
# twice the row (an x-sharded row), rows not a multiple of the 8 rows of a
# warp-layout block, and rows off 16 bytes
CASES = {
    "block d 2048 f32": (5, 2048, F32, None, 0),
    "block d 4096 bf16": (3, 4096, BF16, None, 0),
    "block d 2048 bf16 full_dim 4096": (2, 2048, BF16, 4096, 0),
    "block d 4096 f32 full_dim 8192": (2, 4096, F32, 8192, 0),
    "warp d 128 f32": (19, 128, F32, None, 0),
    "warp d 128 bf16": (9, 128, BF16, None, 0),
    "warp d 64 f32 full_dim 128": (11, 64, F32, 128, 0),
    "warp d 64 bf16": (8, 64, BF16, None, 0),
    "loop d 120 f32": (10, 120, F32, None, 0),
    "loop d 120 bf16 full_dim 240": (7, 120, BF16, 240, 0),
    "loop d 2048 f32 off 16 bytes": (3, 2048, F32, None, 1),
    "loop d 128 bf16 off 16 bytes": (9, 128, BF16, None, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_source_matches_plain_and_pallas_on_the_cpu(rms, case):
    rows, d, dtype, full_dim, offset = CASES[case]
    x, g = inputs(len(case), rows, d, dtype, offset)
    got = rms(x, g, full_dim)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got, rmsnorm_plain(x, g, full_dim=full_dim),
                               rtol=tol, atol=tol)
    if full_dim is None:
        want = jops.rmsnorm(jnp.asarray(x.float().numpy()),
                            jnp.asarray(g.float().numpy()))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)
    assert torch.equal(rms(x, g, full_dim), got)


@pytest.mark.parametrize("d,dtype", [(2048, F32), (4096, BF16), (128, F32),
                                     (128, BF16), (64, F32), (120, F32)])
def test_k3_source_row_bits_do_not_depend_on_the_row_count(rms, d, dtype):
    """A row normed alone (decode) gives the bits it gets among 1,024 rows
    (prefill, training), taken as a view of the batch or as a copy."""
    x, g = inputs(d, 1024, d, dtype)
    full = rms(x, g)
    for i in (0, 1, 517, 1023):
        assert torch.equal(rms(x[i:i + 1], g)[0], full[i])
        assert torch.equal(rms(x[i].clone(), g), full[i])


# (rows, d, dtype, offset) of the stats and apply passes: the local widths
# of the x-sharded mesh path (1024 at full width, 128 at the smoke size),
# the loop layout's 120, both dtypes, rows off 16 bytes
SPLIT_CASES = {
    "block d 1024 f32": (5, 1024, F32, 0),
    "block d 1024 bf16": (3, 1024, BF16, 0),
    "warp d 128 f32": (19, 128, F32, 0),
    "warp d 128 bf16": (9, 128, BF16, 0),
    "loop d 120 f32": (10, 120, F32, 0),
    "loop d 120 bf16": (7, 120, BF16, 0),
    "loop d 1024 f32 off 16 bytes": (3, 1024, F32, 1),
    "loop d 128 bf16 off 16 bytes": (9, 128, BF16, 3),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_k3_stats_and_apply_passes_match_plain_on_the_cpu(rms, case):
    """The stats pass against the plain sum; the apply pass, given a sum
    over the whole row (here the local sum plus another shard's, as the
    psum over x hands it), against the plain scale; and stats then apply
    with the row's own sum gives the single pass's bits."""
    rows, d, dtype, offset = SPLIT_CASES[case]
    x, g = inputs(len(case), rows, d, dtype, offset)
    ss = rms.stats(x)
    torch.testing.assert_close(ss, rmsnorm_stats_plain(x), rtol=1e-5,
                               atol=1e-5)
    other = torch.from_numpy(np.random.RandomState(rows).rand(rows) * d
                             ).float()
    total = ss + other
    got = rms.apply(x, g, total, 2 * d)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(
        got, rmsnorm_apply_plain(x, g, total, full_dim=2 * d), rtol=tol,
        atol=tol)
    assert torch.equal(rms.apply(x, g, ss, d), rms(x, g))
    assert torch.equal(rms.stats(x), ss)
