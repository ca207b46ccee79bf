"""K1's CUDA source run on the CPU.

``csrc/block_matmul.cu`` is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through the wrapper's own ``launch_args``, on CPU tensors: every
path (decode with b n- or k-contiguous, the 64-row and the 128-row tile),
16-byte and element-wise loads, ragged edges and K splits, in float32 and
bfloat16, and bfloat16 operands with a float32 output. Each case is held
to the plain version with the card's tolerances (``chip_smoke.py``'s
MATMUL_TOL) and must repeat bitwise. This
checks the kernel's indexing and arithmetic, not its speed or its
behaviour under the real compiler; the card runs the same source in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import ctypes

import pytest
import torch

from cuda_emu import compile_source
from repro_torch.kernels import block_matmul as BM

N_SM = 3          # a small card: the plans split K even at these sizes
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module")
def launcher(tmp_path_factory):
    lib = compile_source("block_matmul",
                         tmp_path_factory.mktemp("k1_emulated"))
    fn = lib.block_matmul_launch
    fn.argtypes = BM.ARGTYPES
    fn.restype = ctypes.c_int

    def run(a, b, out_dtype=None):
        out = torch.empty((a.shape[0], b.shape[1]),
                          dtype=out_dtype or a.dtype)
        args, work = BM.launch_args(a, b, out, N_SM)
        assert fn(*args, None) == 0
        return out, BM.PATHS[args[13]], args[11], args[14]
    return run


def _operands(M, K, N, layout, dtype, shift):
    gen = torch.Generator().manual_seed(M * 7 + K + N)

    def rand(rows, cols):
        x = torch.randn((rows, cols + shift), generator=gen).to(dtype)
        return x[:, shift:]
    a = (rand(K, M).t() if layout == "TN" else
         rand(M, K + 32)[:, :K] if layout == "SN" else rand(M, K))
    b = rand(N, K).t() if layout == "NT" else rand(K, N)
    return a, b


F32, BF16 = torch.float32, torch.bfloat16
CASES = [  # M, K, N, layout, dtype, shift (> 0: bases not 16-byte aligned)
    (4, 600, 300, "NN", F32, 0),
    (8, 512, 520, "SN", BF16, 0),
    (1, 256, 64, "TN", F32, 1),
    (8, 512, 64, "NT", F32, 0),
    (16, 1100, 40, "NT", BF16, 1),
    (17, 300, 77, "NN", F32, 0),
    (64, 256, 256, "NT", BF16, 0),
    (40, 128, 128, "TN", F32, 1),
    (130, 300, 260, "NN", F32, 0),
    (96, 256, 264, "NT", F32, 0),
    (130, 128, 136, "TN", BF16, 0),
    (65, 70, 129, "SN", BF16, 1)]


@pytest.mark.parametrize("M,K,N,layout,dtype,shift", CASES)
def test_k1_source_matches_plain_on_the_cpu(launcher, M, K, N, layout,
                                            dtype, shift):
    a, b = _operands(M, K, N, layout, dtype, shift)
    got, path, splits, vec = launcher(a, b)
    want = BM.block_matmul_plain(a, b)
    assert path == BM.plan(M, N, K, N_SM, elt=a.element_size(),
                           b_k1=layout == "NT").path
    assert (vec == 3) == (shift == 0 and all(
        BM.vector_ok(t) for t in (a, b)))
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * float(want.float().abs().max()), (path, err)
    again, *_ = launcher(a, b)
    assert torch.equal(got, again)


BF16_CASES = [c for c in CASES if c[4] == BF16]


@pytest.mark.parametrize("M,K,N,layout,dtype,shift", BF16_CASES)
def test_k1_source_writes_float32_for_bf16_operands(launcher, M, K, N,
                                                    layout, dtype, shift):
    """bf16 operands, fp32 output (a weight gradient before its z
    reduce-scatter): held to the plain version at the float32 tolerance,
    and rounded to bf16 it is bitwise the bf16 output, so the fp32 output
    only defers the one rounding."""
    a, b = _operands(M, K, N, layout, dtype, shift)
    got, path, splits, _ = launcher(a, b, torch.float32)
    want = BM.block_matmul_plain(a, b, out_dtype=torch.float32)
    assert got.dtype == want.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= TOL[F32] * float(want.abs().max()), (path, err)
    again, *_ = launcher(a, b, torch.float32)
    assert torch.equal(got, again)
    narrow, *_ = launcher(a, b)
    assert torch.equal(got.to(BF16), narrow), path


def test_the_bf16_cases_cover_every_path():
    paths = {BM.plan(M, N, K, N_SM, elt=2, b_k1=layout == "NT").path
             for M, K, N, layout, _, _ in BF16_CASES}
    assert paths == set(BM.PATHS)


def test_the_cases_cover_every_path_and_both_loads():
    """Every path of the kernel, a split K, and 16-byte as well as
    element-wise loads, among CASES."""
    seen = set()
    for M, K, N, layout, dtype, shift in CASES:
        a, b = _operands(M, K, N, layout, dtype, shift)
        p = BM.plan(M, N, K, N_SM, elt=a.element_size(),
                    b_k1=layout == "NT")
        vec = BM.vector_ok(a) and BM.vector_ok(b)
        seen |= {p.path, ("split", p.splits > 1), ("vec", vec)}
    assert seen >= set(BM.PATHS) | {("split", True), ("split", False),
                                    ("vec", True), ("vec", False)}


# ---------------------------------------------------------------------- #
# the batched entry: E products in one launch
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    lib = compile_source("block_matmul",
                         tmp_path_factory.mktemp("k1_batched_emulated"))
    fn = lib.block_matmul_batched_launch
    fn.argtypes = BM.BATCHED_ARGTYPES
    fn.restype = ctypes.c_int

    def run(a, b, out_dtype=None):
        out = torch.full((a.shape[0], a.shape[1], b.shape[2]), float("nan"),
                         dtype=out_dtype or a.dtype)
        args, work = BM.batched_launch_args(a, b, out, N_SM)
        assert fn(*args, None) == 0
        return out, BM.PATHS[args[16]], args[14], args[17]
    return run


def _batched_operands(E, M, K, N, layout, dtype, pad):
    """a (E, M, K) and b (E, K, N) in ``layout`` (NN; NT, b a transposed
    view, dX = dY W^T; TN, a a transposed view, dW = X^T dY), each a slice
    of a batch whose stride is ``pad`` rows past the product's own."""
    gen = torch.Generator().manual_seed(E * 131 + M * 7 + K + N)

    def rand(rows, cols):
        x = torch.randn((E, rows + pad, cols), generator=gen).to(dtype)
        return x[:, :rows]
    a = rand(K, M).transpose(1, 2) if layout == "TN" else rand(M, K)
    b = rand(N, K).transpose(1, 2) if layout == "NT" else rand(K, N)
    return a, b


BATCHED_CASES = [  # E, M, K, N, layout, dtype, pad (batch stride beyond)
    (1, 130, 96, 136, "NN", F32, 0),
    (3, 4, 300, 200, "NN", F32, 3),
    (3, 8, 512, 64, "NT", BF16, 0),
    (3, 40, 70, 129, "TN", F32, 1),
    (8, 17, 64, 72, "NT", F32, 2),
    (8, 120, 48, 40, "TN", BF16, 0),
    (3, 65, 33, 130, "NN", BF16, 5),
    (8, 16, 100, 36, "NN", BF16, 1)]


@pytest.mark.parametrize("E,M,K,N,layout,dtype,pad", BATCHED_CASES)
def test_k1_batched_entry_matches_plain_on_the_cpu(batched, E, M, K, N,
                                                   layout, dtype, pad):
    """Each case against the plain version (the reference's _bmm) at the
    2-D entry's tolerances, bitwise on a repeat, and bitwise each of its
    products through the 2-D entry on the same plan: the batch only moves
    the operands."""
    a, b = _batched_operands(E, M, K, N, layout, dtype, pad)
    got, path, splits, vec = batched(a, b)
    want = BM.block_matmul_batched_plain(a, b)
    assert path == BM.plan(M, N, K, N_SM, elt=a.element_size(),
                           b_k1=layout == "NT", batch=E).path
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * float(want.float().abs().max()), (path, err)
    again, *_ = batched(a, b)
    assert torch.equal(got, again)
    if dtype == BF16:
        wide, *_ = batched(a, b, torch.float32)
        fwant = BM.block_matmul_batched_plain(a, b, out_dtype=torch.float32)
        ferr = float((wide - fwant).abs().max())
        assert ferr <= TOL[F32] * float(fwant.abs().max()), (path, ferr)
        assert torch.equal(wide.to(BF16), got), path


def test_k1_batched_rows_do_not_depend_on_m(batched):
    """Above the decode rows, one expert's rows come out with the same
    bits whether its product holds C rows or 2C (the ring's per-source
    product against the blocking round trip's stacked sources)."""
    for layout in ("NN", "NT"):
        a, b = _batched_operands(4, 60, 200, 72, layout, F32, 0)
        whole, *_ = batched(a, b)
        top, *_ = batched(a[:, :30], b)
        low, *_ = batched(a[:, 30:], b)
        assert torch.equal(torch.cat([top, low], 1), whole), layout


def test_the_batched_cases_cover_every_path_and_both_loads():
    seen = set()
    for E, M, K, N, layout, dtype, pad in BATCHED_CASES:
        a, b = _batched_operands(E, M, K, N, layout, dtype, pad)
        p = BM.plan(M, N, K, N_SM, elt=a.element_size(),
                    b_k1=layout == "NT", batch=E)
        vec = BM._vector_ok3(a) and BM._vector_ok3(b)
        seen |= {p.path, ("split", p.splits > 1), ("vec", vec),
                 ("E", E), layout, dtype, ("pad", pad > 0)}
    assert seen >= set(BM.PATHS) | {("split", True), ("split", False),
                                    ("vec", True), ("vec", False),
                                    ("E", 1), ("E", 3), ("E", 8), "NN",
                                    "NT", "TN", F32, BF16, ("pad", True)}
