"""K7's CUDA source (``csrc/mla_decode.cu``: each split's walk over MLA's
latent cache and the combine of each row's splits) run on the CPU.

The source is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn) and
launched through its C interface on CPU tensors, at the kernel's real
widths (a latent of 512, a rotary key of 64) and small batches and
caches. Each case is held to the plain version (``mla_decode_plain``, the
reference's einsums) with the card's tolerance (``chip_smoke.py``'s
MLA_DECODE_TOL: both sum float32 products of the same values, the cache
widened from bf16 alike, in other orders) and must repeat bitwise. The
workspace and the output start as NaN, so a read of an entry no block
wrote shows. This checks the kernel's indexing and arithmetic, not its
speed or its behaviour under the real compiler; the card runs the same
source in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from cuda_emu import compile_source
from cuda_emu.attention import BF16, DTYPE, F32
from repro_torch.kernels.mla_decode import (LATENT, ROPE, SPLIT_KEYS,
                                            mla_decode_plain)

TOL = 1e-4
SCALE = 1.0 / math.sqrt(192)


@pytest.fixture(scope="module")
def k7(tmp_path_factory):
    lib = compile_source("mla_decode", tmp_path_factory.mktemp("k7_emulated"))
    fn, work = lib.mla_decode_launch, lib.mla_decode_workspace
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, ll, p, ll, ll, p, ll, ll, p, ll, ll, p, p, p,
                   i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    work.argtypes = [i, i, i]
    work.restype = ll

    def run(q_eff, q_rope, ckv, k_rope, q_pos):
        B, H, R = q_eff.shape
        S, Dr = ckv.shape[1], k_rope.shape[2]
        ws = torch.full((work(B, H, S),), math.nan)
        out = torch.full((B, H, R), math.nan)
        err = fn(q_eff.data_ptr(), *q_eff.stride()[:2], q_rope.data_ptr(),
                 *q_rope.stride()[:2], ckv.data_ptr(), *ckv.stride()[:2],
                 k_rope.data_ptr(), *k_rope.stride()[:2], q_pos.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), B, H, S, R, Dr, SCALE,
                 DTYPE[ckv.dtype], None)
        assert err == 0
        return out
    return run


def k7_inputs(seed, *, B, H, S, dtype, pos):
    """Seeded inputs: q_eff as the decode path hands it over, the (B, H)
    view of K1's (H, B, R) output; the cache rows of a wider buffer's
    batch stride."""
    rng = np.random.RandomState(seed)
    q_eff = torch.from_numpy(rng.randn(H, B, LATENT).astype(np.float32)
                             ).transpose(0, 1)
    q_rope = torch.from_numpy(rng.randn(B, H, ROPE).astype(np.float32))
    ckv = torch.from_numpy(rng.randn(B, S + 3, LATENT)).to(dtype)[:, :S]
    k_rope = torch.from_numpy(rng.randn(B, S, ROPE)).to(dtype)
    return q_eff, q_rope, ckv, k_rope, torch.tensor(pos, dtype=torch.int32)


# (B, H, S, dtype, positions): one key (idx 0); a tile's last and the next
# tile's first key (31, 32); a split's last and the next split's first
# (63, 64); the cache's last row; 8 heads (g_y = 2's half of 16: a head
# tile half empty); 20 heads (a second, partial head tile)
CASES = {
    "f32 B2 idx 0 and 95": (2, 16, 96, F32, [0, 95]),
    "f32 B2 tile edges 31 32": (2, 16, 96, F32, [31, 32]),
    "f32 B2 split edges 63 64": (2, 16, 96, F32, [63, 64]),
    "bf16 B2 split edges 64 63": (2, 16, 96, BF16, [64, 63]),
    "bf16 B1 idx 40 of 70": (1, 16, 70, BF16, [40]),
    "f32 B2 8 heads": (2, 8, 80, F32, [79, 17]),
    "bf16 B1 20 heads": (1, 20, 65, BF16, [64]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k7_source_matches_plain_on_the_cpu(k7, case):
    B, H, S, dtype, pos = CASES[case]
    args = k7_inputs(len(case), B=B, H=H, S=S, dtype=dtype, pos=pos)
    got = k7(*args)
    want = mla_decode_plain(*args, scale=SCALE)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert torch.equal(k7(*args), got)


def test_k7_source_reads_no_key_past_the_position(k7):
    """Keys past a row's position may hold anything (here NaN and inf)
    without changing a bit; a split wholly past it is never read."""
    args = k7_inputs(3, B=2, H=16, S=2 * SPLIT_KEYS + 5, dtype=F32,
                     pos=[SPLIT_KEYS - 1, 2])
    q_eff, q_rope, ckv, k_rope, q_pos = args
    got = k7(*args)
    dirty = [t.clone() for t in (ckv, k_rope)]
    for t in dirty:
        t[0, SPLIT_KEYS:] = math.nan
        t[1, 3:] = math.inf
    assert torch.equal(k7(q_eff, q_rope, *dirty, q_pos), got)
