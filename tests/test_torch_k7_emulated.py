"""K7's CUDA source (``csrc/mla_decode.cu``: each split's walk over MLA's
latent cache and the combine of each row's splits) run on the CPU.

The source is compiled with g++ against the CPU stand-ins of
``tests/cuda_emu/`` (one thread per CUDA thread, blocks in turn; the
tensor cores' m16n8k8 TF32 product, the TF32 rounding and the wait of
the programmatic dependent combine are stand-ins there too) and
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
                                            TILE_KEYS, bind,
                                            mla_decode_plain, split_keys)

TOL = 1e-4
SCALE = 1.0 / math.sqrt(192)


@pytest.fixture(scope="module")
def k7(tmp_path_factory):
    lib = bind(compile_source("mla_decode",
                              tmp_path_factory.mktemp("k7_emulated")))
    fn, work = lib.mla_decode_launch, lib.mla_decode_workspace
    lib.mla_decode_split_keys.argtypes = [ctypes.c_int]
    lib.mla_decode_split_keys.restype = ctypes.c_int

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
    run.split_keys = lib.mla_decode_split_keys
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


# (B, H, S, dtype, positions). At up to 16 heads a split is one 16-key
# tile: one key (idx 0); a split's last and the next split's first (15 16,
# 31 32, 63 64); the cache's last row; 8 heads (g_y = 2's half of 16: the
# MMA's row tile half empty), also over V2-Lite's 33 splits (9 a combine
# thread).
# Above 16 heads a split is 8 tiles (128 keys): 20 and 24 heads (a second,
# partial head tile) at a tile's edges (31 32) and a split's (127 128); 128
# heads (V3's, 8 head tiles) at a small cache
CASES = {
    "f32 B2 idx 0 and 95": (2, 16, 96, F32, [0, 95]),
    "f32 B2 narrow split edges 15 16": (2, 16, 40, F32, [15, 16]),
    "bf16 B2 narrow split edges 32 31": (2, 8, 40, BF16, [32, 31]),
    "f32 B2 split edges 63 64": (2, 16, 96, F32, [63, 64]),
    "bf16 B2 split edges 64 63": (2, 16, 96, BF16, [64, 63]),
    "bf16 B1 idx 40 of 70": (1, 16, 70, BF16, [40]),
    "f32 B2 8 heads": (2, 8, 80, F32, [79, 17]),
    "f32 B1 8 heads 33 splits": (1, 8, 528, F32, [527]),
    "f32 B2 tile edges 31 32": (2, 20, 96, F32, [31, 32]),
    "bf16 B1 20 heads": (1, 20, 65, BF16, [64]),
    "f32 B2 wide split edges 127 128": (2, 20, 140, F32, [127, 128]),
    "bf16 B1 wide split edge 128": (1, 24, 130, BF16, [128]),
    "f32 B2 128 heads": (2, 128, 24, F32, [23, 16]),
    "bf16 B1 128 heads": (1, 128, 40, BF16, [36]),
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
    without changing a bit; a split wholly past it is never read. At 16
    heads (one-tile splits) and 20 (eight-tile splits)."""
    for H in (16, 20):
        split = split_keys(H)
        args = k7_inputs(3, B=2, H=H, S=2 * split + 5, dtype=F32,
                         pos=[split - 1, 2])
        q_eff, q_rope, ckv, k_rope, q_pos = args
        got = k7(*args)
        dirty = [t.clone() for t in (ckv, k_rope)]
        for t in dirty:
            t[0, split:] = math.nan
            t[1, 3:] = math.inf
        assert torch.equal(k7(q_eff, q_rope, *dirty, q_pos), got)


@pytest.mark.parametrize("H", [16, 20])
def test_k7_source_takes_queries_4_byte_aligned(k7, H):
    """Query rows that are not 16-byte aligned (views one float into a
    wider row) take the 4-byte copies and give the same bits as the
    aligned ones."""
    args = k7_inputs(5, B=2, H=H, S=40, dtype=F32, pos=[39, 20])
    q_eff, q_rope = args[:2]
    wide = [torch.zeros(t.shape[:-1] + (t.shape[-1] + 1,)) for t in
            (q_eff, q_rope)]
    for w, t in zip(wide, (q_eff, q_rope)):
        w[..., 1:] = t
    odd = [w[..., 1:] for w in wide]
    assert all(t.data_ptr() % 16 for t in odd)
    got = k7(*odd, *args[2:])
    assert torch.equal(got, k7(*args))
    torch.testing.assert_close(got, mla_decode_plain(*args, scale=SCALE),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("H", [8, 16, 17, 128])
def test_k7_source_splits_match_the_wrapper(k7, H):
    """The source's keys a split (its C entry) are the wrapper's, whole
    tiles of TILE_KEYS, as the cases above assume."""
    assert k7.split_keys(H) == split_keys(H) in SPLIT_KEYS
    assert split_keys(H) % TILE_KEYS == 0
