"""K1, the local GEMM: the CUDA kernel ``csrc/block_matmul.cu`` and its
plain version.

Replaces ``repro/kernels/block_matmul.py:block_matmul`` (Pallas), the local
GEMM of paper Algorithm 1. Both versions take (M, K) and (K, N) operands
through their strides, so a transposed view (``w.t()``, ``x.t()``) costs no
copy, and return a fresh (M, N) row-major tensor in the operands' dtype
with fp32 accumulation. The header of the CUDA source says what bounds the
kernel on the card and how its design answers that.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (rows, cols, depth) of the kernel's output tiles; mirrors csrc's Tile
LARGE = (128, 128, 8)
SMALL = (16, 64, 32)
SMALL_M = 64          # M at or below this takes the small tile
MIN_SPLIT_TILES = 4   # each K split runs at least this many tile steps
# blocks per SM the K split aims for: the small tile holds little state,
# so many of its blocks fit an SM and keep more weight loads in flight
BLOCKS_PER_SM = {True: 8, False: 2}


def block_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on fp32-upcast operands, cast back to a's dtype
    (``ref.block_matmul_ref``). The only place in the port where
    ``torch.matmul`` computes a ``tp_matmul`` product."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def plan(M: int, N: int, K: int, n_sm: int):
    """(small, splits, k_split): the tile the kernel uses, and how many
    ways K is split so that about BLOCKS_PER_SM blocks per SM are in
    flight, with every split at least MIN_SPLIT_TILES tile steps deep."""
    small = M <= SMALL_M
    bm, bn, bk = SMALL if small else LARGE
    tiles = -(-M // bm) * -(-N // bn)
    k_tiles = -(-K // bk)
    want = -(-BLOCKS_PER_SM[small] * n_sm // tiles)
    splits = max(1, min(want, k_tiles // MIN_SPLIT_TILES))
    k_split = max(-(-k_tiles // splits), 1) * bk
    return small, max(-(-K // k_split), 1), k_split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launcher():
    fn = build.library("block_matmul").block_matmul_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, p, ll, ll, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def block_matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not
    take. ``block_matmul_kernel.launches`` counts the calls (a call with a
    split K launches the split sum as well)."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"block_matmul_kernel needs a and b on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"block_matmul_kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block_matmul_kernel needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    small, splits, k_split = plan(M, N, K, _sm_count(a.device.index or 0))
    work = (torch.empty((splits, M, N), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    err = _launcher()(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), out.data_ptr(), work.data_ptr() if work is not None
        else None, M, N, K, splits, k_split, int(small), _DTYPES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "block_matmul_kernel")
    block_matmul_kernel.launches += 1
    return out


block_matmul_kernel.launches = 0
