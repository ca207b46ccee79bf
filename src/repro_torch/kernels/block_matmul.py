"""K1, the local GEMM: the CUDA kernel ``csrc/block_matmul.cu`` and its
plain version.

Replaces ``repro/kernels/block_matmul.py:block_matmul`` (Pallas), the local
GEMM of paper Algorithm 1. Both versions take (M, K) and (K, N) operands
through their strides, so a transposed view (``w.t()``, ``x.t()``) costs no
copy, and return a fresh (M, N) row-major tensor with fp32 accumulation,
in the operands' dtype or, for bfloat16 operands, in float32 when asked
(``out_dtype``: a weight gradient that is summed over z before its one
rounding). The batched entry (:func:`block_matmul_batched_kernel`) runs E such
products, (E, M, K) @ (E, K, N), in one launch, the batch on the grid's z
dimension: the MoE expert bank's products. The header of the CUDA source
says what bounds the kernel on the card and how its design answers that.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's paths (csrc's Path): two block tiles, and two decode paths
# that stream the weight once, by which index of b is contiguous
LARGE, MID, DECODE_N, DECODE_K = "large", "mid", "decode_n", "decode_k"
PATHS = (LARGE, MID, DECODE_N, DECODE_K)
TILES = {LARGE: (128, 128), MID: (64, 128)}   # (rows, cols); mirrors Tile
TILE_K = 16           # the tiles' depth
BLOCKS_PER_SM = {LARGE: 2, MID: 4}            # resident blocks of a tile
DECODE_M = 16         # M at or below this takes a decode path
MID_M = 64            # M at or below this (and above DECODE_M) takes MID
MIN_SPLIT_TILES = 4   # each K split of a tile path runs this many steps
MAX_SPLITS = 16
# decode: the blocks per SM the K split aims for, and each split's least
# depth in rows
DECODE_BLOCKS_PER_SM = 4
MIN_SPLIT_ROWS = 64
# an H100 SXM's published rates (the plan's cost model): float32 outside
# the tensor cores, and memory
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
SPLIT_SUM_S = 2e-6    # a launch of the split sum, beside its bytes


class Plan(NamedTuple):
    path: str         # one of PATHS
    splits: int       # K is split this many ways...
    k_split: int      # ...of this many k each (the last may be shorter)


def block_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                       out_dtype=None) -> torch.Tensor:
    """a @ b on fp32-upcast operands, cast to ``out_dtype`` (default: a's
    dtype; ``ref.block_matmul_ref``). The only place in the port where
    ``torch.matmul`` computes a ``tp_matmul`` product."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def block_matmul_batched_plain(a: torch.Tensor, b: torch.Tensor, *,
                               out_dtype=None) -> torch.Tensor:
    """a[e] @ b[e] for each e on fp32-upcast operands, cast to
    ``out_dtype`` (default: a's dtype): the reference's ``_bmm``, a
    ``dot_general`` with fp32 accumulation."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def k_granule(path: str, elt: int) -> int:
    """The k a split must be a multiple of (csrc's k_granule): the tiles'
    depth; 8 warps of 4 rows (DECODE_N); 2 steps of 32 lanes of a 16-byte
    group along k (DECODE_K)."""
    if path == DECODE_N:
        return 32
    if path == DECODE_K:
        return 2 * 32 * (16 // elt)
    return TILE_K


def _split(K: int, granule: int, splits: int):
    k_split = -(-max(K, 1) // (splits * granule)) * granule
    return max(-(-K // k_split), 1), k_split


@functools.lru_cache(maxsize=4096)   # called once per product, per step
def plan(M: int, N: int, K: int, n_sm: int, *, elt: int = 4,
         b_k1: bool = False, batch: int = 1) -> Plan:
    """The kernel's path for an (M, K) @ (K, N) product of ``elt``-byte
    elements on a card of ``n_sm`` SMs, and its K split. ``b_k1``: b's k
    index is contiguous (b a transposed view), which picks DECODE_K.
    ``batch``: the products of one launch of the batched entry.

    Tiles: the split that minimises the estimated time, the waves of
    blocks (BLOCKS_PER_SM resident on each SM) times each split's tile
    steps at the card's float32 rate, plus the split sum's bytes; every
    split at least MIN_SPLIT_TILES steps deep. A batch of products splits
    no K on the tiles: the products give the grid its blocks, and with
    one split each output element is one fp32 chain over k in order, so
    a row's bits do not depend on M (the expert ring's per-source rows
    and the blocking round trip's stacked ones agree). Decode: enough K
    splits for DECODE_BLOCKS_PER_SM blocks per SM over the batch's
    blocks, each split at least MIN_SPLIT_ROWS deep."""
    if M <= DECODE_M:
        path = DECODE_K if b_k1 else DECODE_N
        # columns a block owns: a 16-byte group for each of 32 lanes
        # (DECODE_N), 4 for each of 8 warps (DECODE_K)
        cols = 32 * (16 // elt) if path == DECODE_N else 8 * 4
        granule = k_granule(path, elt)
        want = -(-DECODE_BLOCKS_PER_SM * n_sm // (batch * -(-N // cols)))
        most = max(1, -(-K // max(MIN_SPLIT_ROWS, granule)))
        return Plan(path, *_split(K, granule, max(1, min(want, most))))
    path = MID if M <= MID_M else LARGE
    if batch > 1:
        return Plan(path, *_split(K, TILE_K, 1))
    bm, bn = TILES[path]
    tiles = -(-M // bm) * -(-N // bn)
    k_tiles = max(-(-K // TILE_K), 1)
    slots = BLOCKS_PER_SM[path] * n_sm
    step_s = 2 * bm * bn * TILE_K * BLOCKS_PER_SM[path] / (PEAK_F32 / n_sm)

    def cost(s):
        waves = -(-tiles * s // slots)
        t = waves * -(-k_tiles // s) * step_s
        if s > 1:
            t += (s + 1) * M * N * 4 / HBM_BYTES_PER_S + SPLIT_SUM_S
        return t
    most = max(1, min(MAX_SPLITS, k_tiles // MIN_SPLIT_TILES))
    best = min(range(1, most + 1), key=lambda s: (cost(s), s))
    return Plan(path, *_split(K, TILE_K, best))


def vector_ok(t: torch.Tensor) -> bool:
    """Whether the kernel may read the 2-D operand ``t`` 16 bytes at a time
    along its contiguous index: that index has stride 1, and the base
    address and the other stride are multiples of 16 bytes (4 float32 or
    8 bf16 elements)."""
    s0, s1 = t.stride()
    other = s0 if s1 == 1 else s1 if s0 == 1 else None
    return (other is not None and t.data_ptr() % 16 == 0
            and other * t.element_size() % 16 == 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# block_matmul_launch's arguments: a, its strides, b, its strides, out,
# work, M, N, K, splits, k_split, path, vec, dtype, out_dtype, stream
ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]


def _launcher():
    fn = build.library("block_matmul").block_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_args(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                n_sm: int):
    """(the launcher's arguments before the stream, the workspace): the
    plan for these operands and their 16-byte reads."""
    (M, K), N = a.shape, b.shape[1]
    p = plan(M, N, K, n_sm, elt=a.element_size(),
             b_k1=b.stride(0) == 1 and b.stride(1) != 1)
    work = (torch.empty((p.splits, M, N), dtype=torch.float32,
                        device=a.device) if p.splits > 1 else None)
    vec = int(vector_ok(a)) | 2 * int(vector_ok(b))
    return (a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
            b.stride(0), b.stride(1), out.data_ptr(),
            work.data_ptr() if work is not None else None, M, N, K,
            p.splits, p.k_split, PATHS.index(p.path), vec,
            _DTYPES[a.dtype], _DTYPES[out.dtype]), work


def block_matmul_kernel(a: torch.Tensor, b: torch.Tensor, *,
                        out_dtype=None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not
    take. ``out_dtype``: a's dtype (default) or float32.
    ``block_matmul_kernel.launches`` counts the calls (a call with a split
    K launches the split sum as well)."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"block_matmul_kernel needs a and b on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"block_matmul_kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block_matmul_kernel needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"block_matmul_kernel writes its operands' dtype or "
                        f"float32, not {out_dtype}")
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    args, work = launch_args(a, b, out, _sm_count(a.device.index or 0))
    err = _launcher()(*args, torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "block_matmul_kernel")
    block_matmul_kernel.launches += 1
    return out


block_matmul_kernel.launches = 0


# block_matmul_batched_launch's arguments: a and its strides (batch, m,
# k), b and its strides (batch, k, n), out, work, E, M, N, K, splits,
# k_split, path, vec, dtype, out_dtype, stream
BATCHED_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 10 + [
    ctypes.c_void_p]


def _batched_launcher():
    fn = build.library("block_matmul").block_matmul_batched_launch
    if fn.argtypes is None:
        fn.argtypes = BATCHED_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _vector_ok3(t: torch.Tensor) -> bool:
    """:func:`vector_ok` for each matrix of a batch: also the batch
    stride a multiple of 16 bytes."""
    return (vector_ok(t[0]) if t.shape[0] else True) and (
        t.shape[0] == 1 or t.stride(0) * t.element_size() % 16 == 0)


def batched_launch_args(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                        n_sm: int):
    """(the batched launcher's arguments before the stream, the
    workspace) for a (E, M, K), b (E, K, N) and out (E, M, N)."""
    (E, M, K), N = a.shape, b.shape[2]
    p = plan(M, N, K, n_sm, elt=a.element_size(),
             b_k1=b.stride(1) == 1 and b.stride(2) != 1, batch=E)
    work = (torch.empty((E, p.splits, M, N), dtype=torch.float32,
                        device=a.device) if p.splits > 1 else None)
    vec = int(_vector_ok3(a)) | 2 * int(_vector_ok3(b))
    return (a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(),
            out.data_ptr(), work.data_ptr() if work is not None else None,
            E, M, N, K, p.splits, p.k_split, PATHS.index(p.path), vec,
            _DTYPES[a.dtype], _DTYPES[out.dtype]), work


def block_matmul_batched_kernel(a: torch.Tensor, b: torch.Tensor, *,
                                out_dtype=None) -> torch.Tensor:
    """Launch the CUDA kernel's batched entry on CUDA tensors: a (E, M, K)
    @ b (E, K, N) -> (E, M, N), each operand through its three strides (a
    transposed view of the last two dims, or a slice along them, costs no
    copy), in one launch; raises on what it does not take.
    ``out_dtype``: a's dtype (default) or float32.
    ``block_matmul_batched_kernel.launches`` counts the calls."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"block_matmul_batched_kernel needs a and b on one "
                         f"CUDA device, got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"block_matmul_batched_kernel takes float32 or "
                        f"bfloat16 operands of one dtype, got {a.dtype} and "
                        f"{b.dtype}")
    if (a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[1]):
        raise ValueError(f"block_matmul_batched_kernel needs (E, M, K) @ "
                         f"(E, K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in (a.dtype, torch.float32):
        raise TypeError(f"block_matmul_batched_kernel writes its operands' "
                        f"dtype or float32, not {out_dtype}")
    out = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=out_dtype,
                      device=a.device)
    args, work = batched_launch_args(a, b, out,
                                     _sm_count(a.device.index or 0))
    err = _batched_launcher()(*args,
                              torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "block_matmul_batched_kernel")
    block_matmul_batched_kernel.launches += 1
    return out


block_matmul_batched_kernel.launches = 0
