"""K7, MLA's absorbed decode attention over the latent cache: the CUDA
kernel ``csrc/mla_decode.cu`` and its plain version.

No TPU kernel stands behind it: the reference's decode computes this step
as jnp einsums (``repro.layers.attention.mla_apply``, mode ``"decode"``).
Both versions take, for B sequences and H local heads, the absorbed query
q_eff (B, H, R) = q_nope W_uk and the rotated rope query q_rope (B, H,
Dr), both float32 (any batch and head strides, unit stride along the
row), the layer's latent cache ckv (B, S, R) and rotary keys k_rope (B, S,
Dr) in float32 or bfloat16, and each sequence's position q_pos (B,)
int32, and return the context ctx (B, H, R) float32:

    s_j = scale (q_eff . ckv_j + q_rope . k_rope_j),  p = softmax_j(s),
    ctx = sum_j p_j ckv_j,  over the keys j <= q_pos.

The kernel takes R = 512 and Dr = 64 only (MLA's full widths); the CUDA
source's header says what bounds it and how its design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widths the kernel is compiled for: the latent (kv_lora) and the
# rotary key (qk_rope)
LATENT, ROPE = 512, 64
# keys a split, fixed by the key position: (at up to 16 local heads, one
# head tile of the kernel; above), the source's kNarrowTiles and
# kWideTiles tiles of TILE_KEYS
TILE_KEYS = 16
SPLIT_KEYS = (16, 128)


def split_keys(n_heads: int) -> int:
    """Keys a split of the kernel's walk for ``n_heads`` local heads."""
    return SPLIT_KEYS[n_heads > 16]


def mla_decode_plain(q_eff, q_rope, ckv, k_rope, q_pos, *, scale: float):
    """The reference's einsums in float32 (``mla_apply``'s decode between
    its two absorption products): scores over the whole cache, keys past
    each row's q_pos at NEG_INF, one softmax, then p c_kv."""
    S = ckv.shape[1]
    cc, rc = ckv.float(), k_rope.float()
    s = (torch.einsum("bhr,bsr->bhs", q_eff.float(), cc)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), rc)) * scale
    ok = (torch.arange(S, device=ckv.device)[None, :]
          <= q_pos.long()[:, None])                             # (B, S)
    s = torch.where(ok[:, None], s, torch.full_like(s, NEG_INF))
    return torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), cc)


def bind(lib):
    """``lib`` (a build of ``csrc/mla_decode.cu``) with its entry points'
    ctypes signatures set."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mla_decode_launch.argtypes = [p, ll, ll, p, ll, ll, p, ll, ll, p, ll,
                                      ll, p, p, p, i, i, i, i, i,
                                      ctypes.c_float, i, p]
    lib.mla_decode_launch.restype = ctypes.c_int
    lib.mla_decode_workspace.argtypes = [i, i, i]
    lib.mla_decode_workspace.restype = ll
    return lib


def _lib():
    """The source's library, bound."""
    lib = build.library("mla_decode")
    return lib if lib.mla_decode_launch.argtypes else bind(lib)


def launch(lib, q_eff, q_rope, ckv, k_rope, q_pos, *, scale: float):
    """One call of ``lib``'s C entry on checked inputs: the context."""
    B, H, R = q_eff.shape
    S, Dr = ckv.shape[1], k_rope.shape[2]
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_eff.device)
    work = torch.empty((lib.mla_decode_workspace(B, H, S),),
                       dtype=torch.float32, device=q_eff.device)
    err = lib.mla_decode_launch(
        q_eff.data_ptr(), *q_eff.stride()[:2], q_rope.data_ptr(),
        *q_rope.stride()[:2], ckv.data_ptr(), *ckv.stride()[:2],
        k_rope.data_ptr(), *k_rope.stride()[:2], q_pos.data_ptr(),
        out.data_ptr(), work.data_ptr(), B, H, S, R, Dr, scale,
        _DTYPES[ckv.dtype],
        torch.cuda.current_stream(q_eff.device).cuda_stream)
    build.check(err, "mla_decode_kernel")
    return out


def mla_decode_kernel(q_eff, q_rope, ckv, k_rope, q_pos, *, scale: float):
    """Launch the CUDA kernels on CUDA tensors: each split's walk over the
    latent cache, then (as its programmatic dependent) the combine of each
    (row, head)'s splits; raises on what they do not take.
    ``mla_decode_kernel.launches`` counts the calls, each one launch of
    both kernels."""
    B, H, R = q_eff.shape
    S, Dr = ckv.shape[1], k_rope.shape[2]
    tensors = (q_eff, q_rope, ckv, k_rope, q_pos)
    if not (q_eff.is_cuda and all(t.device == q_eff.device
                                  for t in tensors)):
        raise ValueError("mla_decode_kernel needs all inputs on one CUDA "
                         "device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if (q_eff.dtype != torch.float32 or q_rope.dtype != torch.float32
            or ckv.dtype not in _DTYPES or k_rope.dtype != ckv.dtype
            or q_pos.dtype != torch.int32):
        raise TypeError(f"mla_decode_kernel takes float32 queries, a "
                        f"float32 or bfloat16 cache of one dtype and int32 "
                        f"q_pos, got {[t.dtype for t in tensors]}")
    if (R, Dr) != (LATENT, ROPE):
        raise ValueError(f"mla_decode_kernel is compiled for a latent of "
                         f"{LATENT} and a rotary key of {ROPE} (MLA's full "
                         f"widths), got {R} and {Dr}")
    if (q_rope.shape != (B, H, Dr) or ckv.shape != (B, S, R)
            or k_rope.shape != (B, S, Dr) or q_pos.shape != (B,)
            or S == 0):
        raise ValueError(f"mla_decode_kernel: unsupported shapes q_eff "
                         f"{tuple(q_eff.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, "
                         f"k_rope {tuple(k_rope.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}")
    elt = ckv.element_size()
    if (any(t.stride(-1) != 1 for t in tensors[:4])
            or not q_pos.is_contiguous()
            or any((t.data_ptr() | t.stride(0) * elt | t.stride(1) * elt)
                   % 16 for t in (ckv, k_rope))):
        raise ValueError("mla_decode_kernel needs unit stride along every "
                         "row, a contiguous q_pos and 16-byte aligned cache "
                         "rows")
    out = launch(_lib(), *tensors, scale=scale)
    mla_decode_kernel.launches += 1
    return out


mla_decode_kernel.launches = 0
