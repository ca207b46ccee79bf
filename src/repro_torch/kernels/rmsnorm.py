"""K3, RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm`` (Pallas). The header of the
CUDA source says what bounds the kernel on the card and how its design
answers that. Besides the single pass over whole rows, the norm runs as
two passes around a psum for a row sharded over x: ``rmsnorm_stats``
(each row's fp32 sum of squares) and ``rmsnorm_apply`` (the scaling, given
the summed squares); each has its plain version, the single pass's sum and
scale split.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, *,
                  full_dim: Optional[int] = None,
                  eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(sum(x^2) / full_dim + eps) * gamma with fp32 statistics,
    in x's dtype (``ref.rmsnorm_ref`` / ``parallel._rms_fwd`` at g_x=1)."""
    xf = x.float()
    ms = torch.sum(xf * xf, dim=-1, keepdim=True) / (full_dim or x.shape[-1])
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def rmsnorm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2) over the last dim in fp32: the plain version's sum."""
    xf = x.float()
    return torch.sum(xf * xf, dim=-1)


def rmsnorm_apply_plain(x: torch.Tensor, gamma: torch.Tensor,
                        ss: torch.Tensor, *, full_dim: int,
                        eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(ss / full_dim + eps) * gamma in x's dtype, ``ss`` the
    rows' fp32 sums of squares: the plain version's scale."""
    ms = ss.float()[..., None] / full_dim
    return (x.float() * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def _launcher():
    fn = build.library("rmsnorm").rmsnorm_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, gamma: Optional[torch.Tensor]):
    """Raise on what the kernel does not take: x (and gamma) contiguous on
    one CUDA device, float32 or bfloat16, gamma (d,) of x's dtype."""
    d = x.shape[-1]
    if not (x.is_cuda and (gamma is None or gamma.device == x.device)):
        raise ValueError(f"{name} needs x and gamma on one CUDA device, got "
                         f"{x.device} and "
                         f"{None if gamma is None else gamma.device}")
    if x.dtype not in _DTYPES or (gamma is not None
                                  and gamma.dtype != x.dtype):
        raise TypeError(f"{name} takes float32 or bfloat16 x with gamma of "
                        f"the same dtype, got {x.dtype} and "
                        f"{None if gamma is None else gamma.dtype}")
    if not x.is_contiguous() or (gamma is not None and (
            gamma.shape != (d,) or not gamma.is_contiguous())):
        raise ValueError(f"{name} needs contiguous x (..., {d}) and gamma "
                         f"({d},), got {tuple(x.shape)} and "
                         f"{None if gamma is None else tuple(gamma.shape)}")


def rmsnorm_kernel(x: torch.Tensor, gamma: torch.Tensor, *,
                   full_dim: Optional[int] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not
    take. ``rmsnorm_kernel.launches`` counts the launches."""
    d = x.shape[-1]
    _check("rmsnorm_kernel", x, gamma)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    err = _launcher()(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows,
                      d, float(full_dim or d), eps, _DTYPES[x.dtype],
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_kernel")
    rmsnorm_kernel.launches += 1
    return out


rmsnorm_kernel.launches = 0


def rmsnorm_stats_kernel(x: torch.Tensor) -> torch.Tensor:
    """K3's stats pass on a CUDA tensor: each row's fp32 sum of squares,
    shape x.shape[:-1]. ``rmsnorm_stats_kernel.launches`` counts the
    launches."""
    _check("rmsnorm_stats_kernel", x, None)
    d = x.shape[-1]
    ss = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    fn = build.library("rmsnorm").rmsnorm_stats_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), ss.data_ptr(), ss.numel() if d else 0, d,
             _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_stats_kernel")
    rmsnorm_stats_kernel.launches += 1
    return ss


rmsnorm_stats_kernel.launches = 0


def rmsnorm_apply_kernel(x: torch.Tensor, gamma: torch.Tensor,
                         ss: torch.Tensor, *, full_dim: int,
                         eps: float = 1e-6) -> torch.Tensor:
    """K3's apply pass on CUDA tensors: x * rsqrt(ss / full_dim + eps) *
    gamma, ``ss`` the rows' fp32 sums of squares (x.shape[:-1]).
    ``rmsnorm_apply_kernel.launches`` counts the launches."""
    _check("rmsnorm_apply_kernel", x, gamma)
    if (ss.dtype != torch.float32 or ss.shape != x.shape[:-1]
            or ss.device != x.device or not ss.is_contiguous()):
        raise ValueError(f"rmsnorm_apply_kernel needs contiguous float32 ss "
                         f"{tuple(x.shape[:-1])} on {x.device}, got "
                         f"{ss.dtype} {tuple(ss.shape)} on {ss.device}")
    d = x.shape[-1]
    out = torch.empty_like(x)
    fn = build.library("rmsnorm").rmsnorm_apply_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), gamma.data_ptr(), ss.data_ptr(), out.data_ptr(),
             ss.numel() if d else 0, d, float(full_dim), eps,
             _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_apply_kernel")
    rmsnorm_apply_kernel.launches += 1
    return out


rmsnorm_apply_kernel.launches = 0
