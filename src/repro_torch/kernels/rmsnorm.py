"""K3, RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm`` (Pallas). The header of the
CUDA source says what bounds the kernel on the card and how its design
answers that.
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


def _launcher():
    fn = build.library("rmsnorm").rmsnorm_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def rmsnorm_kernel(x: torch.Tensor, gamma: torch.Tensor, *,
                   full_dim: Optional[int] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not
    take. ``rmsnorm_kernel.launches`` counts the launches."""
    d = x.shape[-1]
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError(f"rmsnorm_kernel needs x and gamma on one CUDA "
                         f"device, got {x.device} and {gamma.device}")
    if x.dtype not in _DTYPES or gamma.dtype != x.dtype:
        raise TypeError(f"rmsnorm_kernel takes float32 or bfloat16 x with "
                        f"gamma of the same dtype, got {x.dtype} and "
                        f"{gamma.dtype}")
    if gamma.shape != (d,) or not (x.is_contiguous()
                                   and gamma.is_contiguous()):
        raise ValueError(f"rmsnorm_kernel needs contiguous x (..., {d}) and "
                         f"gamma ({d},), got {tuple(x.shape)} and "
                         f"{tuple(gamma.shape)}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    err = _launcher()(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows,
                      d, float(full_dim or d), eps, _DTYPES[x.dtype],
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_kernel")
    rmsnorm_kernel.launches += 1
    return out


rmsnorm_kernel.launches = 0
