"""K6, the Mamba (S6) selective scan: the CUDA kernel
``csrc/selective_scan.cu`` and its plain version.

Replaces ``repro/kernels/selective_scan.py:selective_scan`` (Pallas), the
recurrence the JAX model computes as ``layers.mamba.ssm_scan_chunked``
(prefill) and as the one-step update of ``mamba_apply``'s decode branch:

    s_t = s_{t-1} * exp(dt_t A) + (dt_t x_t) B_t,    y_t = <s_t, C_t>

Both versions take x, dt (Bt, T, d), A (d, N), B, C (Bt, T, N) and an
optional initial state s0 (Bt, d, N), and return (y (Bt, T, d) in x's
dtype, final state (Bt, d, N) fp32): the model's prefill hands the final
state to decode, and decode steps from it. The header of the CUDA source
says what bounds the kernel on the card and how its design answers that.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# d_state values the kernel is instantiated for (Jamba's is 16)
STATE_SIZES = (16,)


def selective_scan_plain(x, dt, A, B, C, s0: Optional[torch.Tensor] = None):
    """The sequential oracle ``ref.selective_scan_ref``: one step of the
    recurrence at a time, in fp32."""
    Bt, T, d = x.shape
    s = (torch.zeros((Bt, d, A.shape[-1]), dtype=torch.float32,
                     device=x.device) if s0 is None else s0.float())
    Af = A.float()
    ys = []
    for t in range(T):
        dtt = dt[:, t].float()
        dA = torch.exp(dtt[..., None] * Af)
        dBx = (dtt * x[:, t].float())[..., None] * B[:, t].float()[:, None]
        s = s * dA + dBx
        ys.append(torch.einsum("bdn,bn->bd", s, C[:, t].float()))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((Bt, 0, d), dtype=torch.float32, device=x.device))
    return y.to(x.dtype), s


def _launcher():
    fn = build.library("selective_scan").selective_scan_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, p, ll, ll, p, p, ll, ll, p, ll, ll, p, p,
                       p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def check_inputs(x, dt, A, B, C, s0: Optional[torch.Tensor] = None):
    """Raise on dtypes, shapes or strides the kernel does not take (the
    device aside): the tests hold the model's calls to this contract on
    the CPU."""
    if (x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype
            or dt.dtype != torch.float32 or A.dtype != torch.float32
            or (s0 is not None and s0.dtype != torch.float32)):
        raise TypeError(
            f"selective_scan_kernel takes float32 or bfloat16 x, B, C of one "
            f"dtype with float32 dt, A and s0, got x {x.dtype}, dt "
            f"{dt.dtype}, A {A.dtype}, B {B.dtype}, C {C.dtype}"
            + (f", s0 {s0.dtype}" if s0 is not None else ""))
    Bt, T, d = x.shape
    N = A.shape[-1]
    if (N not in STATE_SIZES or dt.shape != x.shape or A.shape != (d, N)
            or B.shape != (Bt, T, N) or C.shape != (Bt, T, N)
            or (s0 is not None and s0.shape != (Bt, d, N))):
        raise ValueError(
            f"selective_scan_kernel: unsupported shapes x {tuple(x.shape)}, "
            f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, "
            f"C {tuple(C.shape)}"
            + (f", s0 {tuple(s0.shape)}" if s0 is not None else "")
            + f" (d_state in {STATE_SIZES})")
    if (any(t.stride(-1) != 1 for t in (x, dt, B, C))
            or not A.is_contiguous()
            or (s0 is not None and not s0.is_contiguous())):
        raise ValueError("selective_scan_kernel needs unit stride along "
                         "channels and states, and contiguous A and s0")


def selective_scan_kernel(x, dt, A, B, C, s0: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not
    take. ``selective_scan_kernel.launches`` counts the launches."""
    tensors = [t for t in (x, dt, A, B, C, s0) if t is not None]
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        devices = sorted({str(t.device) for t in tensors})
        raise ValueError(f"selective_scan_kernel needs all inputs on one "
                         f"CUDA device, got {devices}")
    check_inputs(x, dt, A, B, C, s0)
    Bt, T, d = x.shape
    N = A.shape[-1]
    y = torch.empty((Bt, T, d), dtype=x.dtype, device=x.device)
    s_fin = torch.empty((Bt, d, N), dtype=torch.float32, device=x.device)
    err = _launcher()(
        x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(), dt.stride(0),
        dt.stride(1), A.data_ptr(), B.data_ptr(), B.stride(0), B.stride(1),
        C.data_ptr(), C.stride(0), C.stride(1),
        s0.data_ptr() if s0 is not None else None, y.data_ptr(),
        s_fin.data_ptr(), Bt, T, d, N, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "selective_scan_kernel")
    selective_scan_kernel.launches += 1
    return y, s_fin


selective_scan_kernel.launches = 0
