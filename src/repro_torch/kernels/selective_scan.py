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

Training differentiates the scan through :class:`SelectiveScan`: its
forward runs the kernel and keeps the state before each 32-step chunk,
its backward runs the backward kernel of the same source from them
(``selective_scan_bwd_kernel``; ``selective_scan_bwd_plain`` is its plain
version, the reverse recurrence a step at a time). The TPU has no such
kernel: JAX differentiates its jnp scan.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# d_state values the kernel is instantiated for (Jamba's is 16)
STATE_SIZES = (16,)
CHUNK = 32  # the steps between two states the forward keeps for training


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


def selective_scan_bwd_plain(x, dt, A, B, C, dy, s0=None, ds_fin=None):
    """The gradients of :func:`selective_scan_plain`'s (y, final state)
    for the cotangents ``dy`` (or None: zeros) and ``ds_fin`` (or None),
    in fp32 one step at a time: the states walked forward, then G_t =
    dL/ds_t walked back (G_t = dy_t C_t + a_{t+1} G_{t+1}, a_t = exp(dt_t
    A)). Returns (dx, ddt, dA, dB, dC, ds0), dx, dB and dC in x's dtype,
    ds0 None where s0 is."""
    Bt, T, d = x.shape
    N = A.shape[-1]
    f32 = torch.float32
    Af = A.float()
    s = (torch.zeros((Bt, d, N), dtype=f32, device=x.device) if s0 is None
         else s0.float())
    states, gates = [s], []
    for t in range(T):
        a = torch.exp(dt[:, t].float()[..., None] * Af)
        u = (dt[:, t].float() * x[:, t].float())[..., None] \
            * B[:, t].float()[:, None]
        s = s * a + u
        states.append(s)
        gates.append(a)
    G = (torch.zeros((Bt, d, N), dtype=f32, device=x.device)
         if ds_fin is None else ds_fin.float().clone())
    a_next = torch.ones_like(G)
    dx, ddt, dB, dC = (torch.zeros((Bt, T, w), dtype=f32, device=x.device)
                       for w in (d, d, N, N))
    dA = torch.zeros((d, N), dtype=f32, device=x.device)
    for t in reversed(range(T)):
        dyt = (dy[:, t].float() if dy is not None
               else torch.zeros((Bt, d), dtype=f32, device=x.device))
        a, sp = gates[t], states[t]
        G = a_next * G + dyt[..., None] * C[:, t].float()[:, None]
        dtt, xt, bt = dt[:, t].float(), x[:, t].float(), B[:, t].float()
        gB = torch.einsum("bdn,bn->bd", G, bt)
        q = G * a * sp
        dx[:, t] = dtt * gB
        ddt[:, t] = (q * Af).sum(-1) + xt * gB
        dA += (dtt[..., None] * q).sum(0)
        dB[:, t] = torch.einsum("bdn,bd->bn", G, dtt * xt)
        dC[:, t] = torch.einsum("bdn,bd->bn", states[t + 1], dyt)
        a_next = a
    ds0 = None if s0 is None else a_next * G
    return dx.to(x.dtype), ddt, dA, dB.to(x.dtype), dC.to(x.dtype), ds0


def bind(lib):
    """``lib`` (a build of ``csrc/selective_scan.cu``) with its entry
    points' ctypes signatures set."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd = [p, ll, ll, p, ll, ll, p, p, ll, ll, p, ll, ll]
    lib.selective_scan_states_launch.argtypes = fwd + [p, p, p, p, i, i, i,
                                                       i, i, p]
    lib.selective_scan_bwd_launch.argtypes = fwd + [
        p, p, ll, ll, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.selective_scan_bwd_workspace.argtypes = [i, i, i, i]
    lib.selective_scan_bwd_workspace.restype = ll
    for fn in (lib.selective_scan_states_launch,
               lib.selective_scan_bwd_launch):
        fn.restype = ctypes.c_int
    return lib


def _lib():
    """The source's library, bound."""
    lib = build.library("selective_scan")
    return lib if lib.selective_scan_states_launch.argtypes else bind(lib)


def _fwd_args(x, dt, A, B, C):
    return (x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(),
            dt.stride(0), dt.stride(1), A.data_ptr(), B.data_ptr(),
            B.stride(0), B.stride(1), C.data_ptr(), C.stride(0),
            C.stride(1))


def _check_device(what, tensors):
    tensors = [t for t in tensors if t is not None]
    x = tensors[0]
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        devices = sorted({str(t.device) for t in tensors})
        raise ValueError(f"{what} needs all inputs on one CUDA device, got "
                         f"{devices}")


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def selective_scan_kernel(x, dt, A, B, C, s0: Optional[torch.Tensor] = None,
                          *, chunk_states: bool = False):
    """Launch the CUDA kernel on CUDA tensors; raises on what it does not
    take. With ``chunk_states`` it also returns the state before each
    32-step chunk, (Bt, ceil(T / 32), d, N) fp32, which
    :func:`selective_scan_bwd_kernel` reads; y and the final state keep
    their bits. ``selective_scan_kernel.launches`` counts the launches."""
    _check_device("selective_scan_kernel", (x, dt, A, B, C, s0))
    check_inputs(x, dt, A, B, C, s0)
    Bt, T, d = x.shape
    N = A.shape[-1]
    y = torch.empty((Bt, T, d), dtype=x.dtype, device=x.device)
    s_fin = torch.empty((Bt, d, N), dtype=torch.float32, device=x.device)
    chunks = (torch.empty((Bt, -(-T // CHUNK), d, N), dtype=torch.float32,
                          device=x.device) if chunk_states else None)
    err = _lib().selective_scan_states_launch(
        *_fwd_args(x, dt, A, B, C), _ptr(s0), y.data_ptr(), s_fin.data_ptr(),
        _ptr(chunks), Bt, T, d, N, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "selective_scan_kernel")
    selective_scan_kernel.launches += 1
    return (y, s_fin, chunks) if chunk_states else (y, s_fin)


selective_scan_kernel.launches = 0


def selective_scan_bwd_kernel(x, dt, A, B, C, chunks, dy, *,
                              s0: Optional[torch.Tensor] = None,
                              ds_fin: Optional[torch.Tensor] = None):
    """Launch the backward kernel on CUDA tensors: from the forward's
    inputs, its ``chunks`` (``selective_scan_kernel(...,
    chunk_states=True)``) and the cotangents ``dy`` (Bt, T, d) in x's
    dtype and ``ds_fin`` (Bt, d, N) fp32 or None, the gradients (dx, ddt,
    dA, dB, dC, ds0) as :func:`selective_scan_bwd_plain` gives them, ds0
    None where s0 is. Two calls give the same bits.
    ``selective_scan_bwd_kernel.launches`` counts the calls (each makes
    four launches: every chunk's walk from zero, the carry of dL/ds down
    the chunks, every chunk's walk from its carry, the sum of the
    partials; the first is left out when T is one chunk and s0 is
    None)."""
    _check_device("selective_scan_bwd_kernel",
                  (x, dt, A, B, C, chunks, dy, s0, ds_fin))
    check_inputs(x, dt, A, B, C, s0)
    Bt, T, d = x.shape
    N = A.shape[-1]
    f32 = torch.float32
    if (dy.dtype != x.dtype or dy.shape != x.shape or dy.stride(-1) != 1
            or chunks.dtype != f32
            or chunks.shape != (Bt, -(-T // CHUNK), d, N)
            or not chunks.is_contiguous()
            or (ds_fin is not None and (ds_fin.dtype != f32
                                        or ds_fin.shape != (Bt, d, N)
                                        or not ds_fin.is_contiguous()))):
        raise ValueError(
            f"selective_scan_bwd_kernel: dy {dy.dtype} {tuple(dy.shape)} "
            f"(x's dtype and shape, unit channel stride), chunk states "
            f"{chunks.dtype} {tuple(chunks.shape)} (contiguous fp32 (Bt, "
            f"ceil(T / {CHUNK}), d, N))"
            + ("" if ds_fin is None else
               f", ds_fin {ds_fin.dtype} {tuple(ds_fin.shape)} (contiguous"
               f" fp32 (Bt, d, N))"))
    lib = _lib()
    dev = x.device
    dx = torch.empty((Bt, T, d), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bt, T, d), dtype=f32, device=dev)
    dA = torch.empty((d, N), dtype=f32, device=dev)
    dB, dC = (torch.empty((Bt, T, N), dtype=x.dtype, device=dev)
              for _ in range(2))
    ds0 = None if s0 is None else torch.empty((Bt, d, N), dtype=f32,
                                              device=dev)
    ws = torch.empty(max(1, lib.selective_scan_bwd_workspace(Bt, T, d, N)),
                     dtype=f32, device=dev)
    err = lib.selective_scan_bwd_launch(
        *_fwd_args(x, dt, A, B, C), chunks.data_ptr(), dy.data_ptr(),
        dy.stride(0), dy.stride(1), _ptr(ds_fin), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        _ptr(ds0), ws.data_ptr(), Bt, T, d, N, _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "selective_scan_bwd_kernel")
    selective_scan_bwd_kernel.launches += 1
    return dx, ddt, dA, dB, dC, ds0


selective_scan_bwd_kernel.launches = 0


class SelectiveScan(torch.autograd.Function):
    """The differentiable scan of the training path: (x, dt, A, B, C, s0)
    -> (y, final state). Its forward runs :func:`selective_scan_kernel`
    and saves the chunk states beside its inputs (``save_for_backward``,
    so a rematerialized block keeps them only for its own backward); its
    backward runs :func:`selective_scan_bwd_kernel`. With ``plain`` or on
    CPU tensors it runs the plain versions of both instead."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, s0, plain: bool):
        ctx.set_materialize_grads(False)
        ctx.plain = plain or x.device.type == "cpu"
        if ctx.plain:
            y, s_fin = selective_scan_plain(x, dt, A, B, C, s0)
            chunks = None
        else:
            y, s_fin, chunks = selective_scan_kernel(x, dt, A, B, C, s0,
                                                     chunk_states=True)
        ctx.save_for_backward(x, dt, A, B, C, s0, chunks)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, ds_fin) -> Tuple:
        x, dt, A, B, C, s0, chunks = ctx.saved_tensors
        if dy is None and ds_fin is None:
            return (None,) * 7
        if ctx.plain:
            grads = selective_scan_bwd_plain(x, dt, A, B, C, dy, s0, ds_fin)
        else:
            dy = (torch.zeros_like(x) if dy is None
                  else dy.contiguous() if dy.stride(-1) != 1 else dy)
            grads = selective_scan_bwd_kernel(
                x, dt, A, B, C, chunks, dy, s0=s0,
                ds_fin=None if ds_fin is None else ds_fin.contiguous())
        return (*grads, None)
