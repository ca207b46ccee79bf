#!/usr/bin/env python3
"""K6's backward timed in turns against other versions of its source, on
one CUDA card.

    python3 tools/k6_bwd_turns.py [--profile] NAME=path/to/source.cu ...

from the root of a checkout. Each ``NAME=path`` is a version of
``selective_scan.cu`` with the same C entries ``selective_scan_bwd_launch``
and ``selective_scan_bwd_workspace`` (an earlier commit's source, or a
variant of this one); it is built with the port's nvcc flags into a
temporary directory outside the checkout and loaded beside the
checkout's own source, "new" (built by ``kernels/build.py``). At each of
``chip_smoke.py``'s SCAN_BWD_SHAPES, in float32 and bfloat16, every
version runs on the same inputs and the same chunk states (the
checkout's forward): its gradients are held to the plain version's
(SCAN_TOL of each gradient's largest entry) and two calls to each other,
bitwise. Then each version's device time (20 calls in a replayed CUDA
graph) in turns: new, the others in order, the others reversed, new.
``--profile`` also prints the device time of each of the checkout's
launches (``torch.profiler``). Prints the card's name and power limit
first; exits 1 on a disagreement.
"""
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from repro_torch.kernels import build, selective_scan as k6  # noqa: E402

N = 16


def compile_version(name, src, tmp):
    """``src`` built as the port builds its own sources, into ``tmp``."""
    out = tmp / f"{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
                    "-o", str(out), str(src)], check=True)
    return k6.bind(ctypes.CDLL(str(out)))


def backward(lib, x, dt, A, B, C, chunks, dy):
    """The wrapper's call through ``lib``: (dx, ddt, dA, dB, dC)."""
    Bt, T, d = x.shape
    dev = x.device
    dx = torch.empty_like(x)
    ddt = torch.empty((Bt, T, d), dtype=torch.float32, device=dev)
    dA = torch.empty((d, N), dtype=torch.float32, device=dev)
    dB, dC = (torch.empty((Bt, T, N), dtype=x.dtype, device=dev)
              for _ in range(2))
    ws = torch.empty(max(1, lib.selective_scan_bwd_workspace(Bt, T, d, N)),
                     dtype=torch.float32, device=dev)
    err = lib.selective_scan_bwd_launch(
        *k6._fwd_args(x, dt, A, B, C), chunks.data_ptr(), dy.data_ptr(),
        dy.stride(0), dy.stride(1), None, dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), None, ws.data_ptr(),
        Bt, T, d, N, k6._DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "selective_scan_bwd_launch")
    return dx, ddt, dA, dB, dC


def profile(lib, args):
    """Device µs of each kernel of one call (mean over 10 calls)."""
    from torch.profiler import ProfilerActivity, profile as prof
    backward(lib, *args)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(10):
            backward(lib, *args)
        torch.cuda.synchronize()
    for e in p.key_averages():
        if e.device_type.name == "CUDA" and e.count:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            print(f"    {e.key[:70]}: {us / 10:.2f} us a call "
                  f"({e.count // 10} a call)", flush=True)


def main(argv) -> int:
    do_profile = "--profile" in argv
    specs = [a.split("=", 1) for a in argv if a != "--profile"]
    print(cs.nvidia_smi(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="k6_bwd_turns_"))
    try:
        libs = {"new": k6._lib()}
        for name, src in specs:
            libs[name] = compile_version(name, Path(src), tmp)
        order = list(libs) + list(libs)[:0:-1] + ["new"]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        ok = True
        for dtype in (torch.float32, torch.bfloat16):
            for label, Bt, T, d in cs.SCAN_BWD_SHAPES:
                x, dt, A, B, C, _ = cs.scan_inputs(gen, Bt, T, d, N, dtype,
                                                   False)
                dy = torch.randn((Bt, T, d), generator=gen, device="cuda"
                                 ).to(dtype)
                _, _, chunks = k6.selective_scan_kernel(x, dt, A, B, C,
                                                        chunk_states=True)
                args = (x, dt, A, B, C, chunks, dy)
                want = k6.selective_scan_bwd_plain(x, dt, A, B, C, dy)
                print(f"{cs.dtype_name(dtype)} {label} (Bt {Bt}, T {T}, d "
                      f"{d}):", flush=True)
                for name, lib in libs.items():
                    got, again = backward(lib, *args), backward(lib, *args)
                    same = all(map(torch.equal, got, again))
                    errs = [cs.max_err(g, w) / float(w.float().abs().max())
                            for g, w in zip(got, want[:5])]
                    fine = same and max(errs) <= cs.SCAN_TOL[dtype]
                    ok &= fine
                    print(f"  {name}: max err / max|plain| {max(errs):.2e} "
                          f"(dx ddt dA dB dC: "
                          f"{' '.join(f'{e:.1e}' for e in errs)}), two "
                          f"calls {'bitwise equal' if same else 'DIFFER'}"
                          f"{'' if fine else ' FAIL'}", flush=True)
                times = [(name, cs.graph_ms(lambda: backward(libs[name],
                                                             *args), 20))
                         for name in order]
                print("  in turns: " + ", ".join(
                    f"{n} {ms * 1e3:.2f} us" for n, ms in times), flush=True)
                if do_profile:
                    profile(libs["new"], args)
                del args, chunks, want
        return 0 if ok else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
