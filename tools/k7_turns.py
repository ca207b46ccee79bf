#!/usr/bin/env python3
"""K7 (MLA's absorbed decode) timed in turns against other versions of its
source, on one CUDA card.

    python3 tools/k7_turns.py [--profile] [--mma-rate] NAME=src.cu[@FLAGS]...

from the root of a checkout. Each ``NAME=path`` is a version of
``mla_decode.cu`` with the same C entries ``mla_decode_launch`` and
``mla_decode_workspace``: an earlier commit's source (the checkout on the
card is no git repository, so write it out first, e.g. ``git show
1175b00:src/repro_torch/kernels/csrc/mla_decode.cu >
build/check/k7_pr33.cu``), or a variant of this one, built with the
``-D`` options given after an ``@``. Each is built with the port's nvcc
flags into a temporary directory outside the checkout and loaded beside
the checkout's own build, "new" (``kernels/build.py``).

At each of ``chip_smoke.py``'s MLA_DECODE_SHAPES, with float32 and bf16
caches, every version runs on the same inputs at every position of
MLA_DECODE_POSITIONS and each split edge of the new source: it is held to
the plain version (MLA_DECODE_TOL) and two calls to each other, bitwise.
Then, at the cache's last row, each version's device time (100 calls in a
replayed CUDA graph) and the plain version's, in turns: new, the others in
order, the others reversed, new. Prints the bounds beside them: the fp32
CUDA cores' (``chip_smoke.bound``) and the tensor cores' in split TF32
(three TF32 products per fp32 one, two for a bf16 cache, at 495 TFLOP/s,
against the same bytes). ``--profile`` also prints the device time of each
of the new source's two launches (``torch.profiler``). ``--mma-rate``
first measures the issue rate of mma.sync m16n8k8 in TF32 on the card
(``tools/mma_rate.cu``: 8 independent MMAs a warp, 16 warps an SM) and
the fp32 rate that 3 such products per fp32 product give, the ceiling of
K7's products. Prints the card's name and power limit first; exits 1 on
a disagreement.
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
from repro_torch.kernels import build, mla_decode as k7  # noqa: E402


def compile_version(name, spec, tmp, bind=True):
    """``path[@FLAGS]`` built as the port builds its own sources, into
    ``tmp``."""
    src, _, flags = spec.partition("@")
    out = tmp / f"{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags.split(),
                    f"-I{build.CSRC}", "-o", str(out), str(Path(src))],
                   check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out))
    return k7.bind(lib) if bind else lib


def mma_rate(tmp):
    """mma.sync m16n8k8 TF32 on the card: MMAs per SM per clock (at the SM
    clock nvidia-smi reads after the run) and TFLOP/s."""
    lib = compile_version("mma_rate", str(ROOT / "tools" / "mma_rate.cu"),
                          tmp, bind=False)
    lib.mma_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 2 * n_sm, 256, 4096
    out = torch.empty(blocks * threads, device="cuda")

    def run():
        build.check(lib.mma_rate_launch(
            out.data_ptr(), iters, blocks, threads,
            torch.cuda.current_stream().cuda_stream), "mma_rate_launch")
    ms = cs.cuda_ms(run, 5, 2)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    n_mma = blocks * threads // 32 * iters * 8
    per_clock = n_mma / n_sm / (ms * 1e-3 * clock * 1e6)
    tflops = n_mma * 2 * 16 * 8 * 8 / ms / 1e9
    print(f"mma.sync m16n8k8 TF32: {per_clock:.3f} an SM a clock at "
          f"{clock:.0f} MHz, {tflops:.1f} TFLOP/s TF32, {tflops / 3:.1f} "
          f"TFLOP/s of fp32 products in 3xTF32 ({ms * 1e3:.1f} us for "
          f"{n_mma} MMAs)", flush=True)


def profile(call):
    """Device µs of each kernel of one call (mean over 20 calls)."""
    from torch.profiler import ProfilerActivity, profile as prof
    call()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    for e in p.key_averages():
        if e.device_type.name == "CUDA" and e.count:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            print(f"    {e.key[:60]}: {us / 20:.2f} us a call "
                  f"({e.count // 20} a call)", flush=True)


def main(argv) -> int:
    flags = {"--profile", "--mma-rate"}
    specs = [a.split("=", 1) for a in argv if a not in flags]
    print(cs.nvidia_smi(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="k7_turns_"))
    try:
        if "--mma-rate" in argv:
            mma_rate(tmp)
        libs = {"new": k7._lib()}
        for name, spec in specs:
            libs[name] = compile_version(name, spec, tmp)
        order = ["new", "plain", *list(libs)[1:]]
        order += order[:0:-1] + ["new"]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        ok = True
        for dtype in (torch.float32, torch.bfloat16):
            for label, B, H, S in cs.MLA_DECODE_SHAPES:
                args = cs.mla_decode_inputs(gen, B, H, S, dtype)
                split = k7.split_keys(H)
                positions = sorted({*cs.MLA_DECODE_POSITIONS, split - 1,
                                    split, 2 * split - 1})
                print(f"{cs.dtype_name(dtype)} {label} (B {B}, {H} heads, "
                      f"{S} rows; new splits of {split} keys), positions "
                      f"{' '.join(map(str, positions))}:", flush=True)
                for name, lib in libs.items():
                    worst, same = 0.0, True
                    for idx in positions:
                        pos = torch.full((B,), idx, dtype=torch.int32,
                                         device="cuda")
                        got = k7.launch(lib, *args, pos, scale=cs.MLA_SCALE)
                        again = k7.launch(lib, *args, pos,
                                          scale=cs.MLA_SCALE)
                        same &= torch.equal(got, again)
                        want = k7.mla_decode_plain(*args, pos,
                                                   scale=cs.MLA_SCALE)
                        worst = max(worst, cs.max_err(got, want))
                    fine = same and worst <= cs.MLA_DECODE_TOL
                    ok &= fine
                    print(f"  {name}: max|d| from plain {worst:.2e} (tol "
                          f"{cs.MLA_DECODE_TOL:g}), two calls "
                          f"{'bitwise equal' if same else 'DIFFER'}"
                          f"{'' if fine else ' FAIL'}", flush=True)
                pos = torch.full((B,), S - 1, dtype=torch.int32,
                                 device="cuda")

                def call(name):
                    if name == "plain":
                        return lambda: k7.mla_decode_plain(
                            *args, pos, scale=cs.MLA_SCALE)
                    return lambda: k7.launch(libs[name], *args, pos,
                                             scale=cs.MLA_SCALE)
                times = [(name, cs.graph_ms(call(name), 100))
                         for name in order]
                nbytes, n_ops = cs.mla_decode_work(B, H, S,
                                                   args[2].element_size())
                b = cs.bound(nbytes, n_ops, torch.float32)
                tc = cs.split_tf32_bound(nbytes, n_ops, dtype)
                print("  in turns: " + ", ".join(
                    f"{n} {ms * 1e3:.2f} us" for n, ms in times), flush=True)
                print(f"  bounds: CUDA cores {b['bound_ms'] * 1e3:.3f} us "
                      f"({b['bound_by']}), tensor cores in split TF32 "
                      f"{tc['bound_ms'] * 1e3:.3f} us ({tc['bound_by']})",
                      flush=True)
                if "--profile" in argv:
                    profile(call("new"))
                del args
        return 0 if ok else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
