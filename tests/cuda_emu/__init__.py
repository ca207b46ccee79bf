"""Compile a kernel source of ``csrc/`` for the CPU against the stand-ins
beside this file (``cuda_runtime.h``, ``cuda_bf16.h``) and load it."""
import ctypes
import pathlib
import re
import shutil
import subprocess

import pytest

EMU = pathlib.Path(__file__).resolve().parent
CSRC = EMU.parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


def _rewrite(src):
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(",
                 r"emu::launch(\2, \1, ", src, flags=re.S)
    return re.sub(r"extern __shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+"
                  r"(\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu::dyn_smem);", src)


def compile_source(name, tmp):
    """``csrc/<name>.cu`` built with g++ into ``tmp`` and loaded: in it and
    in the headers of ``csrc/`` (rewritten copies in ``tmp``) each launch
    ``k<<<g, b, s, st>>>(args)`` becomes ``emu::launch(g, b, s, st, k,
    args)`` and each ``extern __shared__ T x[];`` a pointer into the
    launch's dynamic shared memory. Skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    for header in CSRC.glob("*.cuh"):
        (tmp / header.name).write_text(_rewrite(header.read_text()))
    cpp, lib = tmp / f"{name}.cpp", tmp / f"{name}.so"
    cpp.write_text(_rewrite((CSRC / f"{name}.cu").read_text()))
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-I{EMU}", f"-I{tmp}", "-o", str(lib), str(cpp),
                    "-lpthread"], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))
