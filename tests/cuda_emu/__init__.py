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


def compile_source(name, tmp):
    """``csrc/<name>.cu`` built with g++ into ``tmp`` and loaded: each
    launch ``k<<<g, b, s, st>>>(args)`` becomes ``emu::launch(g, b, s,
    st, k, args)`` and each ``extern __shared__ T x[];`` a pointer into
    the launch's dynamic shared memory. Skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(",
                 r"emu::launch(\2, \1, ", (CSRC / f"{name}.cu").read_text(),
                 flags=re.S)
    src = re.sub(r"extern __shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+"
                 r"(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::dyn_smem);", src)
    cpp, lib = tmp / f"{name}.cpp", tmp / f"{name}.so"
    cpp.write_text(src)
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    f"-I{EMU}", f"-I{CSRC}", "-o", str(lib), str(cpp),
                    "-lpthread"], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))
