"""Build and load the port's CUDA kernels.

`nvcc` compiles the sources under csrc/ (and nothing else) into one shared
library with a plain C interface, under build/scx_torch/ at the root of
the checkout, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once. ctypes loads it. The
build happens at first use; it needs the CUDA toolkit and raises without
it. The compiler's report (`-Xptxas -v`: registers, spills, shared
memory per kernel) is kept beside the library as a .log file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("planar_middle.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "scx_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false",  # round every product like the plain PyTorch version
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels need the CUDA toolkit "
            "(put nvcc on PATH or set CUDA_HOME)"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"libscx_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(_CSRC / s) for s in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.scx_planar_middle.argtypes = [vp] * 11 + [i32] * 5 + [f32] * 5 + [vp]
    lib.scx_planar_middle.restype = i32
    lib.scx_planar_middle_smem_bytes.argtypes = [i32, i32]
    lib.scx_planar_middle_smem_bytes.restype = ctypes.c_longlong
    lib.scx_planar_middle_prepare.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.scx_planar_middle_prepare.restype = i32
    return lib
