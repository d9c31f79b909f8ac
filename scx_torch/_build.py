"""Build and load the port's CUDA kernels.

`nvcc` compiles every `scx_torch/*/csrc/*.cu` (one process per source, all
started together) and links them into one shared library with a plain C
interface, under build/scx_torch/ at the root of the checkout, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once. ctypes loads it. The build happens at first
use; it needs the CUDA toolkit and raises without it. The compiler's
report (`-Xptxas -v`: registers, spills, shared memory per kernel) is
kept beside the library as a .log file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "scx_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3",
    "--fmad=false",  # round every product like the plain PyTorch version
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def sources() -> list[Path]:
    return sorted(_PKG.glob("*/csrc/*.cu"))


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
    for src in sorted(_PKG.glob("*/csrc/*.cu*")):  # kernels and their headers
        h.update(str(src.relative_to(_PKG)).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libscx_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, o in zip(sources(), objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{tag}.tmp")
    failed = [src.name for src, p in zip(sources(), procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, check=False)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = ["link"]
    out.with_suffix(".log").write_text("".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{''.join(logs)[-4000:]}")
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
    lib.scx_planar_middle_prepare.argtypes = [i32, ctypes.c_longlong, ctypes.POINTER(i32)]
    lib.scx_planar_middle_prepare.restype = i32
    lib.scx_planar_middle_occupancy.argtypes = [i32, ctypes.c_longlong, ctypes.POINTER(i32)]
    lib.scx_planar_middle_occupancy.restype = i32
    lib.scx_planar_layout.argtypes = [ctypes.POINTER(i32)]
    lib.scx_planar_layout.restype = None
    lib.scx_planar_sat.argtypes = [vp] * 4 + [i32] * 4 + [vp]
    lib.scx_planar_sat.restype = i32
    lib.scx_planar_sat_occupancy.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.scx_planar_sat_occupancy.restype = i32
    lib.scx_planar_solve.argtypes = [vp] * 7 + [i32] * 4 + [vp]
    lib.scx_planar_solve.restype = i32
    lib.scx_planar_solve_smem_bytes.argtypes = [i32, i32]
    lib.scx_planar_solve_smem_bytes.restype = ctypes.c_longlong
    lib.scx_planar_solve_prepare.argtypes = [ctypes.c_longlong, ctypes.POINTER(i32)]
    lib.scx_planar_solve_prepare.restype = i32
    lib.scx_planar_solve_occupancy.argtypes = [ctypes.c_longlong, ctypes.POINTER(i32)]
    lib.scx_planar_solve_occupancy.restype = i32
    lib.scx_raster_clusters.argtypes = [vp] * 7 + [i32] * 9 + [vp]
    lib.scx_raster_clusters.restype = i32
    lib.scx_raster_tiles.argtypes = [vp] * 5 + [i32] * 7 + [vp]
    lib.scx_raster_tiles.restype = i32
    return lib
