"""ctypes bindings for the native runtime library (native/sc_native.cpp).

Copy of scx.native, which imports no JAX: it loads the repository's
native/libscnative.so (built by native/Makefile), which is no part of
the JAX package. Without the library the pure-Python codec of
scx_torch.world.format is used, a host-side fallback that hides no device.

The reference's data plane (sector codec, importers, streaming workers) is
C++; this module loads the equivalent library and exposes it to the
host runtime.  Everything has a pure-Python fallback (scx_torch.world.format /
scx_torch.world.procgen) — the native path is an acceleration, not a requirement,
and both are bit-compatible (tested against each other).

Build: `make -C native` (done automatically on first import when a compiler
is available).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_SO = os.path.join(_NATIVE_DIR, "libscnative.so")


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def load():
    """Returns the loaded library or None (fallbacks used)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.scn_mix32.restype = ctypes.c_uint32
    lib.scn_mix32.argtypes = [ctypes.c_uint32]
    lib.scn_hash_coord_seed.restype = ctypes.c_uint32
    lib.scn_hash_coord_seed.argtypes = [ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32]
    lib.scn_fnv1a64.restype = ctypes.c_uint64
    lib.scn_fnv1a64.argtypes = [ctypes.c_char_p]
    lib.scn_parse_sector_instances.restype = ctypes.c_int32
    lib.scn_parse_sector_instances.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32,
    ]
    lib.scn_generate_sector_spawns.restype = ctypes.c_int32
    lib.scn_generate_sector_spawns.argtypes = [
        ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    _LIB = lib
    return _LIB


def parse_sector_instances(data: bytes, cap: int = 4096):
    """Native sector-instance parse -> (coord, transforms [n,9], ids [n,4])
    or None when the library is unavailable / input malformed."""
    lib = load()
    if lib is None:
        return None
    coord = np.zeros(2, np.int32)
    transforms = np.zeros((cap, 9), np.float32)
    ids = np.zeros((cap, 4), np.uint64)
    n = lib.scn_parse_sector_instances(
        data, len(data),
        coord.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        transforms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cap,
    )
    if n < 0:
        return None
    return (int(coord[0]), int(coord[1])), transforms[:n], ids[:n]


def generate_sector_spawns(seed, sx, sz, sector_size=64.0, props_min=12,
                           props_max=24, ground_plane=True, cap=256):
    """Native procedural spawn bake -> (transforms [n,9], kind [n]) or None."""
    lib = load()
    if lib is None:
        return None
    transforms = np.zeros((cap, 9), np.float32)
    kind = np.zeros(cap, np.int32)
    n = lib.scn_generate_sector_spawns(
        seed, sx, sz, sector_size, props_min, props_max, int(ground_plane),
        transforms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        kind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
    )
    return transforms[:n], kind[:n]
