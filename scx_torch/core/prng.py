"""Counter hashes of scx.core.prng, in two halves.

The host half (mix32, hash_coord_seed, Rand01, fnv1a64, asset_id_from_path)
is scx's exact Python-integer code, copied: the procedural content is
seeded from it. The torch half (jmix32 / jhash_coord_seed / jrand01)
computes the device versions on tensors: torch has no usable uint32
arithmetic, so values are uint32 held in int64 and masked with 0xFFFFFFFF
after every multiply and add. Products are split into 16-bit halves so
that no intermediate leaves int64. Results are bit-identical to scx's.
"""

from __future__ import annotations

import posixpath

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_U32 = _M32
_U64 = 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# host versions (exact Python integers)
# ---------------------------------------------------------------------------

def mix32(x: int) -> int:
    """lowbias32 integer hash (reference: sc_world_partition.cpp:34-42)."""
    x &= _U32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _U32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _U32
    x ^= x >> 16
    return x


def hash_coord_seed(seed: int, x: int, z: int) -> int:
    """Per-sector seed from world seed + coord (sc_world_partition.cpp:44-51)."""
    h = seed & _U32
    h ^= mix32((x * 73856093) & _U32)
    h ^= mix32((z * 19349663) & _U32)
    h = mix32((h + 0x9E3779B9) & _U32)
    return h


class Rand01:
    """Stateful uniform [0,1] stream matching reference rand01
    (sc_world_partition.cpp:53-57): state = mix32(state + 0x6d2b79f5);
    value = float(state & 0xFFFFFF) / 16777215."""

    __slots__ = ("state",)

    def __init__(self, state: int):
        self.state = state & _U32

    def next(self) -> float:
        self.state = mix32((self.state + 0x6D2B79F5) & _U32)
        return np.float32(self.state & 0x00FFFFFF) / np.float32(16777215.0)

    def next_u32(self) -> int:
        self.state = mix32((self.state + 0x6D2B79F5) & _U32)
        return self.state


def fnv1a64(text: str | bytes) -> int:
    """FNV-1a 64-bit hash (reference: sc_paths.cpp:96-104)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    h = 1469598103934665603
    for b in text:
        h ^= b
        h = (h * 1099511628211) & _U64
    return h


def normalize_path_for_id(path: str) -> str:
    """Lowercased, lexically-normalized generic path (sc_paths.cpp:80-93)."""
    p = path.replace("\\", "/")
    p = posixpath.normpath(p) if p else p
    if p == ".":
        p = ""
    return p.lower()


def asset_id_from_path(path: str) -> int:
    """AssetId = fnv1a64(normalized path) (sc_world_partition.cpp:64-69)."""
    if not path:
        return 0
    return fnv1a64(normalize_path_for_id(path))


# ---------------------------------------------------------------------------
# torch versions (uint32 bits held in int64)
# ---------------------------------------------------------------------------


def _u32(x, device=None) -> torch.Tensor:
    """Any integer (tensor, int, negative int32) as its uint32 bits in int64."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    hi = ((x * (c >> 16)) & _M32) << 16
    return (hi + x * (c & 0xFFFF)) & _M32


def jmix32(x) -> torch.Tensor:
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def jhash_coord_seed(seed, x, z) -> torch.Tensor:
    h = _u32(seed)
    h = h ^ jmix32(_mul32(_u32(x), 73856093))
    h = h ^ jmix32(_mul32(_u32(z), 19349663))
    return jmix32((h + 0x9E3779B9) & _M32)


def jrand01(state):
    """Functional step of the rand01 stream: returns (new_state, value f32)."""
    state = jmix32((_u32(state) + 0x6D2B79F5) & _M32)
    value = (state & 0x00FFFFFF).to(torch.float32) / 16777215.0
    return state, value
