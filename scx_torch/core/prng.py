"""Counter hashes of scx.core.prng (jmix32 / jhash_coord_seed / jrand01).

torch has no usable uint32 arithmetic, so values are uint32 held in int64
and masked with 0xFFFFFFFF after every multiply and add. Products are
split into 16-bit halves so that no intermediate leaves int64. Results are
bit-identical to the JAX versions.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


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
