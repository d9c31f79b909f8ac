"""Texture helpers of the render path (copy of the numpy-only parts of
scx.assets.textures): the procedural checker texture and packed mip
chains. Mip levels are square powers of two, packed base-first into one
flat buffer; a quad row holds a texel's clamped 2x2 bilinear footprint,
so a bilinear tap is one gather.
"""

from __future__ import annotations

import numpy as np


def checker_texture(size: int = 64, cells: int = 8) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    check = ((yy // (size // cells) + xx // (size // cells)) % 2).astype(np.float32)
    return np.stack([check * 0.9 + 0.1] * 3, -1)


def mip_layout(size: int) -> tuple[list[int], list[int]]:
    """(level offsets, level sizes) for a square power-of-two mip chain
    packed row-major into one flat [sum sz*sz] buffer, base level first.

    The reference has no mips (sc_assets.cpp uploads level 0 only); a
    software rasterizer needs them or minified texture sampling aliases
    badly AND thrashes gathers across the whole base level.  A flat packed
    chain keeps the per-pixel fetch a single [slot, index] gather on TPU
    regardless of the selected level.
    """
    assert size & (size - 1) == 0, "mip chains need power-of-two slots"
    offsets, sizes = [], []
    off = 0
    sz = size
    while sz >= 1:
        offsets.append(off)
        sizes.append(sz)
        off += sz * sz
        sz //= 2
    offsets.append(off)  # total length sentinel
    return offsets, sizes


def build_mip_chain(img: np.ndarray) -> np.ndarray:
    """[S,S,3] base level -> flat [FLAT,3] packed mip chain (2x2 box)."""
    s = img.shape[0]
    offsets, sizes = mip_layout(s)
    flat = np.zeros((offsets[-1], 3), np.float32)
    level = img.astype(np.float32)
    for off, sz in zip(offsets[:-1], sizes):
        flat[off : off + sz * sz] = level.reshape(sz * sz, 3)
        if sz > 1:
            level = 0.25 * (
                level[0::2, 0::2] + level[1::2, 0::2]
                + level[0::2, 1::2] + level[1::2, 1::2]
            )
    return flat


def build_mip_quads(img: np.ndarray) -> np.ndarray:
    """[S,S,3] base level -> flat [FLAT,12] packed mip chain where row
    (v,u) holds the clamped 2x2 bilinear footprint
    [t(v,u), t(v,u+1), t(v+1,u), t(v+1,u+1)].

    TPU gathers move one ROW per index (~190M rows/s measured at 720p), so
    4-tap bilinear costs 4 gathers = ~20 ms/frame.  Storing each texel's
    footprint redundantly (4x memory on small pool slots) folds exact
    bilinear into ONE gather."""
    s = img.shape[0]
    offsets, sizes = mip_layout(s)
    quads = np.zeros((offsets[-1], 12), np.float32)
    level = img.astype(np.float32)
    for off, sz in zip(offsets[:-1], sizes):
        u1 = np.minimum(np.arange(sz) + 1, sz - 1)
        c00 = level
        c10 = level[:, u1]
        c01 = level[u1, :]
        c11 = level[u1][:, u1]
        quads[off : off + sz * sz] = np.concatenate(
            [c00, c10, c01, c11], axis=-1
        ).reshape(sz * sz, 12)
        if sz > 1:
            level = 0.25 * (
                level[0::2, 0::2] + level[1::2, 0::2]
                + level[0::2, 1::2] + level[1::2, 1::2]
            )
    return quads
