"""Texture loading: PPM (the reference's asset format), PNG/JPG via PIL when
available, and the reference's procedural fallbacks (copy of
scx.assets.textures; only `linear_to_srgb` is ported, to take torch tensors
where scx takes jax arrays).

The reference loads textures through stb_image into RGBA8 and falls back to
a magenta/black checker when a file is missing (sc_assets.cpp:255-298,
803-820) plus a plain white default.  Textures here become float32 [H,W,3]
arrays resampled into fixed-size pool slots (device texture arrays need one
static shape).
"""

from __future__ import annotations

import numpy as np
import torch


def load_ppm(path: str) -> np.ndarray | None:
    """P6 (binary) / P3 (ascii) PPM -> float32 [H,W,3] in [0,1]."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    try:
        tokens: list[bytes] = []
        i = 0
        while len(tokens) < 4:
            # tokenize header, skipping comments
            while i < len(data) and data[i : i + 1].isspace():
                i += 1
            if i < len(data) and data[i : i + 1] == b"#":
                while i < len(data) and data[i : i + 1] != b"\n":
                    i += 1
                continue
            j = i
            while j < len(data) and not data[j : j + 1].isspace():
                j += 1
            tokens.append(data[i:j])
            i = j
        magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
        i += 1  # single whitespace after maxval
        if magic == b"P6":
            raw = np.frombuffer(data, np.uint8, count=w * h * 3, offset=i)
            img = raw.reshape(h, w, 3).astype(np.float32) / float(maxval)
        elif magic == b"P3":
            vals = np.array(data[i:].split()[: w * h * 3], dtype=np.float32)
            img = vals.reshape(h, w, 3) / float(maxval)
        else:
            return None
        return img
    except Exception:
        return None


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode: sRGB-encoded [0,1] -> linear light.

    The reference uploads color art as VK_FORMAT_R8G8B8A8_SRGB so the GPU
    samples in linear light (sc_assets.cpp:197-198); a float pipeline does
    the same transfer explicitly at decode time."""
    img = np.asarray(img, np.float32)
    return np.where(
        img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)


def linear_to_srgb(img):
    """Inverse transfer for the display sink (the swapchain's implicit
    sRGB encode in the reference's present path). Works on numpy arrays or
    torch tensors; returns the same family (a tensor stays on its device)."""
    if isinstance(img, torch.Tensor):
        img = torch.clamp(img, 0.0, 1.0)
        return torch.where(img <= 0.0031308, img * 12.92,
                           1.055 * img ** (1.0 / 2.4) - 0.055)
    img = np.clip(img, 0.0, 1.0)
    return np.where(
        img <= 0.0031308, img * 12.92, 1.055 * img ** (1.0 / 2.4) - 0.055
    )


def load_image(path: str, srgb: bool = False) -> np.ndarray | None:
    """Any supported image -> float32 [H,W,3]; PPM natively, rest via PIL.
    srgb=True decodes the stored values to linear light (color/albedo art;
    data textures stay raw)."""
    if path.lower().endswith(".ppm"):
        img = load_ppm(path)
    else:
        try:
            from PIL import Image

            img = np.asarray(
                Image.open(path).convert("RGB"), np.float32
            ) / 255.0
        except Exception:
            return None
    if img is not None and srgb:
        img = srgb_to_linear(img)
    return img


def fallback_texture(size: int = 64) -> np.ndarray:
    """Magenta/black checker used when a texture is missing
    (sc_assets.cpp:803-820)."""
    yy, xx = np.mgrid[0:size, 0:size]
    check = ((yy // 8 + xx // 8) % 2).astype(np.float32)
    img = np.zeros((size, size, 3), np.float32)
    img[..., 0] = check  # magenta where check==1
    img[..., 2] = check
    return img


def white_texture(size: int = 4) -> np.ndarray:
    return np.ones((size, size, 3), np.float32)


def checker_texture(size: int = 64, cells: int = 8) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    check = ((yy // (size // cells) + xx // (size // cells)) % 2).astype(np.float32)
    return np.stack([check * 0.9 + 0.1] * 3, -1)


def resample_to(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resample into a pool slot [size,size,3]."""
    h, w = img.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return img[ys][:, xs]


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
