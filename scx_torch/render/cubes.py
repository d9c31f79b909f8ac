"""The cube frame: the tile path's scene at 1280x720.

Three cubes on a ground slab that runs behind the camera (so it crosses
the near plane and is clipped), one material each, seen from the eye of
the port's small render scenes, through the tile-binned rasterizer
(use_clusters=False, 64x128 tiles, K = 256: no tile list overflows).
`chip_smoke.py` and `python -m scx_torch.profile_raster` time
`rasterize_tiles` and the tile path's frames on it.
"""

from __future__ import annotations

import torch

from scx_torch import resolve_device
from scx_torch.core import math3d as m3
from scx_torch.render import pipeline as rp
from scx_torch.render.camera import camera_view_proj
from scx_torch.render.mesh import MESH_CUBE, build_mesh_pool


def cube_frame(device=None):
    """(draws, pool, view_proj, params) of the cube frame on `device` (the
    card by default)."""
    device = resolve_device(device)
    t = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)
    models = [m3.mat4_trs(t(0.0, -0.55, -10.0), t(0.0, 0.0, 0.0), t(40.0, 0.1, 40.0))]
    models += [m3.mat4_trs(t(dx, 0.0, dz), t(0.0, a, 0.0), t(1.0, 1.0, 1.0))
               for dx, dz, a in [(0.0, 0.0, 0.3), (1.2, -0.5, 0.9), (-1.0, 0.4, 0.0)]]
    draws = rp.DrawList(
        mesh_id=torch.full((4,), MESH_CUBE, dtype=torch.int32, device=device),
        material_id=torch.arange(4, dtype=torch.int32, device=device),
        model=torch.stack(models),
        valid=torch.ones((4,), dtype=torch.bool, device=device),
    )
    vp = camera_view_proj(t(1.5, 1.2, 2.5), t(0.0, 0.0, 0.0), t(0.0, 1.0, 0.0),
                          aspect=1280 / 720)
    params = rp.RasterParams(width=1280, height=720, max_tris=512, max_tris_per_tile=256,
                             use_clusters=False, clip_extra=128)
    return draws, build_mesh_pool(device=device), vp, params
