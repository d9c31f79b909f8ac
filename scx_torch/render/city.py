"""The city frame: one dense city chunk at 1280x720, street-level camera.

`build_city_frame()` builds, bit for bit, the frame of
benchmarks/bench_city_720p.py (the JAX package's BASELINE config #3):
`build_city_mesh(grid=22, subdiv=4, ground=24, seed=7)` as one draw,
RasterParams(1280, 720, max_tris=131072, max_clusters_per_tile=256,
min_area2=0.25, tile_h=64), the eye/target camera, a 128-texel checker of
16 cells as a mip-mapped texture, and the static bake of the chunk
(morton=False) with an empty dynamic draw list sized by
dyn_params (max_tris=64, clip_extra=32). The keyword arguments cut the
scene and the frame for tests; the defaults are the bench's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.assets import textures as texmod
from scx_torch.render import pipeline as pipe
from scx_torch.render import staticbake as sb
from scx_torch.render.camera import camera_view_proj
from scx_torch.render.cityscene import build_city_mesh
from scx_torch.render.mesh import MeshPool, build_mesh_pool

EYE = (7.0, 2.5, 4.0)
TARGET = (7.0, 2.0, -60.0)
UP = (0.0, 1.0, 0.0)


@dataclass
class CityFrame:
    pool: MeshPool
    draws: pipe.DrawList        # the whole chunk as one identity-model draw
    no_dyn: pipe.DrawList       # the baked frame's (empty) dynamic draws
    baked: torch.Tensor         # [26, T_s] world-space columns of the chunk
    params: pipe.RasterParams
    dyn_params: pipe.RasterParams
    view_proj: torch.Tensor     # [4, 4]
    materials: pipe.Materials
    textures: pipe.MipTextures
    n_tris: int

    def render_baked(self, plain: bool = False):
        """(rgb, gbuffer, stats) through render_frame_baked."""
        return pipe.render_frame_baked(self.baked, self.no_dyn, self.pool, self.view_proj,
                                       self.params, self.dyn_params, self.materials,
                                       self.textures, plain=plain)

    def render(self, plain: bool = False):
        """(rgb, gbuffer, stats) through render_frame."""
        return pipe.render_frame(self.draws, self.pool, self.view_proj, self.params,
                                 self.materials, self.textures, plain=plain)


def _one_draw(valid: bool, device) -> pipe.DrawList:
    return pipe.DrawList(
        mesh_id=torch.zeros((1,), dtype=torch.int32, device=device),
        material_id=torch.zeros((1,), dtype=torch.int32, device=device),
        model=torch.eye(4, device=device)[None],
        valid=torch.full((1,), valid, device=device),
    )


def build_city_frame(device=None, *, grid: int = 22, subdiv: int = 4, ground: int = 24,
                     width: int = 1280, height: int = 720, tile_h: int = 64,
                     tile_w: int = 128, max_tris: int = 131072,
                     max_clusters_per_tile: int = 256) -> CityFrame:
    """The city frame on `device` (the card by default)."""
    device = resolve_device(device)
    verts, tris = build_city_mesh(grid=grid, subdiv=subdiv, ground=ground, seed=7)
    pool = build_mesh_pool([(verts, tris)], device=device)
    params = pipe.RasterParams(width=width, height=height, max_tris=max_tris,
                               max_clusters_per_tile=max_clusters_per_tile,
                               min_area2=0.25, tile_h=tile_h, tile_w=tile_w)
    draws = _one_draw(True, device)
    view_proj = camera_view_proj(torch.tensor(EYE, device=device),
                                 torch.tensor(TARGET, device=device),
                                 torch.tensor(UP, device=device), aspect=width / height)
    materials = pipe.Materials(texture_id=torch.zeros((1,), dtype=torch.int32, device=device),
                               tint=torch.ones((1, 3), device=device))
    base = texmod.checker_texture(128, cells=16)
    textures = pipe.MipTextures(
        quads=torch.from_numpy(texmod.build_mip_quads(base)).to(device)[None], size=128)
    t_s = -(-len(tris) // 128) * 128
    baked = sb.bake_draws(draws, pool, t_s, morton=False)
    return CityFrame(
        pool=pool, draws=draws, no_dyn=_one_draw(False, device), baked=baked,
        params=params, dyn_params=params.replace(max_tris=64, clip_extra=32),
        view_proj=view_proj, materials=materials, textures=textures,
        n_tris=int(np.asarray(tris).shape[0]),
    )
