"""State of the JAX package, as numpy arrays, into the port's dataclasses.

Inputs are the numpy pytrees that `jax.tree.map(np.asarray, x)` gives for
scx's RigidBodies, PlanarBodies and PlanarCache (any leading fleet dims),
MeshPool, DrawList, Materials and MipTextures, and any object with
SolverParams' or RasterParams' attributes. Fields are read by attribute,
so this module needs neither jax nor scx. Nothing here has learned
weights: this state and scene data is what carries across. Tensors go to
`device`, the card unless the caller names another.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.physics.planar import PlanarBodies, PlanarCache
from scx_torch.physics.planes import Q4, V3
from scx_torch.physics.rigid import RigidBodies
from scx_torch.physics.solver import SolverParams
from scx_torch.render.mesh import MeshPool
from scx_torch.render.pipeline import DrawList, Materials, MipTextures, RasterParams

_WIDE = ("layer", "mask")  # u32 in scx, int64 here


def _tensor(a, device, name=""):
    a = np.asarray(a)
    if name in _WIDE:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _convert(cls, src, device):
    device = resolve_device(device)
    out = {}
    for f in fields(cls):
        v = getattr(src, f.name)
        if isinstance(v, (bool, int, float)):  # static fields (sizes, flags)
            out[f.name] = v
        elif isinstance(v, tuple):  # scx's V3 / Q4 component planes
            kind = V3 if len(v) == 3 else Q4
            out[f.name] = kind(*(_tensor(c, device) for c in v))
        else:
            out[f.name] = _tensor(v, device, f.name)
    return cls(**out)


def rigid_bodies(b, device=None) -> RigidBodies:
    return _convert(RigidBodies, b, device)


def planar_bodies(p, device=None) -> PlanarBodies:
    return _convert(PlanarBodies, p, device)


def planar_cache(c, device=None) -> PlanarCache:
    return _convert(PlanarCache, c, device)


def solver_params(p) -> SolverParams:
    return SolverParams(**{
        f.name: (tuple(getattr(p, f.name)) if f.name == "shape_kinds"
                 else getattr(p, f.name))
        for f in fields(SolverParams)
    })


def mesh_pool(p, device=None) -> MeshPool:
    return _convert(MeshPool, p, device)


def draw_list(d, device=None) -> DrawList:
    return _convert(DrawList, d, device)


def materials(m, device=None) -> Materials:
    return _convert(Materials, m, device)


def mip_textures(t, device=None) -> MipTextures:
    return _convert(MipTextures, t, device)


def raster_params(p) -> RasterParams:
    return RasterParams(**{f.name: getattr(p, f.name) for f in fields(RasterParams)})
