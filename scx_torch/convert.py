"""State of the JAX package, as numpy arrays, into the port's dataclasses.

Inputs are the numpy pytrees that `jax.tree.map(np.asarray, x)` gives for
scx's RigidBodies, PlanarBodies, PlanarCache, PlanarContacts, ContactCache
and Contacts (any leading fleet dims; the port's conventional step takes
them with a leading env axis), EntityState (with a leading env axis), LaneArrays, MeshPool, DrawList,
Materials and MipTextures, the policy parameter dicts of
examples/train_ppo.py, and any object with SolverParams', RasterParams'
or SimParams' attributes. Fields are read by attribute,
so this module needs neither jax nor scx. Nothing here has learned
weights: this state and scene data is what carries across. Tensors go to
`device`, the card unless the caller names another.

The sandbox's state carries across through files instead: its save-game
(scx_torch.app.checkpoint, used by Sandbox.save_game / load_game) writes
and reads scx's own format, so a save written by scx's Sandbox loads into
the port's and one written by the port loads into scx's.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.physics.contacts import Contacts
from scx_torch.physics.planar import PlanarBodies, PlanarCache, PlanarContacts
from scx_torch.physics.planes import Q4, V3
from scx_torch.physics.rigid import RigidBodies
from scx_torch.physics.solver import SolverParams
from scx_torch.physics.warmstart import ContactCache
from scx_torch.render.mesh import MeshPool
from scx_torch.app.sandbox import SimParams
from scx_torch.physics.vehicle import VehicleParams
from scx_torch.render.pipeline import DrawList, Materials, MipTextures, RasterParams
from scx_torch.state import entity as ent
from scx_torch.traffic.lanes import LaneArrays

_WIDE = ("layer", "mask", "generation", "components", "name_hash")  # u32 in scx, int64 here


_GROUPS = {"transform": ent.TransformState, "render": ent.RenderState, "body": ent.BodyState,
           "traffic": ent.TrafficState, "vehicle": ent.VehicleState}


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
        if cls is ent.EntityState and f.name in _GROUPS:  # nested column groups
            out[f.name] = _convert(_GROUPS[f.name], v, device)
        elif isinstance(v, (bool, int, float)):  # static fields (sizes, flags)
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


def planar_contacts(c, device=None) -> PlanarContacts:
    return _convert(PlanarContacts, c, device)


def contact_cache(c, device=None) -> ContactCache:
    return _convert(ContactCache, c, device)


def contacts(c, device=None) -> Contacts:
    return _convert(Contacts, c, device)


def numpy_tree(x):
    """The way back: a port dataclass (nested, with V3 / Q4 planes), tuple,
    list or dict of tensors as the same structure of numpy arrays, with
    dataclasses as dicts by field name, for a test to hand to scx."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (V3, Q4)):
        return type(x)(*(numpy_tree(c) for c in x))
    if isinstance(x, (tuple, list)):
        return type(x)(numpy_tree(c) for c in x)
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return {f.name: numpy_tree(getattr(x, f.name)) for f in fields(x)}
    return x


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


def entity_state(s, device=None) -> ent.EntityState:
    """scx's EntityState with a leading env axis ([E, C, ...] columns)."""
    return _convert(ent.EntityState, s, device)


def lane_arrays(l, device=None) -> LaneArrays:
    return _convert(LaneArrays, l, device)


def baked(b, device=None) -> torch.Tensor:
    """Static-bake columns ([E, 26, T] in the RL fleet)."""
    return _tensor(b, resolve_device(device))


def sim_params(p) -> SimParams:
    return SimParams(solver=solver_params(p.solver), vehicle=VehicleParams(
        **{f.name: getattr(p.vehicle, f.name) for f in fields(VehicleParams)}))


def trainable(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` as a leaf that autograd tracks (a policy parameter)."""
    return t.detach().clone().requires_grad_(True)


def policy_arrays(params: dict) -> dict:
    """The port's policy parameters as numpy arrays in scx's layout (conv*
    weights HWIO): what examples/train_ppo.py trains and its .npz holds."""
    return {k: (v.detach().permute(2, 3, 1, 0) if k.startswith("conv") else v.detach())
            .cpu().numpy() for k, v in params.items()}


def policy_params(arrays: dict, device=None) -> dict:
    """scx-layout policy arrays (conv* HWIO) as the port's trainable
    parameters (conv* OIHW, requires_grad) on `device`."""
    device = resolve_device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.array(v, dtype=np.float32))
        if k.startswith("conv"):
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = trainable(t.to(device))
    return out
