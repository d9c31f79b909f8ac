"""Physics fleets and a multi-step rollout.

`build_pile_fleet` makes, bit for bit, the scenes that bench.py's
`build_batch` makes for the JAX package (one static slab and N-1 boxes
per env, positions from the scx hash PRNG). `build_mixed_fleet` makes
scenes of boxes, spheres and capsules from numpy, like the mixed scenes
of scx's planar tests. `build_ground_scene` makes the scenes of scx's
solver tests (tests/test_physics_solver.py's make_ground_scene) for the
conventional step.
"""

from __future__ import annotations

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.core import prng
from scx_torch.core.math3d import quat_from_euler_xyz
from scx_torch.physics import planar as pp
from scx_torch.physics.rigid import (
    BODY_DYNAMIC,
    BODY_STATIC,
    SHAPE_CAPSULE,
    SHAPE_SPHERE,
    make_bodies,
)
from scx_torch.physics.solver import SolverParams


def build_pile_fleet(envs: int, bodies: int, device=None) -> pp.PlanarBodies:
    """[envs, bodies] planar scenes on `device` (the card by default).
    Built on the CPU and moved, so every device gets the same bits."""
    device = resolve_device(device)
    seed = prng.jhash_coord_seed(1337, torch.arange(envs), 0)         # [E]
    i = torch.arange(bodies)
    s0 = prng.jmix32((seed[:, None] + i * 0x9E3779B9) & 0xFFFFFFFF)   # [E, B]
    s1, rx = prng.jrand01(s0)
    s2, ry = prng.jrand01(s1)
    _, rz = prng.jrand01(s2)
    pos = torch.stack([(rx - 0.5) * 16.0, 0.6 + ry * 6.0, (rz - 0.5) * 16.0], -1)
    pos[:, 0] = torch.tensor([0.0, -0.55, 0.0])
    size = torch.full((envs, bodies, 3), 0.5)
    size[:, 0] = torch.tensor([16.0, 0.05, 16.0])
    body_type = torch.full((envs, bodies), BODY_DYNAMIC, dtype=torch.int32)
    body_type[:, 0] = BODY_STATIC
    fleet = pp.planar_from_rigid(make_bodies(pos, size=size, body_type=body_type))
    return pp.map_tensors(lambda t: t.contiguous().to(device), fleet)


def build_mixed_fleet(envs: int, bodies: int, seed: int, device=None) -> pp.PlanarBodies:
    """[envs, bodies] scenes: a static slab, then spheres, capsules and boxes
    in turn, at random positions, tilts and velocities from numpy's seeded
    generator, on `device` (the card by default)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    shape_en = (envs, bodies)
    pos = np.stack([rng.uniform(-4, 4, shape_en), rng.uniform(0.5, 4, shape_en),
                    rng.uniform(-4, 4, shape_en)], -1).astype(np.float32)
    pos[:, 0] = [0.0, -0.55, 0.0]
    size = np.full(shape_en + (3,), 0.5, np.float32)
    size[:, 0] = [8.0, 0.05, 8.0]
    shape = np.zeros(shape_en, np.int32)
    shape[:, 1::3] = SHAPE_SPHERE
    shape[:, 2::3] = SHAPE_CAPSULE
    body_type = np.full(shape_en, BODY_DYNAMIC, np.int32)
    body_type[:, 0] = BODY_STATIC
    ang = torch.from_numpy(rng.uniform(-0.5, 0.5, shape_en + (3,)).astype(np.float32))
    quat = quat_from_euler_xyz(ang[..., 0], ang[..., 1], ang[..., 2])
    vel = rng.uniform(-1, 1, shape_en + (3,)).astype(np.float32)
    fleet = pp.planar_from_rigid(make_bodies(
        pos, quat=quat, size=size, shape=shape, body_type=body_type, vel=vel))
    return pp.map_tensors(lambda t: t.contiguous().to(device), fleet)


def build_ground_scene(boxes, n_pad: int = 0, device=None, **columns):
    """One scene [1, N] of tests/test_physics_solver.py's make_ground_scene
    on `device` (the card by default): a static 64 x 0.1 x 64 slab whose
    top is y = -0.5, then unit boxes at `boxes` [k, 3], then n_pad
    inactive rows. `columns` override make_bodies' arguments ([N, ...]
    arrays); the rigid-body layout (RigidBodies), for the conventional
    step."""
    device = resolve_device(device)
    k = len(boxes)
    n = 1 + k + n_pad
    pos = np.zeros((n, 3), np.float32)
    pos[0, 1] = -0.55
    pos[1:1 + k] = boxes
    size = np.full((n, 3), 0.5, np.float32)
    size[0] = (32.0, 0.05, 32.0)
    body_type = np.full(n, BODY_DYNAMIC, np.int32)
    body_type[0] = BODY_STATIC
    cols = dict(size=size, body_type=body_type, active=np.arange(n) < 1 + k)
    cols.update(columns)
    return make_bodies(torch.from_numpy(pos[None]).to(device),
                       **{c: torch.as_tensor(np.asarray(v)[None]).to(device)
                          for c, v in cols.items()})


def rollout(bodies: pp.PlanarBodies, cache: pp.PlanarCache,
            params: SolverParams, steps: int, *, step_fn=pp.step_planar_cached):
    """`steps` fleet steps. Returns (bodies, cache, max pair_overflow over
    every env and step as a 0-d tensor on the fleet's device).

    step_fn(bodies, params, cache) is the step to run: the fused
    `step_planar_cached` (bind its `middle_fn` to run the plain middle) or
    `step_planar_staged`."""
    ovf = torch.zeros((), dtype=torch.int32, device=bodies.shape.device)
    for _ in range(steps):
        bodies, cache, stats = step_fn(bodies, params, cache)
        ovf = torch.maximum(ovf, stats["pair_overflow"].max())
    return bodies, cache, ovf
