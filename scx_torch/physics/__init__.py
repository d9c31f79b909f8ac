"""Rigid-body physics: the conventional step (`solver.step_bodies_cached`,
scx.physics' public API), the plane-layout fleet step (`planar`) with its
kernels, and their parts."""

from scx_torch.physics.rigid import (
    RigidBodies,
    make_bodies,
    inv_inertia_world,
    body_aabbs,
    integrate_velocities,
    integrate_positions,
)
from scx_torch.physics.broadphase import broadphase_pairs
from scx_torch.physics.contacts import generate_contacts, Contacts
from scx_torch.physics.solver import (
    solve_velocity,
    step_bodies,
    step_bodies_cached,
    SolverParams,
)
from scx_torch.physics.warmstart import ContactCache, empty_contact_cache
from scx_torch.physics.queries import raycast, sphere_cast, capsule_cast, RayHit
from scx_torch.physics.vehicle import (
    WheelConfig,
    VehicleParams,
    default_wheel_configs,
    vehicle_forces,
)
