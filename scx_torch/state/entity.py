"""Struct-of-arrays entity state (port of scx.state.entity).

A fleet of scenes is one EntityState whose columns carry an explicit
leading env axis: [E, C, ...] for E scenes of capacity C. scx keeps one
scene per pytree and adds the env axis by vmap; here it is written out.
The u32 columns of scx (`generation`, `components`, `name_hash`,
`body.layer`, `body.mask`) are int64 holding the uint32 bits, masked with
0xFFFFFFFF, as scx_torch.physics.rigid does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from scx_torch import resolve_device
from scx_torch.core import memtrack

# body types (sc_physics.h:30-35)
BODY_NONE = -1
BODY_STATIC = 0
BODY_DYNAMIC = 1
BODY_KINEMATIC = 2

# collider shapes (sc_physics.h:10-16)
SHAPE_BOX = 0
SHAPE_SPHERE = 1
SHAPE_CAPSULE = 2

# traffic sim modes (sc_traffic_common.h:11-16); NONE = not a traffic agent
TRAFFIC_NONE = -1
TRAFFIC_PHYSICS = 0
TRAFFIC_KINEMATIC = 1
TRAFFIC_ONRAILS = 2

# component presence bits (the reference's "pool membership")
C_TRANSFORM = 1 << 0
C_RENDER_MESH = 1 << 1
C_BOUNDS = 1 << 2
C_COLLIDER = 1 << 3
C_RIGID_BODY = 1 << 4
C_VEHICLE = 1 << 5
C_VEHICLE_INPUT = 1 << 6
C_PLAYER = 1 << 7
C_CAMERA = 1 << 8
C_WORLD_SECTOR = 1 << 9
C_TRAFFIC = 1 << 10

U32 = 0xFFFFFFFF


@dataclass
class TransformState:
    pos: torch.Tensor        # [E,C,3] f32
    rot: torch.Tensor        # [E,C,4] f32 quaternion (w,x,y,z)
    scale: torch.Tensor      # [E,C,3] f32
    parent: torch.Tensor     # [E,C] i32, -1 = root


@dataclass
class RenderState:
    mesh_id: torch.Tensor      # [E,C] i32
    material_id: torch.Tensor  # [E,C] i32
    aabb_min: torch.Tensor     # [E,C,3] f32 local bounds
    aabb_max: torch.Tensor     # [E,C,3] f32


@dataclass
class BodyState:
    body_type: torch.Tensor     # [E,C] i32 BODY_*
    shape: torch.Tensor         # [E,C] i32 SHAPE_*
    half_extents: torch.Tensor  # [E,C,3] f32
    layer: torch.Tensor         # [E,C] i64 holding u32 bits
    mask: torch.Tensor          # [E,C] i64 holding u32 bits
    trigger: torch.Tensor       # [E,C] bool
    mass: torch.Tensor          # [E,C] f32
    friction: torch.Tensor
    restitution: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    vel: torch.Tensor           # [E,C,3]
    omega: torch.Tensor         # [E,C,3] world-frame angular velocity
    com_offset: torch.Tensor    # [E,C,3] visual -> COM offset
    sleep_timer: torch.Tensor   # [E,C]


@dataclass
class TrafficState:
    mode: torch.Tensor             # [E,C] i32 TRAFFIC_*
    lane_id: torch.Tensor          # [E,C] i32 (-1 invalid)
    lane_s: torch.Tensor           # [E,C] f32
    target_speed: torch.Tensor
    speed: torch.Tensor
    look_ahead: torch.Tensor
    stuck_timer: torch.Tensor
    sensor_hit_dist: torch.Tensor
    sensor_hit_type: torch.Tensor  # [E,C] i32
    lane_cooldown: torch.Tensor


@dataclass
class VehicleState:
    mass: torch.Tensor
    engine_force: torch.Tensor
    max_speed: torch.Tensor
    brake_force: torch.Tensor
    handbrake_force: torch.Tensor
    max_steer: torch.Tensor
    steer_response: torch.Tensor
    susp_rest: torch.Tensor
    susp_stiff: torch.Tensor
    damp_comp: torch.Tensor
    damp_relax: torch.Tensor
    wheel_radius: torch.Tensor
    friction_slip: torch.Tensor
    roll_influence: torch.Tensor
    input: torch.Tensor          # [E,C,4] throttle, brake, steer, handbrake
    smoothed: torch.Tensor       # [E,C,4]
    wheel_conn: torch.Tensor     # [E,C,4,3]
    susp_len: torch.Tensor       # [E,C,4]
    wheel_contact: torch.Tensor  # [E,C,4] bool
    wheel_omega: torch.Tensor    # [E,C,4]


@dataclass
class EntityState:
    alive: torch.Tensor       # [E,C] bool
    generation: torch.Tensor  # [E,C] i64 holding u32 bits
    uid: torch.Tensor         # [E,C] i32
    components: torch.Tensor  # [E,C] i64 holding u32 bits of C_*
    sector: torch.Tensor      # [E,C,2] i32
    name_hash: torch.Tensor   # [E,C] i64 holding u32 bits
    transform: TransformState
    render: RenderState
    body: BodyState
    traffic: TrafficState
    vehicle: VehicleState

    @property
    def capacity(self) -> int:
        return self.alive.shape[-1]


def alloc_entity_state(capacity: int, envs: int, device=None) -> EntityState:
    """E fresh, empty worlds of fixed capacity on `device` (the card by
    default): scx's alloc_entity_state, for every env."""
    device = resolve_device(device)
    e, n = envs, capacity
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def full(shape, v, dt=f32):
        return torch.full((e, n) + shape, v, dtype=dt, device=device)

    rot = full((4,), 0.0)
    rot[..., 0] = 1.0
    state = EntityState(
        alive=full((), False, torch.bool),
        generation=full((), 0, i64),
        uid=torch.arange(n, dtype=i32, device=device).expand(e, n).clone(),
        components=full((), 0, i64),
        sector=full((2,), 0, i32),
        name_hash=full((), 0, i64),
        transform=TransformState(
            pos=full((3,), 0.0), rot=rot, scale=full((3,), 1.0), parent=full((), -1, i32),
        ),
        render=RenderState(
            mesh_id=full((), -1, i32), material_id=full((), -1, i32),
            aabb_min=full((3,), -0.5), aabb_max=full((3,), 0.5),
        ),
        body=BodyState(
            body_type=full((), BODY_NONE, i32),
            shape=full((), SHAPE_BOX, i32),
            half_extents=full((3,), 0.5),
            layer=full((), 1, i64),
            mask=full((), U32, i64),
            trigger=full((), False, torch.bool),
            mass=full((), 1.0),
            friction=full((), 0.8),
            restitution=full((), 0.0),
            lin_damping=full((), 0.0),
            ang_damping=full((), 0.05),
            vel=full((3,), 0.0),
            omega=full((3,), 0.0),
            com_offset=full((3,), 0.0),
            sleep_timer=full((), 0.0),
        ),
        traffic=TrafficState(
            mode=full((), TRAFFIC_NONE, i32),
            lane_id=full((), -1, i32),
            lane_s=full((), 0.0),
            target_speed=full((), 0.0),
            speed=full((), 0.0),
            look_ahead=full((), 12.0),
            stuck_timer=full((), 0.0),
            sensor_hit_dist=full((), 0.0),
            sensor_hit_type=full((), 0, i32),
            lane_cooldown=full((), 0.0),
        ),
        vehicle=VehicleState(
            mass=full((), 1200.0),
            engine_force=full((), 8000.0),
            max_speed=full((), 45.0),
            brake_force=full((), 12000.0),
            handbrake_force=full((), 8000.0),
            max_steer=full((), 0.55),
            steer_response=full((), 6.0),
            susp_rest=full((), 0.35),
            susp_stiff=full((), 20.0),
            damp_comp=full((), 2.3),
            damp_relax=full((), 4.4),
            wheel_radius=full((), 0.35),
            friction_slip=full((), 1.2),
            roll_influence=full((), 0.1),
            input=full((4,), 0.0),
            smoothed=full((4,), 0.0),
            wheel_conn=full((4, 3), 0.0),
            susp_len=full((4,), 0.35),
            wheel_contact=full((4,), False, torch.bool),
            wheel_omega=full((4,), 0.0),
        ),
    )
    memtrack.track_array(memtrack.TAG_STATE, state, f"EntityState[{envs}x{capacity}]")
    return state


# ---------------------------------------------------------------------------
# Entity lifecycle (scx.state.entity:260-321), per env: slots, masks and
# columns carry the env axis [E, k, ...]
# ---------------------------------------------------------------------------

def entity_count(state: EntityState) -> torch.Tensor:
    """Live entities per env, [E] i32."""
    return state.alive.sum(-1, dtype=torch.int32)


def compact_free_slots(state: EntityState, k: int) -> torch.Tensor:
    """[E, min(k, C)] i32: each env's first k free slots, lowest index first,
    padded with C (no slot) when the env is full (EntityManager::create's
    free-list pop, sc_ecs.cpp:11-32)."""
    n = state.capacity
    idx = torch.arange(n, dtype=torch.int32, device=state.alive.device)
    key = torch.where(state.alive, n, idx)
    return torch.sort(key, dim=-1).values[..., :k]


def _drop_put(arr: torch.Tensor, slots: torch.Tensor, value) -> torch.Tensor:
    """arr [E, C, ...] with rows `slots` [E, k] set to value [E, k, ...];
    slots == C are dropped (scx's scatter mode="drop"): they write a dump
    row that is sliced off."""
    e, n = arr.shape[:2]
    pad = torch.cat([arr, arr[:, :1]], dim=1)
    value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    value = value.expand(slots.shape + arr.shape[2:])
    env = torch.arange(e, device=arr.device)[:, None].expand(slots.shape)
    pad[env, slots] = value
    return pad[:, :n]


def spawn_entities(state: EntityState, slots, valid=None, **columns) -> EntityState:
    """Masked scatter-spawn: claim `slots` [E, k] (where `valid` [E, k]),
    set alive and write the given component columns.

    `columns` maps flat paths like "transform.pos" to [E, k, ...] values
    (or [k, ...], the same for every env); "components" may be given to set
    presence bits. Slots outside [0, C) or not valid are dropped, as scx's
    out-of-range scatters are."""
    n = state.capacity
    dev = state.alive.device
    slots = torch.as_tensor(slots, device=dev).long()
    if slots.dim() == 1:
        slots = slots.expand(state.alive.shape[0], -1)
    keep = (slots >= 0) & (slots < n)
    if valid is not None:
        keep &= torch.as_tensor(valid, device=dev)
    slots = torch.where(keep, slots, n)
    state = replace(state, alive=_drop_put(state.alive, slots, True))
    for path, value in columns.items():
        parts = path.split(".")
        if len(parts) == 1:
            state = replace(state, **{parts[0]: _drop_put(getattr(state, parts[0]), slots,
                                                          value)})
        else:
            group = getattr(state, parts[0])
            group = replace(group, **{parts[1]: _drop_put(getattr(group, parts[1]), slots,
                                                          value)})
            state = replace(state, **{parts[0]: group})
    return state


def destroy_entities(state: EntityState, kill_mask) -> EntityState:
    """Masked destroy [E, C]: clears alive and components, bumps generation
    with scx's uint32 wrap (the World::destroy across-pools analogue,
    sc_ecs.cpp:80-90)."""
    kill = torch.as_tensor(kill_mask, device=state.alive.device)
    keep = state.alive & ~kill
    b, tr = state.body, state.traffic
    return replace(
        state,
        alive=keep,
        generation=(state.generation + kill.to(torch.int64)) & U32,
        components=torch.where(kill, 0, state.components),
        body=replace(
            b,
            body_type=torch.where(kill, BODY_NONE, b.body_type),
            vel=torch.where(kill[..., None], 0.0, b.vel),
            omega=torch.where(kill[..., None], 0.0, b.omega),
        ),
        traffic=replace(tr, mode=torch.where(kill, TRAFFIC_NONE, tr.mode)),
    )
