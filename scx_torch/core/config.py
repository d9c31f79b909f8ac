"""Engine configuration dataclasses (copy of scx.core.config).

The fields and defaults mirror the reference's compile-time defaults
(sc_world_partition.h:303-315, sc_traffic_common.h:55-77, sc_assets.h:116-122,
sc_ecs.h:113-134). scx's module needs no JAX; it is copied here because
every scx subpackage imports JAX when it is imported.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class WorldPartitionConfig:
    """Sector grid + procedural content (sc_world_partition.h:149-156, 303-315)."""

    sector_size_meters: float = 64.0
    load_radius: int = 2
    unload_radius: int = 3
    seed: int = 1337
    props_per_sector_min: int = 12
    props_per_sector_max: int = 24
    include_ground_plane: bool = True


@dataclass(frozen=True)
class StreamingBudgets:
    """Activation/despawn budgets (sc_world_partition.h:303-315,
    sandbox overrides src/sandbox/src/main.cpp:75-99)."""

    max_active_sectors: int = 25
    max_entities: int = 4096
    max_draws: int = 4096
    max_concurrent_loads: int = 4
    max_activations_per_frame: int = 2
    max_despawns_per_frame: int = 128
    frustum_priority_bias: float = 0.5


@dataclass(frozen=True)
class TrafficConfig:
    """Traffic density, LOD bands, caps (sc_traffic_common.h:55-77)."""

    density_per_km2: float = 250.0
    look_ahead_dist: float = 12.0
    safe_distance: float = 10.0
    speed_multiplier: float = 1.0
    front_ray_length: float = 20.0
    player_exclusion_radius: float = 25.0
    tier_a_enter: float = 50.0
    tier_a_exit: float = 70.0
    tier_b_enter: float = 110.0
    tier_b_exit: float = 150.0
    max_vehicles_total: int = 200
    max_vehicles_physics: int = 24
    max_vehicles_kinematic: int = 64
    pin_radius: int = 1
    # spawner rules (sc_traffic_spawner.cpp:124-339)
    max_spawns_per_sector_per_frame: int = 3
    max_placement_attempts: int = 10
    min_lane_gap: float = 15.0
    min_world_clearance: float = 6.0
    # lane changes: the reference declares the cooldown field but never
    # implements the behaviour (sc_traffic_common.h:38-44) — extension
    lane_change_enabled: bool = True
    lane_change_cooldown: float = 4.0
    lane_change_min_block: float = 0.25  # obstacle_brake needed to trigger
    lane_change_min_dist: float = 1.5    # adjacent-lane lateral band
    lane_change_max_dist: float = 5.5
    lane_change_gap: float = 8.0         # clearance needed at target point


@dataclass(frozen=True)
class AssetResidencyConfig:
    """Texture residency budgets (sc_assets.h:116-122)."""

    gpu_budget_bytes: int = 256 * 1024 * 1024
    max_resident_textures: int = 512
    max_loads_per_frame: int = 2


@dataclass(frozen=True)
class PhysicsConfig:
    """Simulation step parameters (main.cpp:269-270, sc_physics.cpp:210-229)."""

    gravity: float = -9.81
    fixed_dt: float = 1.0 / 60.0
    max_substeps: int = 4
    # 6 warm-started iterations match >=8 cold ones for stack stability
    # (tests/test_physics_solver.py tower test holds down to 5)
    solver_iterations: int = 6
    # solver stabilisation (sequential-impulse-style semantics)
    baumgarte: float = 0.2
    contact_slop: float = 0.005
    restitution_threshold: float = 1.0
    max_contacts_per_pair: int = 4
    # capacity knobs for the fixed-shape batched solver
    max_bodies: int = 64
    max_contacts: int = 256


@dataclass(frozen=True)
class VehicleTuning:
    """Raycast-vehicle defaults (sc_ecs.h:113-134 VehicleComponent)."""

    mass: float = 1200.0
    engine_force: float = 8000.0
    max_speed: float = 45.0
    brake_force: float = 12000.0
    handbrake_force: float = 8000.0
    max_steer_angle: float = 0.55
    steer_response: float = 6.0
    suspension_rest_length: float = 0.35
    suspension_stiffness: float = 20.0
    damping_compression: float = 2.3
    damping_relaxation: float = 4.4
    wheel_radius: float = 0.35
    wheel_width: float = 0.25
    com_offset: tuple = (0.0, -0.35, 0.0)
    friction_slip: float = 1.2        # sc_physics.cpp:852
    roll_influence: float = 0.1       # sc_physics.cpp:881


@dataclass(frozen=True)
class RenderConfig:
    """Raster target + tiling for the Pallas rasterizer."""

    width: int = 1280
    height: int = 720
    tile_h: int = 64  # 64x128 tiles measured fastest (bench_raster_sweep)
    tile_w: int = 128
    max_draws: int = 4096
    max_tris_per_tile: int = 256
    near_z: float = 0.1
    far_z: float = 1000.0
    fov_y_deg: float = 60.0
    frames_in_flight: int = 2  # host<->device pipelining depth (sc_vk.h:58)
    use_mips: bool = True  # mip-mapped texture sampling (MipTextures)
    overlay_text: bool = False  # stamp the debug overlay into the frame


@dataclass(frozen=True)
class EngineConfig:
    world: WorldPartitionConfig = field(default_factory=WorldPartitionConfig)
    streaming: StreamingBudgets = field(default_factory=StreamingBudgets)
    traffic: TrafficConfig = field(default_factory=TrafficConfig)
    residency: AssetResidencyConfig = field(default_factory=AssetResidencyConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    vehicle: VehicleTuning = field(default_factory=VehicleTuning)
    render: RenderConfig = field(default_factory=RenderConfig)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def asset_root(default: str | None = None) -> str:
    """Asset root resolution with SC_ASSET_ROOT override (sc_paths.cpp:31-60)."""
    env = os.environ.get("SC_ASSET_ROOT", "")
    if env:
        return env
    return default if default is not None else os.path.join(os.getcwd(), "assets")


def world_root(cfg_default: str | None = None) -> str:
    """World root resolution with SC_WORLD_ROOT override
    (sc_world_partition.cpp:71-78)."""
    env = os.environ.get("SC_WORLD_ROOT", "")
    if env:
        return env
    if cfg_default is not None:
        return cfg_default
    return os.path.join(asset_root(), "world")
