"""Solver parameters (port of scx.physics.solver.SolverParams).

Same fields and defaults. The planar step ignores `colors`, as scx's does.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SolverParams:
    gravity: float = -9.81
    dt: float = 1.0 / 60.0
    iterations: int = 8
    baumgarte: float = 0.2
    slop: float = 0.005
    restitution_threshold: float = 1.0
    relaxation: float = 0.8
    max_pairs: int = 128
    warm_start: float = 0.85
    # graph-colored Gauss-Seidel in scx's conventional solver only
    colors: int = 0
    # Bullet deactivation defaults (btRigidBody: 0.8 lin / 1.0 ang / 2 s)
    sleep_lin: float = 0.8
    sleep_ang: float = 1.0
    sleep_time: float = 2.0
    # static hint: which collider shape types exist ANYWHERE in the scene.
    # ("box",) drops the capsule/sphere candidate generators; a hint that
    # is too narrow loses contacts, so set it from what the scene holds.
    shape_kinds: tuple = ("box", "sphere", "capsule")
