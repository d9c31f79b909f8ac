"""Quaternion helpers of scx.core.math3d that the physics port needs.

Quaternions are (w, x, y, z) in the last dim, as in scx.
"""

from __future__ import annotations

import torch


def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_from_axis_angle(axis, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    s = torch.sin(half)
    axis = torch.as_tensor(axis, dtype=angle.dtype, device=angle.device)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def quat_from_euler_xyz(rx, ry, rz) -> torch.Tensor:
    """Quaternion equal to the reference rotation Rz @ Ry @ Rx."""
    qx = quat_from_axis_angle([1.0, 0.0, 0.0], rx)
    qy = quat_from_axis_angle([0.0, 1.0, 0.0], ry)
    qz = quat_from_axis_angle([0.0, 0.0, 1.0], rz)
    return quat_mul(qz, quat_mul(qy, qx))
