"""The parts of scx.core.math3d that the port needs: quaternions for the
physics, vectors and 4x4 matrices for the render path.

Quaternions are (w, x, y, z) in the last dim, as in scx.
"""

from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# Vectors and 4x4 matrices (the render path's half of scx.core.math3d).
# Matrices act on column vectors, v' = M @ v; every product is true f32
# (TF32 is off, as scx runs them at Precision.HIGHEST).
# ---------------------------------------------------------------------------

EPSILON = 1e-6


def dot(a, b, dim=-1, keepdim=False):
    return (a * b).sum(dim=dim, keepdim=keepdim)


def normalize(v, eps=EPSILON):
    n = torch.sqrt(torch.clamp(dot(v, v, keepdim=True), min=0.0))
    return v / torch.clamp(n, min=eps)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def mat4_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., 4, 4] @ b [..., 4, n], each 4-term dot summed pairwise as
    (p0 + p1) + (p2 + p3), which is how XLA's f32 dot rounds it in scx."""
    p = [a[..., :, j, None] * b[..., None, j, :] for j in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def _eye4(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(
        tuple(shape) + (4, 4)).clone()


def mat4_translation(t: torch.Tensor) -> torch.Tensor:
    m = _eye4(t.shape[:-1], t)
    m[..., 0:3, 3] = t
    return m


def mat4_scale(s: torch.Tensor) -> torch.Tensor:
    m = torch.zeros(s.shape[:-1] + (4, 4), dtype=s.dtype, device=s.device)
    m[..., 0, 0] = s[..., 0]
    m[..., 1, 1] = s[..., 1]
    m[..., 2, 2] = s[..., 2]
    m[..., 3, 3] = 1.0
    return m


def mat4_from_mat3(r3: torch.Tensor) -> torch.Tensor:
    m = torch.zeros(r3.shape[:-2] + (4, 4), dtype=r3.dtype, device=r3.device)
    m[..., 0:3, 0:3] = r3
    m[..., 3, 3] = 1.0
    return m


def mat4_rotation_xyz(rot: torch.Tensor) -> torch.Tensor:
    """Euler XYZ rotation = Rz @ Ry @ Rx."""
    q = quat_from_euler_xyz(rot[..., 0], rot[..., 1], rot[..., 2])
    return mat4_from_mat3(quat_to_mat3(q))


def mat4_trs(pos, rot_euler, scale) -> torch.Tensor:
    """T @ R @ S."""
    return mat4_mul(mat4_translation(pos),
                    mat4_mul(mat4_rotation_xyz(rot_euler), mat4_scale(scale)))


def mat4_perspective_rh_zo(fovy: float, aspect: float, z_near: float, z_far: float,
                           flip_y: bool = True, device=None) -> torch.Tensor:
    """Right-handed, depth 0..1, optional Vulkan Y flip. Entries are
    rounded to f32 from f32 operands, as scx computes them."""
    f32 = np.float32
    f = f32(1.0) / f32(np.tan(f32(fovy) * f32(0.5)))
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = float(f / f32(aspect))
    m[1, 1] = float(-f if flip_y else f)
    m[2, 2] = float(f32(z_far) / (f32(z_near) - f32(z_far)))
    m[2, 3] = float((f32(z_far) * f32(z_near)) / (f32(z_near) - f32(z_far)))
    m[3, 2] = -1.0
    return m


def mat4_look_at_rh(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    fwd = normalize(target - eye)
    right = normalize(torch.linalg.cross(fwd, up))
    true_up = torch.linalg.cross(right, fwd)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, 0:3] = right
    m[1, 0:3] = true_up
    m[2, 0:3] = -fwd
    m[0, 3] = -dot(right, eye)
    m[1, 3] = -dot(true_up, eye)
    m[2, 3] = dot(fwd, eye)
    return m
