"""The parts of scx.core.math3d that the port needs: quaternions for the
physics and the sim, vectors and 4x4 matrices for the render path.

Quaternions are (w, x, y, z) in the last dim, as in scx.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

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


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(norm(q, keepdim=True), min=EPSILON)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate unit quaternion(s) q by world-frame angular velocity omega."""
    wq = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    dq = 0.5 * quat_mul(wq, q)
    return quat_normalize(q + dq * dt)


# ---------------------------------------------------------------------------
# Host trigonometry as scx computes it on the CPU. XLA's CPU backend calls
# the C library's sinf, cosf and atan2f for f32 (and takes asin as
# 2 atan2(x, 1 + sqrt((1 - x)(1 + x)))); neither torch's nor numpy's f32
# sin or atan2 rounds the same. The editor's and the streaming's host math
# goes through these, so that documents and spawned rotations are
# bit-equal to scx's.
# ---------------------------------------------------------------------------

@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    lib.atan2f.restype, lib.atan2f.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return lib


def host_sin_cos(x) -> tuple[np.ndarray, np.ndarray]:
    """f32 sin and cos of f32 array x, as the C library rounds them."""
    lib = _libm()
    x = np.asarray(x, np.float32)
    sin = np.asarray([lib.sinf(float(v)) for v in x.ravel()], np.float32).reshape(x.shape)
    cos = np.asarray([lib.cosf(float(v)) for v in x.ravel()], np.float32).reshape(x.shape)
    return sin, cos


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 atan2: the C library's atan2f on CPU tensors (as scx rounds it
    there), torch's elsewhere."""
    if y.device.type != "cpu":
        return torch.atan2(y, x)
    lib = _libm()
    yb, xb = torch.broadcast_tensors(y, x)
    out = [lib.atan2f(float(a), float(b)) for a, b in zip(yb.reshape(-1).tolist(),
                                                          xb.reshape(-1).tolist())]
    return torch.tensor(out, dtype=torch.float32).reshape(yb.shape)


def _asin(x: torch.Tensor) -> torch.Tensor:
    """f32 asin as XLA decomposes it, 2 atan2(x, 1 + sqrt((1 - x)(1 + x))).
    On CPU tensors the square root is numpy's, which rounds correctly
    (torch's vectorized CPU sqrt does not always)."""
    r = (1.0 - x) * (1.0 + x)
    root = torch.from_numpy(np.sqrt(r.numpy())) if x.device.type == "cpu" else torch.sqrt(r)
    return 2.0 * _atan2(x, 1.0 + root)


def quat_from_euler_xyz_host(rot) -> torch.Tensor:
    """[n, 4] CPU quaternions Rz @ Ry @ Rx of Euler angles [n, 3] (f32), as
    scx's quat_from_euler_xyz gives them on the host (see host_sin_cos)."""
    half = (np.asarray(rot, np.float32) * np.float32(0.5)).astype(np.float32)
    sin, cos = host_sin_cos(half)
    s, c = torch.from_numpy(sin), torch.from_numpy(cos)

    def axis_angle(i):
        axis = torch.zeros(3)
        axis[i] = 1.0
        return torch.cat([c[:, i, None], axis * s[:, i, None]], dim=-1)

    return quat_mul(axis_angle(2), quat_mul(axis_angle(1), axis_angle(0)))


# ---------------------------------------------------------------------------
# Vectors and 4x4 matrices (the render path's half of scx.core.math3d).
# Matrices act on column vectors, v' = M @ v; every product is true f32
# (TF32 is off, as scx runs them at Precision.HIGHEST).
# ---------------------------------------------------------------------------

EPSILON = 1e-6


def dot(a, b, dim=-1, keepdim=False):
    return (a * b).sum(dim=dim, keepdim=keepdim)


def dot3(a, b):
    """sum_i a_i b_i over a last dim of 3, in index order ((x0 + x1) + x2):
    the 3-term contractions (einsum, dot) of scx's physics."""
    x0, x1, x2 = (a * b).unbind(-1)
    return (x0 + x1) + x2


def mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [..., 3, 3] @ v [..., 3], each row's 3-term sum in index order."""
    return dot3(m, v[..., None, :])


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


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Inverse of quat_from_euler_xyz (the Rz Ry Rx decomposition) -> [..., 3]
    (rx, ry, rz); on CPU tensors bit-equal to scx's (see _atan2)."""
    m = quat_to_mat3(q)
    ry = _asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
    rx = _atan2(m[..., 2, 1], m[..., 2, 2])
    rz = _atan2(m[..., 1, 0], m[..., 0, 0])
    return torch.stack([rx, ry, rz], dim=-1)


def mat4_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., 4, 4] @ b [..., 4, n], each 4-term dot summed pairwise as
    (p0 + p1) + (p2 + p3), which is how XLA's f32 dot rounds it in scx."""
    p = [a[..., :, j, None] * b[..., None, j, :] for j in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def _eye4(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(
        tuple(shape) + (4, 4)).clone()


def mat4_identity(shape=(), device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(tuple(shape) + (4, 4))


def mat4_inverse(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(m)


def mat4_inverse_rigid(m: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid (rotation + translation, no scale) transforms."""
    rt = m[..., 0:3, 0:3].transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., 0:3, 0:3] = rt
    out[..., 0:3, 3] = -transform_dir_rows(rt, m[..., 0:3, 3])
    out[..., 3, 3] = 1.0
    return out


def transform_point_h(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """m [..., 4, 4] applied to points p [..., 3] (w = 1): homogeneous
    [..., 4], each dot summed as mat4_mul sums it."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return mat4_mul(m, ph[..., None])[..., 0]


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """m applied to points p [..., 3] (w = 1), the perspective divide skipped."""
    return transform_point_h(m, p)[..., 0:3]


def transform_dir_rows(r: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """r [..., 3, 3] @ d [..., 3], each 3-term dot summed as (p0 + p1) + p2."""
    p = [r[..., :, j] * d[..., None, j] for j in range(3)]
    return (p[0] + p[1]) + p[2]


def transform_dir(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The upper 3x3 of m [..., 4, 4] applied to directions d [..., 3]."""
    return transform_dir_rows(m[..., 0:3, 0:3], d)


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


def mat4_trs_quat(pos, quat, scale) -> torch.Tensor:
    """T @ R(q) @ S, the quaternion-native form."""
    m = torch.zeros(pos.shape[:-1] + (4, 4), dtype=pos.dtype, device=pos.device)
    m[..., 0:3, 0:3] = quat_to_mat3(quat) * scale[..., None, :]
    m[..., 0:3, 3] = pos
    m[..., 3, 3] = 1.0
    return m


def mat4_perspective_rh_zo(fovy: float, aspect: float, z_near: float, z_far: float,
                           flip_y: bool = True, device=None) -> torch.Tensor:
    """Right-handed, depth 0..1, optional Vulkan Y flip. Entries are
    rounded to f32 from f32 operands, as scx computes them. `fovy` may be
    a 0-d tensor (a dynamic FOV): the matrix is then built on its device,
    with no host read."""
    f32 = np.float32
    if isinstance(fovy, torch.Tensor):
        f = 1.0 / torch.tan(fovy.to(torch.float32) * 0.5)
        m = torch.zeros((4, 4), dtype=torch.float32, device=fovy.device)
        m[0, 0] = f / f32(aspect)
        m[1, 1] = -f if flip_y else f
        m[2, 2] = float(f32(z_far) / (f32(z_near) - f32(z_far)))
        m[2, 3] = float((f32(z_far) * f32(z_near)) / (f32(z_near) - f32(z_far)))
        m[3, 2] = -1.0
        return m
    f = f32(1.0) / f32(np.tan(f32(fovy) * f32(0.5)))
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = float(f / f32(aspect))
    m[1, 1] = float(-f if flip_y else f)
    m[2, 2] = float(f32(z_far) / (f32(z_near) - f32(z_far)))
    m[2, 3] = float((f32(z_far) * f32(z_near)) / (f32(z_near) - f32(z_far)))
    m[3, 2] = -1.0
    return m


def mat4_look_at_rh(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] view matrices from [..., 3] eye / target / up."""
    fwd = normalize(target - eye)
    right = normalize(torch.linalg.cross(fwd, up.expand_as(fwd)))
    true_up = torch.linalg.cross(right, fwd)
    m = _eye4(eye.shape[:-1], eye)
    m[..., 0, 0:3] = right
    m[..., 1, 0:3] = true_up
    m[..., 2, 0:3] = -fwd
    m[..., 0, 3] = -dot(right, eye)
    m[..., 1, 3] = -dot(true_up, eye)
    m[..., 2, 3] = dot(fwd, eye)
    return m


# ---------------------------------------------------------------------------
# The sim's half: rotations of vectors, safe normalization, frustum planes.
# ---------------------------------------------------------------------------

def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last dim, componentwise as jnp.cross computes it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm(v, dim=-1, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, dim=dim, keepdim=keepdim), min=0.0))


def safe_normalize(v, fallback=None, eps=EPSILON):
    """Normalize; rows of length <= eps become `fallback` (default zeros)."""
    n = norm(v, keepdim=True)
    ok = n > eps
    unit = v / torch.where(ok, n, 1.0)
    if fallback is None:
        fallback = torch.zeros_like(v)
    return torch.where(ok, unit, fallback)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by unit quaternion(s) q [..., 4]."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def frustum_from_view_proj(vp: torch.Tensor) -> torch.Tensor:
    """Six inward planes (nx, ny, nz, d), normalized, from viewProj [..., 4,
    4]: left, right, bottom, top, near, far -> [..., 6, 4]."""
    r0, r1, r2, r3 = vp[..., 0, :], vp[..., 1, :], vp[..., 2, :], vp[..., 3, :]
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r2, r3 - r2], dim=-2)
    n = norm(planes[..., 0:3], keepdim=True)
    return planes / torch.clamp(n, min=EPSILON)


def sphere_in_frustum(planes: torch.Tensor, center: torch.Tensor, radius: torch.Tensor):
    """True where the bounding sphere (center [..., 3], radius [...])
    intersects the frustum planes [..., 6, 4]."""
    d = dot(planes[..., 0:3], center[..., None, :]) + planes[..., 3]
    return (d >= -radius[..., None]).all(dim=-1)


def world_bounding_sphere(aabb_min, aabb_max, world_mat):
    """World-space bounding sphere (center [..., 3], radius [...]) of a
    local AABB under an affine world matrix [..., 4, 4]."""
    center_w = transform_point(world_mat, 0.5 * (aabb_min + aabb_max))
    basis = world_mat[..., 0:3, 0:3]
    col_sq = (basis * basis).sum(dim=-2)  # per local axis: the basis column's length^2
    radius = norm(0.5 * (aabb_max - aabb_min) * torch.sqrt(torch.clamp(col_sq, min=0.0)))
    return center_w, radius
