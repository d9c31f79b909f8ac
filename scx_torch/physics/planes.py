"""Plane-form 3D math: vectors/quaternions as tuples of component planes.

The port of scx.physics.planes, limited to what the planar step uses. V3
and Q4 are NamedTuples whose fields are same-shaped tensors of any shape
([E, N], [E, P], [E, K, P], ...), so every helper broadcasts like torch
does. 3x3 matrices are nested 3-tuples of planes. The formulas and their
operation order are those of scx, so results agree to the last bit where
the arithmetic is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-6


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


class Q4(NamedTuple):
    w: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def vnorm(a: V3):
    return torch.sqrt(vdot(a, a).clamp(min=0.0))


def vnormalize(a: V3, eps=EPS) -> V3:
    n = vnorm(a).clamp(min=eps)
    return V3(a.x / n, a.y / n, a.z / n)


def vsafe_normalize(a: V3, fallback: V3 = None, eps=EPS) -> V3:
    n = vnorm(a)
    ok = n > eps
    d = torch.where(ok, n, 1.0)
    unit = V3(a.x / d, a.y / d, a.z / d)
    if fallback is None:
        z = torch.zeros_like(a.x)
        fallback = V3(z, z, z)
    return vwhere(ok, unit, fallback)


def vwhere(m, a: V3, b: V3) -> V3:
    return V3(
        torch.where(m, a.x, b.x),
        torch.where(m, a.y, b.y),
        torch.where(m, a.z, b.z),
    )


def vabs(a: V3) -> V3:
    return V3(a.x.abs(), a.y.abs(), a.z.abs())


def vmin(a: V3, b: V3) -> V3:
    return V3(
        torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
        torch.minimum(a.z, b.z),
    )


def vmax(a: V3, b: V3) -> V3:
    return V3(
        torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
        torch.maximum(a.z, b.z),
    )


def vclip(a: V3, lo: V3, hi: V3) -> V3:
    return vmin(vmax(a, lo), hi)


def vhmax(a: V3):
    """max over the 3 components (elementwise over planes)."""
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def vhmin(a: V3):
    return torch.minimum(a.x, torch.minimum(a.y, a.z))


def vcomp(a: V3, i):
    """Component by index plane i in {0,1,2} (branch-free select)."""
    return torch.where(i == 0, a.x, torch.where(i == 1, a.y, a.z))


def vonehot(i, like) -> V3:
    """Unit axis e_i for index plane i (0/1/2), shaped and typed like `like`."""
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    return V3(
        torch.where(i == 0, one, zero),
        torch.where(i == 1, one, zero),
        torch.where(i == 2, one, zero),
    )


# --- quaternions (w,x,y,z), formulas == scx.core.math3d -------------------

def qconj(q: Q4) -> Q4:
    return Q4(q.w, -q.x, -q.y, -q.z)


def qmul(a: Q4, b: Q4) -> Q4:
    return Q4(
        a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
        a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
        a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
        a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
    )


def qnormalize(q: Q4) -> Q4:
    n = torch.sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z).clamp(min=EPS)
    return Q4(q.w / n, q.x / n, q.y / n, q.z / n)


def qrot(q: Q4, v: V3) -> V3:
    """v + 2 w (qv x v) + 2 qv x (qv x v) — same as math3d.quat_rotate."""
    qv = V3(q.x, q.y, q.z)
    t = vcross(qv, v) * 2.0
    return v + t * q.w + vcross(qv, t)


def qrot_inv(q: Q4, v: V3) -> V3:
    return qrot(qconj(q), v)


def qintegrate(q: Q4, omega: V3, dt) -> Q4:
    """q += 0.5 (0, omega) * q dt, renormalized (math3d.quat_integrate)."""
    dq = qmul(Q4(torch.zeros_like(omega.x), omega.x, omega.y, omega.z), q)
    return qnormalize(
        Q4(
            q.w + 0.5 * dq.w * dt,
            q.x + 0.5 * dq.x * dt,
            q.y + 0.5 * dq.y * dt,
            q.z + 0.5 * dq.z * dt,
        )
    )


def q_to_mat(q: Q4):
    """Rotation matrix as nested 3-tuples of planes: m[i][j]."""
    w, x, y, z = q.w, q.x, q.y, q.z
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


# --- 3x3 matrices as nested tuples of planes -------------------------------

def mvec(m, v: V3) -> V3:
    """m @ v (rows of m dotted with v)."""
    return V3(
        m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
        m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
        m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z,
    )


def mtvec(m, v: V3) -> V3:
    """m^T @ v."""
    return V3(
        m[0][0] * v.x + m[1][0] * v.y + m[2][0] * v.z,
        m[0][1] * v.x + m[1][1] * v.y + m[2][1] * v.z,
        m[0][2] * v.x + m[1][2] * v.y + m[2][2] * v.z,
    )


def mtm(a, b):
    """a^T @ b (both nested tuples) -> nested tuple."""
    return tuple(
        tuple(
            a[0][i] * b[0][j] + a[1][i] * b[1][j] + a[2][i] * b[2][j]
            for j in range(3)
        )
        for i in range(3)
    )


def mT(m):
    return tuple(tuple(m[j][i] for j in range(3)) for i in range(3))


def mabs(m, eps=0.0):
    return tuple(tuple(m[i][j].abs() + eps for j in range(3)) for i in range(3))


def mcol(m, j) -> V3:
    return V3(m[0][j], m[1][j], m[2][j])


def mcol_dyn(m, j) -> V3:
    """Column by index plane j."""
    c0, c1, c2 = mcol(m, 0), mcol(m, 1), mcol(m, 2)
    return vwhere(j == 0, c0, vwhere(j == 1, c1, c2))
