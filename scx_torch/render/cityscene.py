"""Procedural city-chunk mesh (copy of benchmarks/cityscene.py).

A grid of buildings with subdivided facades plus a ground quad grid; the
subdivision level sets the triangle count (~100k at grid=22, subdiv=4,
ground=24). numpy only, from a seeded RandomState, so the port and scx
build the same bits."""

import numpy as np


def build_city_mesh(grid: int = 22, subdiv: int = 4, ground: int = 24,
                    seed: int = 7):
    """Returns (verts [V,8] f32: pos, rgb, uv; tris [T,3] i32)."""
    rng = np.random.RandomState(seed)
    verts_all, tris_all = [], []

    def add_box(cx, cz, w, h, d, sub):
        for axis, sign in [(0, 1), (0, -1), (1, 1), (2, 1), (2, -1)]:
            u_axis, v_axis = (axis + 1) % 3, (axis + 2) % 3
            for i in range(sub):
                for j in range(sub):
                    u0, u1 = -0.5 + i / sub, -0.5 + (i + 1) / sub
                    q0, q1 = -0.5 + j / sub, -0.5 + (j + 1) / sub
                    quad = []
                    for (uu, qq) in [(u0, q0), (u1, q0), (u1, q1), (u0, q1)]:
                        p = [0.0, 0.0, 0.0]
                        p[axis] = 0.5 * sign
                        p[u_axis] = uu
                        p[v_axis] = qq
                        pw = [p[0] * w + cx, p[1] * h + h / 2, p[2] * d + cz]
                        lum = 0.35 + 0.5 * rng.rand()
                        quad.append(pw + [lum, lum, lum] + [uu + 0.5, qq + 0.5])
                    k = len(verts_all)
                    verts_all.extend(quad)
                    tris_all.extend([[k, k + 1, k + 2], [k, k + 2, k + 3]])

    for bi in range(grid):
        for bj in range(grid):
            cx = (bi - grid / 2) * 14.0 + rng.uniform(-2, 2)
            cz = -bj * 14.0 - 8.0
            w = rng.uniform(6, 10)
            d = rng.uniform(6, 10)
            h = rng.uniform(8, 35)
            add_box(cx, cz, w, h, d, subdiv)

    for i in range(ground):
        for j in range(ground):
            x0 = (i - ground / 2) * 16.0
            z0 = -j * 16.0
            k = len(verts_all)
            lum = 0.25
            for (xx, zz) in [(x0, z0), (x0 + 16, z0), (x0 + 16, z0 - 16),
                             (x0, z0 - 16)]:
                verts_all.append(
                    [xx, 0.0, zz, lum, lum, lum, (xx - x0) / 16, (zz - z0) / -16]
                )
            tris_all.extend([[k, k + 1, k + 2], [k, k + 2, k + 3]])

    return np.asarray(verts_all, np.float32), np.asarray(tris_all, np.int32)
