"""Debug line drawing (port of scx.render.debug_draw): host accumulator +
device overlay pass.

The reference accumulates CPU line lists (grid/axes/sector bounds/entity
bounds/physics wireframes, sc_debug_draw.h:22-37, sc_debug_draw_system.cpp:
46-140) and streams them through a dedicated Vulkan line pipeline.  Here
lines rasterize as a scatter overlay on the finished frame: project both
endpoints, sample fixed points along each segment, depth-test against the
G-buffer and write colors — one fused pass for all lines.
"""

from __future__ import annotations

import numpy as np
import torch

from scx_torch.core import math3d as m3

SAMPLES_PER_LINE = 64


class DebugDraw:
    """Host-side line accumulator (fixed capacity, cleared per frame)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.p0 = np.zeros((capacity, 3), np.float32)
        self.p1 = np.zeros((capacity, 3), np.float32)
        self.color = np.zeros((capacity, 3), np.float32)
        self.count = 0

    def clear(self):
        self.count = 0

    def add_line(self, a, b, color=(0.0, 1.0, 0.0)):
        if self.count >= self.capacity:
            return
        i = self.count
        self.p0[i] = a
        self.p1[i] = b
        self.color[i] = color
        self.count += 1

    def add_grid(self, center=(0.0, 0.0, 0.0), half: float = 32.0, step: float = 4.0,
                 color=(0.25, 0.25, 0.25)):
        """Grid + axes helper (sc_debug_draw.cpp:22-57)."""
        cx, cy, cz = center
        n = int(half / step)
        for i in range(-n, n + 1):
            o = i * step
            self.add_line((cx - half, cy, cz + o), (cx + half, cy, cz + o), color)
            self.add_line((cx + o, cy, cz - half), (cx + o, cy, cz + half), color)
        self.add_line((cx, cy, cz), (cx + 2, cy, cz), (1.0, 0.2, 0.2))
        self.add_line((cx, cy, cz), (cx, cy + 2, cz), (0.2, 1.0, 0.2))
        self.add_line((cx, cy, cz), (cx, cy, cz + 2), (0.2, 0.2, 1.0))

    def add_aabb(self, bmin, bmax, color=(1.0, 1.0, 0.2)):
        x0, y0, z0 = bmin
        x1, y1, z1 = bmax
        for a, b in (
            ((x0, y0, z0), (x1, y0, z0)), ((x1, y0, z0), (x1, y0, z1)),
            ((x1, y0, z1), (x0, y0, z1)), ((x0, y0, z1), (x0, y0, z0)),
            ((x0, y1, z0), (x1, y1, z0)), ((x1, y1, z0), (x1, y1, z1)),
            ((x1, y1, z1), (x0, y1, z1)), ((x0, y1, z1), (x0, y1, z0)),
            ((x0, y0, z0), (x0, y1, z0)), ((x1, y0, z0), (x1, y1, z0)),
            ((x1, y0, z1), (x1, y1, z1)), ((x0, y0, z1), (x0, y1, z1)),
        ):
            self.add_line(a, b, color)

    def arrays(self, device=None):
        """(p0, p1, color, valid) of the full capacity as tensors on
        `device` (the card by default)."""
        from scx_torch import resolve_device

        device = resolve_device(device)
        n = self.capacity
        valid = np.zeros(n, bool)
        valid[: self.count] = True
        t = lambda a: torch.from_numpy(a.copy()).to(device)
        return t(self.p0), t(self.p1), t(self.color), t(valid)


def _transform_point_h(m, p):
    """[L, 4] homogeneous m @ (p, 1) for points p [L, 3], each 4-term dot
    summed pairwise as XLA rounds it (scx's math3d.transform_point_h)."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return m3.mat4_mul(m, ph.T).T


def overlay_lines(rgb, depth, view_proj, p0, p1, color, valid, depth_test=True):
    """Scatter debug lines over the frame. rgb [H,W,3], depth [H,W]; returns
    a new rgb."""
    h, w = rgb.shape[0], rgb.shape[1]

    c0 = _transform_point_h(view_proj, p0)
    c1 = _transform_point_h(view_proj, p1)
    ok = valid & (c0[:, 3] > 1e-4) & (c1[:, 3] > 1e-4)

    # jnp.linspace(0, 1, S) as XLA evaluates it: i * (1 / (S - 1)) in f32
    t = (torch.arange(SAMPLES_PER_LINE, dtype=torch.float32, device=rgb.device)
         * np.float32(1.0 / (SAMPLES_PER_LINE - 1)))
    c = c0[:, None, :] + (c1 - c0)[:, None, :] * t[None, :, None]  # [L,S,4]
    ndc = c[..., 0:3] / torch.clamp(c[..., 3:4], min=1e-6)
    sx = ((ndc[..., 0] * 0.5 + 0.5) * w).to(torch.int32)
    sy = ((ndc[..., 1] * 0.5 + 0.5) * h).to(torch.int32)
    z = ndc[..., 2]

    on = (
        ok[:, None]
        & (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        & (z >= 0.0) & (z <= 1.0)
    )
    if depth_test:
        safe_x = torch.clamp(sx, 0, w - 1).long()
        safe_y = torch.clamp(sy, 0, h - 1).long()
        scene_z = depth[safe_y, safe_x]
        on = on & (z <= scene_z + 1e-3)

    # dropped samples go to a dump pixel that is sliced off; among the
    # samples that land on one pixel the last one (in line, then sample
    # order) wins, as XLA's scatter writes them on the CPU, here by a
    # max-reduce of the sample's ordinal, which is the same on the card
    flat = torch.where(on, sy.long() * w + sx.long(), h * w).reshape(-1)
    order = torch.arange(flat.numel(), device=rgb.device)
    win = torch.full((h * w + 1,), -1, dtype=torch.long, device=rgb.device)
    win = win.scatter_reduce(0, flat, order, reduce="amax")[: h * w]
    cols = color[:, None, :].expand(c.shape[:2] + (3,)).reshape(-1, 3)
    out = rgb.reshape(-1, 3)
    out = torch.where((win >= 0)[:, None], cols[win.clamp(min=0)], out)
    return out.reshape(rgb.shape)
