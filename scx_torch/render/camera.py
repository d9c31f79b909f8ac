"""Camera: view-projection construction (port of scx.render.camera).

viewProj = perspective_rh_zo (Vulkan Y flip) @ look_at_rh, as scx builds it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.core import math3d as m3


@dataclass(frozen=True)
class CameraParams:
    fov_y_deg: float = 60.0
    near_z: float = 0.1
    far_z: float = 1000.0
    flip_y: bool = True


def camera_view_proj(eye, target, up, aspect: float,
                     params: CameraParams = CameraParams(), fov_y_deg=None,
                     device=None) -> torch.Tensor:
    """[4,4] f32 viewProj. `eye`, `target` and `up` are 3-vectors; tensors
    keep their device, anything else goes to `device` (the card by
    default). `fov_y_deg` may be a 0-d tensor (the chase camera's dynamic
    FOV)."""
    if not isinstance(eye, torch.Tensor):
        device = resolve_device(device)
    else:
        device = eye.device
    vec = lambda v: torch.as_tensor(np.asarray(v, np.float32) if not isinstance(
        v, torch.Tensor) else v, dtype=torch.float32, device=device)
    view = m3.mat4_look_at_rh(vec(eye), vec(target), vec(up))
    fov = params.fov_y_deg if fov_y_deg is None else fov_y_deg
    if isinstance(fov, torch.Tensor):  # a dynamic FOV stays on its device
        fovy = fov.to(torch.float32) * np.float32(np.pi / 180.0)
    else:
        fovy = np.float32(fov) * np.float32(np.pi / 180.0)  # jnp.radians in f32
    proj = m3.mat4_perspective_rh_zo(fovy, aspect, params.near_z, params.far_z,
                                     flip_y=params.flip_y, device=device)
    return m3.mat4_mul(proj, view)


def camera_view_proj_from_pose(pos: torch.Tensor, quat: torch.Tensor, aspect: float,
                               params: CameraParams = CameraParams()) -> torch.Tensor:
    """[4, 4] viewProj from a camera's world pose, pos [3] and quat [4] on
    their device (the camera looks down -Z of its frame, as in the
    reference)."""
    rt = m3.quat_to_mat3(quat).T
    view = torch.eye(4, dtype=torch.float32, device=pos.device)
    view[0:3, 0:3] = rt
    view[0:3, 3] = -m3.transform_dir_rows(rt, pos)
    fovy = np.float32(params.fov_y_deg) * np.float32(np.pi / 180.0)
    proj = m3.mat4_perspective_rh_zo(fovy, aspect, params.near_z, params.far_z,
                                     flip_y=params.flip_y, device=pos.device)
    return m3.mat4_mul(proj, view)
