"""Perspective camera with GLM semantics and the orbit trajectory.

Counterpart of ``neuralradiancecaching_tpu/scene/camera.py`` (reference
Camera.cpp:164-179, ray reconstruction nrc-train.comp:1228-1246). The
matrices are built in numpy float32 exactly as in the JAX package and then
placed on the requested device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from neuralradiancecaching_tpu_torch.config import CameraConfig


@dataclass(frozen=True)
class Camera:
    position: torch.Tensor       # (3,)
    inv_proj_view: torch.Tensor  # (4, 4)
    proj_view: torch.Tensor      # (4, 4)


def perspective(fov_y: float, aspect: float, near: float,
                far: float) -> np.ndarray:
    """glm::perspective (RH, depth -1..1)."""
    f = 1.0 / math.tan(fov_y / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt (RH)."""
    eye = np.asarray(eye, dtype=np.float32)
    f = np.asarray(center, dtype=np.float32) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, dtype=np.float32)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def make_camera(cfg: CameraConfig, device: torch.device | str = "cuda",
                position: Tuple[float, float, float] | None = None,
                view_dir: Tuple[float, float, float] | None = None) -> Camera:
    """Build the camera on ``device``, the card unless the caller names
    another (Camera::UpdateUniformBuffer)."""
    pos = np.asarray(position if position is not None else cfg.position,
                     dtype=np.float32)
    vdir = np.asarray(view_dir if view_dir is not None else cfg.view_dir,
                      dtype=np.float32)
    vdir = vdir / np.linalg.norm(vdir)
    proj = perspective(math.radians(cfg.fov_deg), cfg.aspect, cfg.near,
                       cfg.far)
    view = look_at(pos, pos + vdir, np.asarray(cfg.up, dtype=np.float32))
    proj_view = proj @ view
    inv = np.linalg.inv(proj_view)
    return Camera(position=torch.as_tensor(pos, device=device),
                  inv_proj_view=torch.as_tensor(inv, device=device),
                  proj_view=torch.as_tensor(proj_view, device=device))


def pixel_rays(camera: Camera, width: int, height: int,
               dtype=torch.float32,
               jitter: torch.Tensor | torch.Generator | None = None):
    """Primary rays for every pixel: fragUV = pixel / (W, H); screen =
    (2 uv - 1, 0, 1); world = invProjView @ screen / w; rd = normalize(world
    - camera.pos). Returns (ro (H*W, 3), rd (H*W, 3)).

    jitter: offsets each pixel uniformly within its footprint (the train
    grid's stratified sampling, camera.py:103-107 of the JAX package) --
    a (2, H, W) tensor of uniforms (u, v), or a generator to draw them
    from. None keeps the pixel corners.

    The projective divide (w ~ 5, z ~ 320) needs full fp32 products, so the
    4x4 transform is written out elementwise rather than as a matmul that
    TF32 could take over on the card.
    """
    device = camera.position.device
    xs = torch.arange(width, dtype=dtype, device=device) / width
    ys = torch.arange(height, dtype=dtype, device=device) / height
    v, u = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    if isinstance(jitter, torch.Generator):
        jitter = torch.rand((2, height, width), generator=jitter,
                            dtype=dtype, device=device)
    if jitter is not None:
        u = u + jitter[0] / width
        v = v + jitter[1] / height
    ndc = torch.stack([u * 2.0 - 1.0, v * 2.0 - 1.0, torch.zeros_like(u),
                       torch.ones_like(u)], dim=-1).reshape(-1, 4)
    world = torch.sum(ndc[:, None, :] * camera.inv_proj_view.to(dtype)[None],
                      dim=-1)  # (H*W, 4)
    world = world[:, :3] / world[:, 3:4]
    rd = world - camera.position
    rd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    ro = camera.position.expand(rd.shape)
    return ro, rd


def orbit_position(frame: int, n_frames: int, radius: float = 64.0,
                   height: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Camera::RotateAroundOrigin (Camera.cpp:175-179) as a trajectory:
    (position, view_dir) looking at the origin."""
    angle = 2.0 * math.pi * frame / max(n_frames, 1)
    pos = np.array([radius * math.sin(angle), height,
                    -radius * math.cos(angle)], dtype=np.float32)
    return pos, -pos / np.linalg.norm(pos)


def fly_through_position(frame: int, n_frames: int,
                         start=(0.0, 0.0, -64.0), end=(0.0, 0.0, -20.0)
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """A straight fly toward the volume (the WASD path, Input.cpp:50-98,
    scripted): lerp the position, keep looking +z."""
    t = frame / max(n_frames - 1, 1)
    pos = (1 - t) * np.asarray(start, np.float32) + t * np.asarray(end,
                                                                   np.float32)
    return pos, np.array([0.0, 0.0, 1.0], dtype=np.float32)
