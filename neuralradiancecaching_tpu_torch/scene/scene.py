"""Scene state: density corner table, lights, env map, camera, baked fields.

Counterpart of ``neuralradiancecaching_tpu/scene/scene.py``. ``make_scene``
builds what the slice's modes read -- the corner table, the exit-tau field,
the HG-convolved scatter field and the collision field -- on the device of
the density tensor. The premultiplied radiance field and bf16 field storage
are not ported yet and raise.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from neuralradiancecaching_tpu.config import (DirLightConfig, NRCConfig,
                                              PointLightConfig)
from neuralradiancecaching_tpu_torch.ops import collision, lightfield
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops
from neuralradiancecaching_tpu_torch.ops.envmap import EnvMap, make_envmap
from neuralradiancecaching_tpu_torch.scene.camera import Camera, make_camera


@dataclass(frozen=True)
class DirLight:
    direction: torch.Tensor  # (3,) unit
    color: torch.Tensor      # (3,)
    strength: torch.Tensor   # scalar


@dataclass(frozen=True)
class PointLight:
    position: torch.Tensor  # (3,)
    color: torch.Tensor     # (3,)
    strength: torch.Tensor  # scalar


@dataclass(frozen=True)
class Scene:
    density: torch.Tensor       # (P, 8) corner table
    density_grid: torch.Tensor  # (Nx, Ny, Nz) raw grid
    camera: Camera
    dir_light: DirLight
    point_light: PointLight
    env: EnvMap
    env_t_field: torch.Tensor   # exit-tau rows, or a placeholder row
    env_l_field: torch.Tensor   # premultiplied field: always a placeholder
    env_s_field: torch.Tensor   # scatter-field rows, or a placeholder row
    coll_field: torch.Tensor    # collision rows, or a placeholder row


def dir_from_zenith_azimuth(zenith: float, azimuth: float) -> np.ndarray:
    """DirLight.cpp:5-14: direction the light TRAVELS."""
    d = np.array([math.cos(zenith) * math.cos(azimuth), math.sin(zenith),
                  math.cos(zenith) * math.sin(azimuth)], dtype=np.float32)
    return d / np.linalg.norm(d)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)


def make_dir_light(cfg: DirLightConfig, device) -> DirLight:
    return DirLight(
        direction=_f32(dir_from_zenith_azimuth(cfg.zenith, cfg.azimuth),
                       device),
        color=_f32(cfg.color, device), strength=_f32(cfg.strength, device))


def make_point_light(cfg: PointLightConfig, device) -> PointLight:
    return PointLight(position=_f32(cfg.position, device),
                      color=_f32(cfg.color, device),
                      strength=_f32(cfg.strength, device))


def make_scene(cfg: NRCConfig, density: torch.Tensor,
               env_image: torch.Tensor,
               timings: dict[str, float] | None = None) -> Scene:
    """Assemble the scene from config and loaded assets, on density's device.

    timings: when given, receives the synchronized seconds of each bake
    (corner table and each field) under the Scene field's name.
    """
    device = density.device
    if cfg.volume.field_dtype != "float32":
        raise NotImplementedError("bf16 field storage is not ported yet")
    if cfg.env_map.transmittance_mode == "premultiplied":
        raise NotImplementedError("the premultiplied radiance field is not "
                                  "ported yet")
    density = density.to(torch.float32)
    if cfg.quirks.quantize_density_8bit:
        density = volume_ops.quantize_8bit(density)
    if tuple(density.shape) != tuple(cfg.volume.grid_shape):
        raise ValueError(f"density shape {tuple(density.shape)} != "
                         f"grid_shape {cfg.volume.grid_shape}")
    env_image = env_image.to(device=device, dtype=torch.float32)

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings[name] = time.perf_counter() - t0
        return out

    def placeholder(width):
        return torch.zeros((1, width), dtype=torch.float32, device=device)

    corner = timed("density", volume_ops.build_corner_table, density)
    if (cfg.env_map.transmittance_mode == "field"
            or cfg.path.transmittance_mode == "field"):
        env_t_field = timed("env_t_field",
                            lightfield.build_transmittance_field, corner,
                            cfg.volume, steps=cfg.env_map.transmittance_steps)
    else:
        env_t_field = placeholder(4)
    if cfg.env_map.in_scatter_mode == "field":
        env_s_field = timed(
            "env_s_field", lightfield.build_scatter_field, corner, env_image,
            cfg.volume, hg_g=cfg.volume.hg_g,
            steps=(cfg.env_map.scatter_bake_steps
                   or cfg.env_map.transmittance_steps),
            quad_dirs=cfg.env_map.scatter_quad_dirs)
    else:
        env_s_field = placeholder(12)
    if cfg.path.sampler == "collision":
        coll_field = timed("coll_field", collision.build_collision_field,
                           corner, cfg.volume,
                           steps=cfg.path.collision_field_steps)
    else:
        coll_field = placeholder(collision.ROW_WIDTH)
    return Scene(
        density=corner, density_grid=density,
        camera=make_camera(cfg.camera, device),
        dir_light=make_dir_light(cfg.dir_light, device),
        point_light=make_point_light(cfg.point_light, device),
        env=make_envmap(env_image, cfg.env_map),
        env_t_field=env_t_field, env_l_field=placeholder(12),
        env_s_field=env_s_field, coll_field=coll_field)
