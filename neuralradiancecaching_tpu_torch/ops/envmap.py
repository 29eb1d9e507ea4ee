"""HDR environment map: equirect lookups and inverse-CDF tables.

Counterpart of ``neuralradiancecaching_tpu/ops/envmap.py`` (reference
HdrEnvMap.cpp, read_file.cpp:123-206, nrc-forward.frag:690-749). Lookups use
the corner table: one 12-float row per bilinear fetch, with the u
wraparound and the v clamp baked in. Importance sampling is not ported yet;
the inverse CDFs are built so the env state matches the JAX one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from neuralradiancecaching_tpu.config import EnvMapConfig
from neuralradiancecaching_tpu_torch.ops import scan


@dataclass(frozen=True)
class EnvMap:
    """Scene env-map state (the reference's set-5 descriptor set)."""

    image: torch.Tensor      # (H, W, 3) linear radiance
    # row (y*W + x) = [rgb(x,y) | rgb(x+1,y) | rgb(x,y+1) | rgb(x+1,y+1)]
    corner: torch.Tensor     # (H*W, 12)
    inv_cdf_x: torch.Tensor  # (H, W)  u -> phi_norm, conditioned on row
    inv_cdf_y: torch.Tensor  # (H,)    u -> theta_norm
    direct_strength: torch.Tensor  # scalar
    hpm_strength: torch.Tensor     # scalar


def invert_cdf(cdf: torch.Tensor) -> torch.Tensor:
    """InvertCdf (read_file.cpp:123-139): invCdf[i] = p/N where p is the
    first index with cdf[p] >= i/N. cdf: (..., N) monotone -> (..., N)."""
    n = cdf.shape[-1]
    thresholds = torch.arange(n, dtype=cdf.dtype, device=cdf.device) / n
    rows = cdf.reshape(-1, n).contiguous()
    idx = torch.searchsorted(rows, thresholds.expand(rows.shape[0], n)
                             .contiguous(), right=False)
    return (idx.to(cdf.dtype) / n).reshape(cdf.shape)


def build_inverse_cdfs(image: torch.Tensor):
    """Hdr4fToCdf (read_file.cpp:141-206): per-row conditional CDF over x
    (brightness r+g+b) and marginal CDF over y, both inverted.
    image (H, W, 3) -> (inv_cdf_x (H, W), inv_cdf_y (H,))."""
    brightness = torch.sum(image, dim=-1)
    row_sum = torch.sum(brightness, dim=1, keepdim=True)
    cdf_x = scan.cumsum(brightness, dim=1) / torch.clamp(row_sum, min=1e-20)
    cdf_y = scan.cumsum(row_sum[:, 0], dim=0)
    cdf_y = cdf_y / torch.clamp(cdf_y[-1], min=1e-20)
    return invert_cdf(cdf_x), invert_cdf(cdf_y[None, :])[0]


def build_env_corner_table(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (H*W, 12) with the 4 bilinear corners per row."""
    right = torch.roll(image, -1, dims=1)  # u wraps (equirect seam)
    down = torch.cat([image[1:], image[-1:]], dim=0)  # v clamps
    down_right = torch.roll(down, -1, dims=1)
    return torch.cat([image, right, down, down_right], dim=-1).reshape(-1, 12)


def make_envmap(image: torch.Tensor, cfg: EnvMapConfig) -> EnvMap:
    image = image.to(torch.float32)
    inv_x, inv_y = build_inverse_cdfs(image)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=image.device)

    return EnvMap(image=image, corner=build_env_corner_table(image),
                  inv_cdf_x=inv_x, inv_cdf_y=inv_y,
                  direct_strength=scalar(cfg.direct_strength),
                  hpm_strength=scalar(cfg.hpm_strength))


def bilinear_lookup(env: EnvMap, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch via the corner table: ONE row gather per sample.
    uv (..., 2) -> (..., 3)."""
    h, w = env.image.shape[0], env.image.shape[1]
    tu = uv[..., 0] * w - 0.5
    tv = uv[..., 1] * h - 0.5
    iu0 = torch.floor(tu)
    iv0 = torch.floor(tv)
    fu = tu - iu0
    # top-edge clamp: both v-corners are row 0, so force fv = 0 there
    fv = torch.where(iv0 < 0, 0.0, tv - iv0)
    iu = torch.remainder(iu0.to(torch.int64), w)  # jnp.mod: divisor's sign
    iv = torch.clamp(iv0.to(torch.int64), 0, h - 1)
    rows = env.corner[iv * w + iu]  # (..., 12)
    c00, c10 = rows[..., 0:3], rows[..., 3:6]
    c01, c11 = rows[..., 6:9], rows[..., 9:12]
    top = c00 + (c10 - c00) * fu[..., None]
    bot = c01 + (c11 - c01) * fu[..., None]
    return top + (bot - top) * fv[..., None]


def dir_to_equirect_uv(direction: torch.Tensor) -> torch.Tensor:
    """uv = (atan2(z,x), asin(y)) * (1/2pi, 1/pi) + 0.5
    (nrc-forward.frag:690-701)."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    u = torch.atan2(z, x) * (1.0 / (2.0 * math.pi)) + 0.5
    v = torch.asin(torch.clamp(y, -1.0, 1.0)) * (1.0 / math.pi) + 0.5
    return torch.stack([u, v], dim=-1)


def sample_direct(env: EnvMap, direction: torch.Tensor,
                  hpm: bool) -> torch.Tensor:
    """SampleHdrEnvMap(dir, hpm) (nrc-forward.frag:703-708): radiance seen
    looking along `direction`, scaled by the chosen strength."""
    rgb = bilinear_lookup(env, dir_to_equirect_uv(direction))
    return rgb * (env.hpm_strength if hpm else env.direct_strength)
