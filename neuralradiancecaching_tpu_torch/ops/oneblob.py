"""One-blob direction encoding: Gaussian bins for theta and for phi.

Counterpart of ``neuralradiancecaching_tpu/ops/oneblob.py`` (reference
nrc-train.comp:344-365), including the ``QuirkFlags.raw_oneblob`` literal
reference formula.
"""

from __future__ import annotations

import math

import torch

from neuralradiancecaching_tpu.config import OneBlobConfig, QuirkFlags


def norm_gauss(x: torch.Tensor, mean: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """Gaussian pdf (nrc-train.comp:344-350)."""
    z = (x - mean) / sigma
    return (1.0 / (sigma * math.sqrt(2.0 * math.pi))) * torch.exp(-0.5 * z * z)


def dir_to_angles(direction: torch.Tensor, raw: bool) -> torch.Tensor:
    """Unit direction (..., 3) -> (theta, phi) in [0,1]^2, shape (..., 2)."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    theta = torch.atan2(z, x) / math.pi + 0.5
    phi = torch.atan2(torch.sqrt(x * x + z * z), y) / math.pi
    if raw:
        phi = phi + 0.5  # the reference's out-of-range [0.5, 1.5] mapping
    return torch.stack([theta, phi], dim=-1)


def encode_angles(angles: torch.Tensor, cfg: OneBlobConfig,
                  raw: bool) -> torch.Tensor:
    """angles: (..., A) in [0,1] -> (..., A*n_bins), bin-major per angle."""
    k = cfg.n_bins
    bins = torch.arange(k, dtype=angles.dtype, device=angles.device)
    if raw:
        mean = angles[..., None]
        sigma = cfg.sigma
    else:
        mean = angles[..., None] * k
        sigma = cfg.sigma * k
    feats = norm_gauss(bins, mean, sigma)  # (..., A, K)
    return feats.reshape(*angles.shape[:-1], angles.shape[-1] * k)


def encode_dir(direction: torch.Tensor, cfg: OneBlobConfig,
               quirks: QuirkFlags) -> torch.Tensor:
    """Unit direction (..., 3) -> (..., 2*n_bins): [theta bins | phi bins]."""
    angles = dir_to_angles(direction, quirks.raw_oneblob)
    return encode_angles(angles, cfg, quirks.raw_oneblob)
