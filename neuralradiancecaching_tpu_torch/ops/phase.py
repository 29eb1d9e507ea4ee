"""Henyey-Greenstein phase function and direction sampling from uniforms.

Counterpart of ``neuralradiancecaching_tpu/ops/phase.py`` (reference
hg_phase_func nrc-train.comp:415-421, NewRayDir :436-471). Randomness comes
from the caller as uniforms, so both packages can be fed the same numbers.
"""

from __future__ import annotations

import math

import torch


def hg_phase(cos_theta: torch.Tensor, g: float) -> torch.Tensor:
    """Henyey-Greenstein phase with the reference's 0.5*(1-g^2)/(...)^1.5
    normalization. ``g`` is rounded to the tensor's dtype first, as in JAX."""
    g = torch.as_tensor(g, dtype=cos_theta.dtype, device=cos_theta.device)
    g2 = g * g
    return 0.5 * (1.0 - g2) / torch.pow(1.0 + g2 - 2.0 * g * cos_theta, 1.5)


def sample_hg_cos_theta(u: torch.Tensor, g: float) -> torch.Tensor:
    """Inverse-CDF sample of HG cos(theta); isotropic for |g| < 1e-3."""
    if abs(g) < 1e-3:
        cos_theta = 1.0 - 2.0 * u
    else:
        g = torch.as_tensor(g, dtype=u.dtype, device=u.device)
        sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
        cos_theta = (1.0 + g * g - sqr * sqr) / (2.0 * g)
    return torch.clamp(cos_theta, -1.0, 1.0)


def orthonormal_basis(d: torch.Tensor):
    """Two unit vectors orthogonal to unit d (..., 3): the reference's
    branch (nrc-train.comp:445), z < x picks (y, -x, 0) else (0, -z, y)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    zeros = torch.zeros_like(x)
    t = torch.where((z < x)[..., None],
                    torch.stack([y, -x, zeros], dim=-1),
                    torch.stack([zeros, -z, y], dim=-1))
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    b = torch.linalg.cross(d, t, dim=-1)
    return t, b


def hg_direction_from_uniforms(u_cos: torch.Tensor, u_phi: torch.Tensor,
                               old_dir: torch.Tensor, g: float
                               ) -> torch.Tensor:
    """NewRayDir core with caller-provided uniforms."""
    old_dir = old_dir / torch.linalg.vector_norm(old_dir, dim=-1,
                                                 keepdim=True)
    cos_t = sample_hg_cos_theta(u_cos, g)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u_phi * (2.0 * math.pi)
    t, b = orthonormal_basis(old_dir)
    new_dir = (cos_t[..., None] * old_dir
               + (sin_t * torch.cos(phi))[..., None] * t
               + (sin_t * torch.sin(phi))[..., None] * b)
    return new_dir / torch.linalg.vector_norm(new_dir, dim=-1, keepdim=True)


def sample_hg_direction(old_dir: torch.Tensor, g: float,
                        uniforms: torch.Tensor) -> torch.Tensor:
    """NewRayDir (nrc-train.comp:436-471): scatter unit ``old_dir``
    (..., 3) by an HG-sampled polar angle and a uniform azimuth, from
    ``uniforms`` (2, ...) = (u_cos, u_phi) -- the JAX draw of phase.py:80
    splits its key into one uniform each."""
    return hg_direction_from_uniforms(uniforms[0], uniforms[1], old_dir, g)


def uniform_sphere(shape, generator: torch.Generator | None = None,
                   uniforms: torch.Tensor | None = None,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Uniform directions on S^2, shape (*shape, 3), from ``uniforms`` (2,
    *shape) = (u_z, u_phi) -- the JAX draw splits its key into one uniform
    each -- or drawn from ``generator``."""
    if uniforms is None:
        uniforms = torch.rand((2, *shape), generator=generator, dtype=dtype,
                              device=device)
    z = uniforms[0] * 2.0 - 1.0
    phi = uniforms[1] * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), z, r * torch.sin(phi)], dim=-1)
