"""BASELINE config 2: 2-D image fit -- MRHE(2D) + tiny MLP regression.

Counterpart of ``neuralradiancecaching_tpu/models/image_fit.py``: regress
RGB(u, v) of a target image through the 2-D hash-path encode, whose
backward (the scatter-add that replaces the reference's atomicAdd into
mrDeltaHashTable) trains the table. The minibatch draws are explicit:
``fit_image`` takes a (steps, batch) pixel-index tensor, or draws one from
a CPU generator seeded with ``seed`` after the state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from neuralradiancecaching_tpu_torch.config import (MLPConfig, MRHEConfig,
                                                    OptimizerConfig,
                                                    QuirkFlags)
from neuralradiancecaching_tpu_torch.models import nn
from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
from neuralradiancecaching_tpu_torch.ops import mrhe as mrhe_ops
from neuralradiancecaching_tpu_torch.ops import optimizers


@dataclass
class ImageFitState:
    mlp_params: Dict[str, torch.Tensor]
    mlp_momentum: Dict[str, torch.Tensor]
    hash_table: torch.Tensor  # (L, T, F)


def default_configs() -> Tuple[MRHEConfig, MLPConfig, OptimizerConfig]:
    mrhe_cfg = MRHEConfig(n_dims=2)
    mlp_cfg = MLPConfig(in_features=mrhe_cfg.n_outputs, hidden=64,
                        out_features=3, n_layers=4, output_relu=True)
    opt = OptimizerConfig(learning_rate=0.01, beta1=0.5)
    return mrhe_cfg, mlp_cfg, opt


def init_state(generator: torch.Generator, mrhe_cfg: MRHEConfig,
               mlp_cfg: MLPConfig, device: torch.device | str = "cuda"
               ) -> ImageFitState:
    """Weights, then the table, drawn from ``generator`` and moved to
    ``device`` (the card unless the caller names another)."""
    params = {k: v.to(device)
              for k, v in mlp_ops.init_params(generator, mlp_cfg).items()}
    table = mrhe_ops.init_table(generator, mrhe_cfg).to(device)
    return ImageFitState(params, optimizers.init_momentum(params), table)


def state_from_numpy(d: Mapping, device: torch.device | str = "cuda"
                     ) -> ImageFitState:
    """The port's state on ``device`` from the JAX ImageFitState's fields
    as numpy arrays (``jax.tree_util.tree_map(np.asarray, s)._asdict()``)."""
    return ImageFitState(
        nn.state_from_numpy(d["mlp_params"], device),
        nn.state_from_numpy(d["mlp_momentum"], device),
        torch.from_numpy(np.array(d["hash_table"], copy=True)).to(device))


def predict(state: ImageFitState, uv: torch.Tensor, mrhe_cfg: MRHEConfig,
            mlp_cfg: MLPConfig,
            quirks: QuirkFlags = QuirkFlags()) -> torch.Tensor:
    """uv (N, 2) in [0,1]^2 -> rgb (N, 3)."""
    feats = mrhe_ops.encode(state.hash_table, uv, mrhe_cfg, quirks)
    return mlp_ops.apply(state.mlp_params, feats, mlp_cfg)


def train_step(state: ImageFitState, uv: torch.Tensor, rgb: torch.Tensor,
               mrhe_cfg: MRHEConfig, mlp_cfg: MLPConfig,
               opt: OptimizerConfig, quirks: QuirkFlags = QuirkFlags()
               ) -> Tuple[ImageFitState, torch.Tensor]:
    """One step: gradients through the hash-path encode and the MLP, then
    guarded momentum-SGD on the MLP and guarded SGD on the table.
    Returns (new state, mse stat)."""
    params = {k: v.detach().requires_grad_()
              for k, v in state.mlp_params.items()}
    table = state.hash_table.detach().requires_grad_()
    with torch.enable_grad():
        feats = mrhe_ops.encode(table, uv, mrhe_cfg, quirks)
        loss, mse = mlp_ops.nrc_loss(params, feats, rgb, mlp_cfg)
        grads = torch.autograd.grad(loss, [*params.values(), table])
    params, momentum = optimizers.momentum_sgd_step(
        state.mlp_params, state.mlp_momentum, dict(zip(params, grads[:-1])),
        opt)
    table = optimizers.hash_sgd_step(state.hash_table, grads[-1], mrhe_cfg)
    return ImageFitState(params, momentum, table), mse.detach()


def pixel_uv(idx: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Flat pixel indices of an (h, w) image -> (..., 2) uv = (x/w, y/h)."""
    vy = torch.div(idx, w, rounding_mode="floor").to(torch.float32) / h
    vx = (idx % w).to(torch.float32) / w
    return torch.stack([vx, vy], dim=-1)


def fit_image(image, steps: int = 500, batch_size: int = 8192,
              seed: int = 0, mrhe_cfg=None, mlp_cfg=None, opt=None,
              indices: Optional[torch.Tensor] = None,
              device: torch.device | str = "cuda"):
    """Fit RGB(u,v) of an (H, W, 3) image on ``device`` from a fresh state
    (a CPU generator seeded with ``seed``). ``indices``: the (steps,
    batch_size) flat pixel indices of every step; drawn uniformly from the
    same generator when None. Returns (state, full-image psnr_db)."""
    d_mrhe, d_mlp, d_opt = default_configs()
    mrhe_cfg = mrhe_cfg or d_mrhe
    mlp_cfg = mlp_cfg or d_mlp
    opt = opt or d_opt

    image = torch.as_tensor(np.asarray(image), dtype=torch.float32,
                            device=device)
    h, w = image.shape[:2]
    gen = torch.Generator().manual_seed(seed)
    state = init_state(gen, mrhe_cfg, mlp_cfg, device)
    if indices is None:
        indices = torch.randint(0, h * w, (steps, batch_size), generator=gen)
    indices = indices.to(device)

    flat = image.reshape(-1, 3)
    for i in range(steps):
        idx = indices[i]
        state, _ = train_step(state, pixel_uv(idx, h, w), flat[idx],
                              mrhe_cfg, mlp_cfg, opt)

    # full-image PSNR
    pred = predict(state, pixel_uv(torch.arange(h * w, device=device), h, w),
                   mrhe_cfg, mlp_cfg)
    mse = torch.mean((pred - flat) ** 2)
    peak = torch.clamp(torch.max(flat), min=1.0)
    psnr = 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-12))
    return state, float(psnr)
