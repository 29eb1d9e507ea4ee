"""The tiny fully-connected MLP of the radiance cache, in plain PyTorch.

Counterpart of ``neuralradiancecaching_tpu/ops/mlp.py``. Weights keep the
JAX layout -- ``w{i}`` of shape (in, out), ``b{i}`` of shape (out,) -- so the
forward is ``x @ w + b`` and parameters convert between the packages as they
are. This is the plain forward and the autodiff path; the fused CUDA kernel
of the query path lives in :mod:`.fused_mlp`.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from neuralradiancecaching_tpu.config import MLPConfig

Params = Dict[str, torch.Tensor]


def layer_dims(cfg: MLPConfig) -> List[int]:
    """[in, hidden, ..., hidden, out] -- n_layers matmuls total."""
    return ([cfg.in_features] + [cfg.hidden] * (cfg.n_layers - 1)
            + [cfg.out_features])


def init_params(generator: torch.Generator, cfg: MLPConfig,
                dtype=torch.float32) -> Params:
    """Weights N(0, weight_init_std^2), biases zero, on the generator's
    device."""
    dims = layer_dims(cfg)
    device = generator.device
    params: Params = {}
    for i in range(cfg.n_layers):
        params[f"w{i}"] = torch.randn(
            (dims[i], dims[i + 1]), generator=generator, dtype=dtype,
            device=device) * cfg.weight_init_std
        params[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=dtype,
                                      device=device)
    return params


def _activate(h: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    if cfg.activation == "sigmoid":
        return torch.sigmoid(h)
    return torch.relu(h)


def apply(params: Params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Forward pass. x: (..., in_features) -> (..., out_features), with the
    activation after every layer and after the output when
    ``cfg.output_relu``."""
    h = x
    for i in range(cfg.n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < cfg.n_layers - 1 or cfg.output_relu:
            h = _activate(h, cfg)
    return h
