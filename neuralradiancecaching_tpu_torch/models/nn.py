"""Generic sequential NN API -- the reference's vestigial compute library
(include/engine/compute/: Matrix, Matmul, Layer, LinearLayer, SigmoidLayer,
NeuralNetwork -- headers declared, never implemented) made real.

Counterpart of ``neuralradiancecaching_tpu/models/nn.py``: layers are
declarative specs, parameters live in one dict keyed ``w{i}``/``b{i}`` in
the JAX layout ((in, out) weights), the forward is a fold over the layers
with ``torch.matmul`` as the product (the JAX one is ``jnp.dot``), and
training reuses the guarded momentum-SGD of :mod:`..ops.optimizers`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from neuralradiancecaching_tpu_torch.config import OptimizerConfig
from neuralradiancecaching_tpu_torch.ops import optimizers

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Linear:
    """LinearLayer.hpp equivalent: y = x @ W + b."""

    in_features: int
    out_features: int
    init_std: float = 0.1


@dataclass(frozen=True)
class Sigmoid:
    """SigmoidLayer.hpp equivalent."""


@dataclass(frozen=True)
class Relu:
    pass


Layer = object  # Linear | Sigmoid | Relu


def state_from_numpy(d: Mapping, device: torch.device | str = "cuda"
                     ) -> Params:
    """Parameters (or momentum) on ``device`` from the JAX dict's arrays
    as numpy arrays; dtype and shape kept."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in d.items()}


class Sequential:
    """NeuralNetwork.hpp equivalent: an ordered stack of layers.

    >>> net = Sequential([Linear(4, 8), Sigmoid(), Linear(8, 2)])
    >>> params = net.init(torch.Generator().manual_seed(0))
    >>> y = net.apply(params, x)
    """

    def __init__(self, layers: List[Layer]):
        self.layers = tuple(layers)

    def init(self, generator: torch.Generator,
             dtype=torch.float32) -> Params:
        """Weights N(0, init_std^2) drawn from ``generator`` layer by layer,
        biases zero, on the generator's device."""
        params: Params = {}
        i = 0
        for layer in self.layers:
            if isinstance(layer, Linear):
                params[f"w{i}"] = torch.randn(
                    (layer.in_features, layer.out_features),
                    generator=generator, dtype=dtype,
                    device=generator.device) * layer.init_std
                params[f"b{i}"] = torch.zeros((layer.out_features,),
                                              dtype=dtype,
                                              device=generator.device)
                i += 1
        return params

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = x
        i = 0
        for layer in self.layers:
            if isinstance(layer, Linear):
                h = torch.matmul(h, params[f"w{i}"]) + params[f"b{i}"]
                i += 1
            elif isinstance(layer, Sigmoid):
                h = torch.sigmoid(h)
            elif isinstance(layer, Relu):
                h = torch.relu(h)
            else:
                raise TypeError(f"unknown layer {layer!r}")
        return h

    def train_step(self, params: Params, momentum: Params, x, target,
                   opt: OptimizerConfig) -> Tuple[Params, Params,
                                                  torch.Tensor]:
        """One guarded momentum-SGD step on MSE loss (the NeuralNetwork
        'Backprop' the reference never implemented): (params, momentum,
        loss)."""
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = torch.mean((self.apply(p, x) - target) ** 2)
            grads = torch.autograd.grad(loss, list(p.values()))
        params, momentum = optimizers.momentum_sgd_step(
            params, momentum, dict(zip(p, grads)), opt)
        return params, momentum, loss.detach()
