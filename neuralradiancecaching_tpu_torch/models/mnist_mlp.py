"""BASELINE config 1: the MNIST tiny-MLP supervised fit.

Counterpart of ``neuralradiancecaching_tpu/models/mnist_mlp.py``: the
radiance cache's MLP machinery and guarded momentum-SGD trained as a
10-class classifier with softmax cross-entropy. The minibatch draws are
explicit: ``train`` takes a (steps, batch) index tensor, or draws one from
a CPU generator seeded with ``seed`` after the weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from neuralradiancecaching_tpu_torch.config import MLPConfig, OptimizerConfig
from neuralradiancecaching_tpu_torch.models import nn
from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
from neuralradiancecaching_tpu_torch.ops import optimizers


@dataclass
class MnistState:
    params: Dict[str, torch.Tensor]
    momentum: Dict[str, torch.Tensor]


def init_state(generator: torch.Generator, cfg: MLPConfig,
               device: torch.device | str = "cuda") -> MnistState:
    """Fresh weights drawn from ``generator``, moved to ``device`` (the
    card unless the caller names another), zero momentum."""
    params = {k: v.to(device)
              for k, v in mlp_ops.init_params(generator, cfg).items()}
    return MnistState(params, optimizers.init_momentum(params))


def state_from_numpy(d: Mapping, device: torch.device | str = "cuda"
                     ) -> MnistState:
    """The port's state on ``device`` from the JAX MnistState's fields as
    numpy arrays (``jax.tree_util.tree_map(np.asarray, s)._asdict()``)."""
    return MnistState(nn.state_from_numpy(d["params"], device),
                      nn.state_from_numpy(d["momentum"], device))


def loss_fn(params, x: torch.Tensor, labels: torch.Tensor, cfg: MLPConfig):
    """Softmax cross-entropy; returns (loss, accuracy)."""
    logits = mlp_ops.apply(params, x, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None].long()))
    acc = torch.mean((torch.argmax(logits, dim=1) == labels).float())
    return loss, acc


def train_step(state: MnistState, x: torch.Tensor, labels: torch.Tensor,
               cfg: MLPConfig, opt: OptimizerConfig
               ) -> Tuple[MnistState, torch.Tensor, torch.Tensor]:
    """One guarded momentum-SGD step: (new state, loss, accuracy)."""
    p = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    with torch.enable_grad():
        loss, acc = loss_fn(p, x, labels, cfg)
        grads = torch.autograd.grad(loss, list(p.values()))
    params, momentum = optimizers.momentum_sgd_step(
        state.params, state.momentum, dict(zip(p, grads)), opt)
    return MnistState(params, momentum), loss.detach(), acc


def train(x, labels, cfg: MLPConfig, opt: OptimizerConfig, steps: int = 200,
          batch_size: int = 256, seed: int = 0,
          indices: Optional[torch.Tensor] = None,
          device: torch.device | str = "cuda"):
    """Minibatch training on ``device`` from fresh weights (a CPU generator
    seeded with ``seed``). ``indices``: the (steps, batch_size) sample
    indices of every step; drawn uniformly from the same generator when
    None. Returns (state, final_loss, final_acc)."""
    gen = torch.Generator().manual_seed(seed)
    state = init_state(gen, cfg, device)
    x = torch.as_tensor(np.asarray(x), device=device)
    labels = torch.as_tensor(np.asarray(labels), device=device)
    if indices is None:
        indices = torch.randint(0, x.shape[0], (steps, batch_size),
                                generator=gen)
    indices = indices.to(device)
    loss = acc = None
    for i in range(steps):
        idx = indices[i]
        state, loss, acc = train_step(state, x[idx], labels[idx], cfg, opt)
    return state, float(loss), float(acc)
