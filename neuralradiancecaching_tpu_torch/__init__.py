"""nrc-tpu ported to PyTorch and CUDA: the neural radiance caching volume
renderer on an NVIDIA Hopper GPU.

A second package beside :mod:`neuralradiancecaching_tpu`, which stays the
JAX reference the port is held to. It mirrors that package's layout --
``config``, ``io/``, ``ops/``, ``scene/``, ``models/``, ``render/`` with the
same module and function names -- and keeps its own copy of the JAX-free
modules it needs (``config``, the scene loaders of ``io.assets``). It
imports ``torch`` and never ``jax`` nor anything of the JAX package. Its
constructors place tensors on the card unless the caller names another
device; randomness comes from explicit ``torch.Generator``s or from
caller-supplied uniforms.

Ported so far: the online frame (``render.frame.frame_step``: the train
batch, the train step with guarded Adam, and the cached render) with the
reference, collision and delta samplers and every light mode, the
unbiased ground-truth oracle, config 5's banded progressive frame
(``render.tiled``), the CLI's workloads, and data parallel across cards
(``parallel``: torch.distributed, one process per card); the cache query runs the
hand-written CUDA kernel ``csrc/fused_mlp.cu``, and the generic fp32
matrix product is ``csrc/matmul.cu`` (``ops.matmul``). Both are built at
first use by :mod:`.kernels`.
"""

__version__ = "0.2.0"
