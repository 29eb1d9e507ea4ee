"""nrc-tpu ported to PyTorch and CUDA: the neural radiance caching volume
renderer on an NVIDIA Hopper GPU.

A second package beside :mod:`neuralradiancecaching_tpu`, which stays the
JAX reference the port is held to. It mirrors that package's layout --
``ops/``, ``scene/``, ``models/``, ``render/`` with the same module and
function names -- and shares its JAX-free modules (``config``,
``io.assets``). It imports ``torch`` and never ``jax``. Devices are taken
from the input tensors; randomness comes from explicit ``torch.Generator``s.

Ported so far: the cached serving render (``render.frame.render_only_step``)
with the collision sampler, whose cache query runs the hand-written CUDA
kernel ``csrc/fused_mlp.cu`` (built at first use by :mod:`.kernels`).
"""

__version__ = "0.1.0"
