"""Asset loading: the JAX package's numpy-only loaders, shared as is.

The cloud volume and env map load from the reference data when present and
otherwise synthesize deterministic stand-ins of the same shape
(``neuralradiancecaching_tpu/io/assets.py``).
"""

from neuralradiancecaching_tpu.io.assets import *  # noqa: F401,F403
