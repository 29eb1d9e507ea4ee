"""Utilities: counterparts of neuralradiancecaching_tpu.utils."""

from neuralradiancecaching_tpu_torch.utils.runtime import (  # noqa: F401
    setup_cache)
