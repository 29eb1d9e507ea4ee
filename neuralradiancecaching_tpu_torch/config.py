"""The run configuration: the JAX package's config module, shared as is.

``neuralradiancecaching_tpu.config`` is plain dataclasses (stdlib only, and
the JAX package's ``__init__`` imports nothing else), so one ``NRCConfig``
drives both packages. Re-exported here so users of the port import it from
the port.
"""

from neuralradiancecaching_tpu.config import *  # noqa: F401,F403
