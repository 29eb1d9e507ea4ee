"""Data parallel across cards: process groups and the SPMD frame, train and
render steps (counterpart of ``neuralradiancecaching_tpu/parallel``).

Rays and pixels are sharded over the ranks, the cache state is replicated,
and the gradient and loss mean is one all_reduce -- the multi-device form
of the reference's single-GPU atomic reduction.
"""

from neuralradiancecaching_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, close_mesh, default_mesh, make_mesh, spawn, world_size)
from neuralradiancecaching_tpu_torch.parallel.data_parallel import (  # noqa: F401,E501
    DPCapReport, dp_frame_step, dp_render, dp_render_banded,
    dp_render_banded_packed, dp_train_banded_frame, dp_train_step,
    probe_dp_caps)
