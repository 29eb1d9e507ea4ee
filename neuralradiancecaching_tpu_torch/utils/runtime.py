"""Runtime setup: the directory of the port's built libraries.

The counterpart of ``neuralradiancecaching_tpu/utils/runtime.py``, whose
``setup_cache`` turns on XLA's persistent compilation cache so that the
first process pays the compile and every later one starts at once. The
port's compiled code is its hand-written kernels and its host library,
which ``kernels`` builds once per source and flags into a directory and
loads from there in every later process: that cache is on without any
setup, in ``neuralradiancecaching_tpu_torch/_build/``. ``setup_cache``
moves it, for a process that wants its libraries elsewhere.
"""

from __future__ import annotations

import os
from pathlib import Path

from neuralradiancecaching_tpu_torch import kernels


def setup_cache(path: str | os.PathLike | None = None) -> None:
    """Make ``kernels`` build and load every library (``csrc/*.cu`` and
    ``csrc/*.cpp``) not yet loaded in this process in ``path``, by default
    ``neuralradiancecaching_tpu_torch/_build/`` (idempotent). A library
    stays loaded from where it was loaded first, so moving the directory
    after a library is loaded raises."""
    target = Path(path) if path else kernels.DEFAULT_BUILD_DIR
    if target == kernels.BUILD_DIR:
        return
    if kernels._LIBS:
        raise RuntimeError(
            f"setup_cache({str(target)!r}): {sorted(kernels._LIBS)} already "
            f"loaded from {kernels.BUILD_DIR}; call it before the first "
            f"library is loaded")
    kernels.BUILD_DIR = target
