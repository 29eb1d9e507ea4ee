"""ctypes bindings for the port's native IO library (``csrc/nrcio.cpp``), the
counterpart of ``neuralradiancecaching_tpu/io/native.py`` on its load path:
``available`` and ``hdr_decode``, the only two that a loader of the JAX
package calls (``io/hdr.py:read_hdr``). Its other bindings are called only
by the JAX package's own tests and have no counterpart here.

``kernels`` builds the library with the host C++ compiler at first use;
:func:`hdr_decode` builds it if needed, and a failed build raises.
``assets.read_hdr`` decodes through it; ``assets`` keeps the pure-Python
RLE decode as its plain version (``hdr_decode_plain``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from neuralradiancecaching_tpu_torch import kernels


def _load() -> ctypes.CDLL:
    lib = kernels.load("nrcio")
    if lib.nrc_hdr_decode.argtypes is None:
        lib.nrc_hdr_decode.restype = ctypes.c_int
        lib.nrc_hdr_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
    return lib


def available() -> bool:
    """Whether the build of this exact source exists (nothing is built)."""
    return kernels.library_path("nrcio").exists()


def hdr_decode(payload: bytes, width: int, height: int) -> np.ndarray:
    lib = _load()
    out = np.empty((height, width, 3), dtype=np.float32)
    rc = lib.nrc_hdr_decode(payload, len(payload), width, height,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"nrc_hdr_decode failed rc={rc}")
    return out
