"""transmittance_ms: the device milliseconds a frame of the quadrature
transmittance (`ops/volume.py` `transmittance` and `transmittance_ratio`:
the program's span `transmittance`, every call of either estimator in the
walk, the shade and the train batch), summed over each frame of a traced
run's measured window by the loop (`loops/exact_frame.py`, from the
span's CUDA events) and averaged over the frames. None where the program
has no such span."""

from __future__ import annotations

import statistics


def read(r):
    ms = r.spans.get("transmittance")
    return statistics.fmean(ms) if ms else None
