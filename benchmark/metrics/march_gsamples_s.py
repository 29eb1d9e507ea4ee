"""march_gsamples_s: billions of trilinear density samples a second inside
the transmittance estimators: the program's count `density_samples` (rows
x steps of each call of `ops/volume.py` `transmittance` and
`transmittance_ratio`) over the device seconds of their `transmittance`
spans, both summed over a traced run's measured window
(`loops/exact_frame.py`). A rate, not a share of a peak: the corner table
(~52 MB at 125x85x153) is about the size of the card's L2, so bytes over
HBM's rate could pass 100% once a kernel keeps it resident. None where the
program has no such span."""

from __future__ import annotations


def read(r):
    ms = r.spans.get("transmittance")
    samples = r.work.get("density_samples")
    if not ms or not samples or len(samples) != len(ms) or sum(ms) <= 0.0:
        return None
    return sum(samples) / (sum(ms) * 1e-3) / 1e9
