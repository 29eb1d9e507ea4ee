"""apply_ms: the device milliseconds of the optimizer steps of a training
frame (`train.apply`: `nrc.apply_grads`, both guarded Adam steps), from
the program's own span summed over the program window's training frames
over their count."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.ms_a_frame(r, "train.apply", training=True)
