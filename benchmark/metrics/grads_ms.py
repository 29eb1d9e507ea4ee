"""grads_ms: the device milliseconds of the gradients of a training frame
(`train.grads`: `nrc.compute_grads`, the encode, the loss and autograd),
from the program's own span summed over the program window's training
frames over their count."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.ms_a_frame(r, "train.grads", training=True)
