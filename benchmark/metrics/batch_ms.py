"""batch_ms: the device milliseconds of the train batch of a training frame
(`train.batch`: `targets.generate_train_batch`, the target walks and
their shade), from the program's own span summed over the program
window's training frames over their count."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.ms_a_frame(r, "train.batch", training=True)
