"""syncs_per_frame: implicit host-device syncs (``.item()``, ``nonzero``,
a copy to the host: what ``torch.cuda.set_sync_debug_mode("warn")``
reports) counted inside the program's spans over the program window's
frames; the harness's own are left out."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.syncs_a_frame(r)
