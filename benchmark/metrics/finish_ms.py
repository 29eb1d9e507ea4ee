"""finish_ms: the device milliseconds of the finish of a frame
(`render.finish`: the un-pack and the env composite), from the program's
own span summed over the program window's frames over their count."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.ms_a_frame(r, "render.finish")
