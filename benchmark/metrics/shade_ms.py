"""shade_ms: the device milliseconds of the deferred event shade of a frame
(`render.shade`: `pathtrace.shade_and_query`'s shade, slot 0 included;
config 4 shades inside its walk and has none), from the program's own
span summed over the program window's frames over their count."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.ms_a_frame(r, "render.shade")
