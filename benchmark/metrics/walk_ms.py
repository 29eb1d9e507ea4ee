"""walk_ms: the device milliseconds of the collect walk of a frame
(`render.walk`: `tiled._walk_bands`/`walk_rows` over the packed bands,
or `pathtrace.trace_path` inside `render_image`), from the program's own
span summed over the program window's frames over their count."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.ms_a_frame(r, "render.walk")
