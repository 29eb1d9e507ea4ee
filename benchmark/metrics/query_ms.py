"""query_ms: the device milliseconds of the cache query of a frame
(`render.query`: the hash encode and K1, `_capped_query`'s pack
included), from the program's own span summed over the program window's
frames over their count."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.ms_a_frame(r, "render.query")
