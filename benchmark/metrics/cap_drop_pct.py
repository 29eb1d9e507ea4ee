"""cap_drop_pct: 100 x the lanes or events that the program's fixed caps
dropped over those live at the caps, summed over every capped site of the
program window's frames (``utils.profiling.cap``: the live-ray pack, the
walks' repacks, the shade packs, the query pack, the target-event caps);
each site's share is printed on stderr."""

from __future__ import annotations

from benchmark import spans


def read(r):
    return spans.drop_pct(r)
