"""The arithmetic of the metrics that read the program's own spans
(``Reading.program``: the records of ``utils.profiling.tracing()`` over
the program window's frames, :mod:`benchmark.program_trace`). A reading
without them -- the control, the reference, a program without the
tracer, a harness that runs no program window -- gives None."""

from __future__ import annotations

import sys


def _records(r):
    return getattr(r, "program", None) or None


def _frames(records, training: bool = False) -> set:
    ids = {x.frame for x in records if x.name == "frame"}
    if training:
        ids &= {x.frame for x in records if x.name == "train"}
    return ids


def ms_a_frame(r, name: str, training: bool = False):
    """The device milliseconds of span ``name`` summed over the window's
    frames (``training``: its training frames) over their count; None
    when the span never ran or has no device time (off the card)."""
    records = _records(r)
    if records is None:
        return None
    ids = _frames(records, training)
    ms = [x.device_ms for x in records if x.name == name and x.frame in ids]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(ids)


def syncs_a_frame(r):
    """Implicit host-device syncs inside the program's spans (the
    harness's ``frame`` span left out) over the window's frames."""
    records = _records(r)
    if records is None:
        return None
    ids = _frames(records)
    if not ids:
        return None
    return sum(x.counts.get("syncs", 0) for x in records
               if x.frame in ids and x.name != "frame") / len(ids)


def drop_pct(r):
    """100 x the lanes or events dropped over those live at every capped
    site of the window's frames; each site's share goes to stderr. None
    when no capped site ran."""
    records = _records(r)
    if records is None:
        return None
    ids = _frames(records)
    sites = {}
    for x in records:
        if x.frame in ids:
            for site, c in x.caps.items():
                live, dropped = sites.get(f"{x.name}/{site}", (0, 0))
                sites[f"{x.name}/{site}"] = (live + c["live"],
                                             dropped + c["dropped"])
    live = sum(v[0] for v in sites.values())
    if live == 0:
        return None
    for site, (n, d) in sorted(sites.items()):
        print(f"# cap {site}: {d} of {n} dropped "
              f"({100.0 * d / n if n else 0.0:.4f}%)", file=sys.stderr)
    return 100.0 * sum(v[1] for v in sites.values()) / live
