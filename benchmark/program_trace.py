#!/usr/bin/env python3
"""The program's own spans in one cell: a traced run of the harness
(``harness.run_cell`` with ``trace``: its set-up, measured window, two
profile windows, reference check and result), with the program window --
the port's tracer (``utils/profiling.py``) on, for what the harness cannot
see from outside its calls -- run between the measured window and the
profile windows.

    python3 benchmark/program_trace.py --workload <cell> --seed <n> \
        --seconds <s>

Run from the root of a checkout, on the card. The program window has two
parts: (a) 2 x the harness's profiled frames in the same closed loop,
under ``profiling.tracing()`` (the per-layer metrics of ``metrics/`` that
read ``Reading.program`` read this part), and (b) the harness's profiled
frames under the tracer and ``torch.profiler`` (host and device), whose
device-idle gaps are each put down to the innermost program span open on
the host at the time. It prints on stderr the spans' device and host
milliseconds a frame, the idle milliseconds by span, the syncs, the cap
drops by site and the tracing on-cost (part (a)'s mean frame over the
measured window's), and on stdout one JSON line: the metrics and the
harness's result. :func:`program_window` is the part a harness run can
call: it returns None for a program without the tracer (the control, the
reference, an older port), and so every reader of ``Reading.program``
returns None there.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from collections import defaultdict
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import harness, timing, work  # noqa: E402
from benchmark.spec import metric_reader  # noqa: E402

# the metrics that read the program window, in the order they print
METRICS = ("walk_ms", "shade_ms", "query_ms", "finish_ms", "batch_ms",
           "grads_ms", "apply_ms", "syncs_per_frame", "cap_drop_pct")


def tracer(run):
    """The program's ``utils.profiling`` when it has the tracer, else
    None."""
    try:
        mod = importlib.import_module(f"{run.prog.name}.utils.profiling")
    except ModuleNotFoundError:
        return None
    return mod if hasattr(mod, "tracing") else None


def program_window(run, loop, first: int, device: torch.device):
    """Parts (a) and (b) from frame ``first`` on, or None without the
    tracer: {"records": (a)'s records, "window": (a)'s window with the
    harness's own spans around its calls, "sync_sites": (a)'s syncs by span
    and line, "idle": {span: idle seconds} of (b), "profiled_s": (b)'s
    traced seconds}."""
    prof = tracer(run)
    if prof is None:
        return None
    n = harness.PROFILE_FRAMES[run.spec.cell["loop"]]
    with prof.tracing(device) as rec:
        win = timing.run_window(_framed(loop, rec), first, 1e9, device,
                                timing.Spans(device), max_frames=2 * n)
        out = {"records": rec.records(), "window": win,
               "sync_sites": rec.sync_sites}
    with prof.tracing(device) as rec:
        out["idle"], out["profiled_s"] = _idle_by_span(
            _framed(loop, rec), first + 2 * n, n, device)
    return out


def _framed(loop, rec):
    def frame(i, spans):
        with rec.frame(i):
            loop.frame(i, spans)
    return frame


def _idle_by_span(frame, first: int, n: int, device) -> tuple:
    """Frames ``first`` .. ``first + n - 1`` under ``torch.profiler``; each
    device-idle gap between the first and the last device activity split
    by the host's innermost open span (a ``record_function`` of the
    tracer) and summed by its name; "outside" where no span is open.
    Returns ({span: seconds}, the seconds from the first device activity
    to the last)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    timing.sync(device)
    with profile(activities=acts) as p:
        for i in range(first, first + n):
            frame(i, None)
        timing.sync(device)
    busy, notes = [], []
    for e in p.profiler.kineto_results.events():
        kind = timing.activity(e)
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if kind in timing.DEVICE_BUSY:
            busy.append((s, t))
        elif kind == "user_annotation":
            notes.append((s, t, e.name()))
    if not busy:
        return {}, 0.0
    t0, t1 = min(s for s, _ in busy), max(t for _, t in busy)
    return split_gaps(work.gaps(busy, t0, t1), notes), t1 - t0


def split_gaps(gaps, notes) -> dict:
    """{span name: seconds} of the gaps [(start, end)] split at the notes'
    ends [(start, end, name)], each piece given to the innermost note open
    over it (nested notes: the one opened last, the shorter at a tie)."""
    marks = sorted({x for s, t, _ in notes for x in (s, t)}
                   | {x for g in gaps for x in g})
    starts = sorted(notes, key=lambda x: (x[0], -x[1]))
    out = defaultdict(float)
    open_, k, gi = [], 0, 0
    gaps = sorted(gaps)
    for a, b in zip(marks, marks[1:]):
        while k < len(starts) and starts[k][0] <= a:
            open_.append(starts[k])
            k += 1
        open_ = [x for x in open_ if x[1] > a]
        name = (max(open_, key=lambda x: (x[0], -x[1]))[2] if open_
                else "outside")
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        j = gi
        while j < len(gaps) and gaps[j][0] < b:
            out[name] += max(0.0, min(b, gaps[j][1]) - max(a, gaps[j][0]))
            j += 1
    return dict(out)


def trace_cell(workload: str, seed: int, seconds: float,
               device: str | torch.device = "cuda",
               overrides: dict | None = None,
               max_frames: int | None = None) -> dict:
    """A traced harness run of one cell (``harness.run_cell`` with
    ``trace``) with :func:`program_window` called right after the measured
    window, before the harness's two profile windows (after them a frame
    runs 5-12% slower on the card: the profiler's aftermath, not the
    tracer's): the harness's result, the program-window metrics, the
    spans, the idle ms by span, the syncs, the drops and the on-cost."""
    device = torch.device(device)
    run_window, got = timing.run_window, {}

    def then_program(frame, first, *a, **k):
        win = run_window(frame, first, *a, **k)
        if "win" not in got:  # the measured window
            got["win"] = win
            loop = frame.__self__
            got.update(program_window(loop.run, loop, first + win.frames,
                                      device) or {})
        return win

    timing.run_window = then_program
    try:
        result = harness.run_cell(workload, seed, seconds, True, device,
                                  overrides, max_frames=max_frames)
    finally:
        timing.run_window = run_window
    if "records" not in got:
        raise SystemExit("program_trace: the program has no tracer")
    win, records, pwin = got["win"], got["records"], got["window"]
    nb = pwin.frames // 2  # part (b)'s frames: the harness's profiled ones
    # what a reader of Reading.program reads: part (a)'s records
    reading = SimpleNamespace(program=records)
    metrics = {m: metric_reader(m)(reading) for m in METRICS}
    frame_ms = win.seconds * 1e3 / win.frames
    program_ms = pwin.seconds * 1e3 / pwin.frames
    return {
        "metrics": metrics, "result": result, "frame_ms": frame_ms,
        "frames": pwin.frames,
        "program_frame_ms": program_ms, "on_cost": program_ms / frame_ms,
        "harness_spans": _means(win.spans),
        "window_spans": _means(pwin.spans),
        "spans": span_table(records),
        "idle_ms": {k: v * 1e3 / nb for k, v in got["idle"].items()},
        "profiled_frame_ms": got["profiled_s"] * 1e3 / nb,
        "sync_sites": got["sync_sites"], "drops": drops_by_site(records)}


def _means(spans: dict) -> dict:
    return {k: sum(v) / len(v) for k, v in spans.items()}


def span_table(records) -> dict:
    """{span: [device ms a frame, host ms a frame, calls a frame]} over the
    frames of the records (device ms None off the card)."""
    frames = {r.frame for r in records if r.name == "frame"}
    out = {}
    for r in records:
        if r.frame not in frames:
            continue
        d = out.setdefault(r.name, [0.0, 0.0, 0])
        d[0] = None if r.device_ms is None or d[0] is None \
            else d[0] + r.device_ms
        d[1] += (r.host_end_ns - r.host_start_ns) * 1e-6
        d[2] += 1
    n = len(frames)
    return {k: [None if d is None else d / n, h / n, c / n]
            for k, (d, h, c) in out.items()}


def drops_by_site(records) -> dict:
    """{"span/site": {"live", "cap", "dropped"}} summed over the frames."""
    out = {}
    for r in records:
        if r.frame is None:
            continue
        for site, c in r.caps.items():
            d = out.setdefault(f"{r.name}/{site}",
                               {"live": 0, "cap": 0, "dropped": 0})
            for k in d:
                d[k] += c[k]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    harness.log(harness.device_line())
    out = trace_cell(args.workload, args.seed, args.seconds, device)
    for name, (dev_ms, host_ms, calls) in out["spans"].items():
        harness.log(f"span {name}: device {dev_ms:.4f} ms, host "
                    f"{host_ms:.4f} ms, {calls:g} calls a frame")
    harness.log(f"profiled frames (part b): {out['profiled_frame_ms']:.4f} "
                f"ms a frame, device first to last activity")
    for name, ms in sorted(out["idle_ms"].items(), key=lambda kv: -kv[1]):
        harness.log(f"idle under {name}: {ms:.4f} ms a frame")
    for site, k in sorted(out["sync_sites"].items(), key=lambda kv: -kv[1]):
        harness.log(f"syncs at {site}: {k / out['frames']:g} a frame")
    for site, c in out["drops"].items():
        harness.log(f"cap {site}: live {c['live']}, cap {c['cap']}, dropped "
                    f"{c['dropped']}")
    harness.log(f"harness spans (ms a call): measured window "
                f"{out['harness_spans']}, program window "
                f"{out['window_spans']}")
    harness.log(f"tracing on-cost: program window "
                f"{out['program_frame_ms']:.4f} ms a frame over the measured "
                f"window's {out['frame_ms']:.4f} = {out['on_cost']:.4f}")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
