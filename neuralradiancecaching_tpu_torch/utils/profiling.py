"""Profiling: a ``torch.profiler`` trace to disk, and the port's tracer.

Counterpart of ``neuralradiancecaching_tpu/utils/profiling.py``: the
reference's FPS title bar and frame-dt Time class (SURVEY.md §5) become a
``torch.profiler`` trace (:func:`trace`) and named spans on the device's
clock (:func:`span`).

The tracer is off unless a :func:`tracing` block is open. Off, :func:`span`
returns one shared null context after one module-level check, and
:func:`count` and :func:`cap` return at once: no torch call, no event, no
allocation, so the program launches what it launches untraced. On, each
span records its name, its parent, the frame id of the innermost
``recorder.frame(i)``, the host clock at its ends and a CUDA event pair on
the current stream (read only when the records are collected, never
synchronized inside a frame), and opens a ``record_function`` while
``torch.profiler`` runs, so the span lies on the trace's timeline on the
kernels' clock. :func:`count` adds to the innermost span's counts and
:func:`cap` records a capped pack's live count, cap and drop, summed on
the device. On CUDA the block sets ``torch.cuda.set_sync_debug_mode("warn")``
and counts each implicit host-device sync (``.item()``, ``nonzero``, a copy
to the host) under the innermost span as ``syncs``; explicit
``torch.cuda.synchronize()`` calls are not counted.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import torch

# the text of the warning torch's sync debug mode raises for an implicit
# host-device sync
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the host's ops, and the
    card's kernels when CUDA is available) and write the trace into
    ``log_dir`` as ``<worker>.<time>.pt.trace.json`` (TensorBoard's
    profile plugin or chrome://tracing reads it). Yields the profiler, so
    the caller can also read ``key_averages()``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


# -- the tracer ---------------------------------------------------------------

_NULL = contextlib.nullcontext()
_RECORDER: Optional["Recorder"] = None  # the open tracing block's


@dataclass
class Record:
    """One closed span: ``parent`` is the enclosing span's ``index`` (None
    at the top), ``frame`` the id of the enclosing ``recorder.frame(i)``,
    the host clock in ``perf_counter_ns``, the device's milliseconds
    between the span's CUDA events (None off CUDA), ``counts`` by name
    (``syncs`` among them) and ``caps`` by site: {"live", "cap",
    "dropped"}, summed over the span's calls."""
    index: int
    name: str
    parent: Optional[int]
    frame: Optional[int]
    host_start_ns: int
    host_end_ns: int
    device_ms: Optional[float]
    counts: dict = field(default_factory=dict)
    caps: dict = field(default_factory=dict)


class _Open:
    """A span while it is open: its host clock, events and tallies."""

    def __init__(self, index, name, parent, frame, cuda):
        self.index, self.name, self.parent, self.frame = (index, name,
                                                          parent, frame)
        self.start_ns = time.perf_counter_ns()
        self.end_ns = None
        self.events = None
        if cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.counts: dict = {}
        self.caps: dict = {}

    def close(self):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.perf_counter_ns()


class Recorder:
    """The spans of one :func:`tracing` block."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.closed: list[_Open] = []
        self.stack: list[_Open] = []
        self.frame_id: Optional[int] = None
        self.loose_syncs = 0  # syncs outside every span
        # syncs by "<innermost span> <file>:<line>" of the Python line that
        # ran the syncing op ("-" outside every span)
        self.sync_sites: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self.stack[-1].index if self.stack else None
        s = _Open(len(self.closed) + len(self.stack), name, parent,
                  self.frame_id, self.cuda)
        self.stack.append(s)
        note = (torch.autograd.profiler.record_function(name)
                if torch.autograd._profiler_enabled() else _NULL)
        try:
            with note:
                yield
        finally:
            s.close()
            self.stack.pop()
            self.closed.append(s)

    @contextlib.contextmanager
    def frame(self, i: int):
        """The top-level ``frame`` span of frame ``i``: every span opened
        inside it carries ``i``."""
        outer, self.frame_id = self.frame_id, i
        try:
            with self.span("frame"):
                yield
        finally:
            self.frame_id = outer

    def count(self, name: str, n) -> None:
        if not self.stack:
            return
        c = self.stack[-1].counts
        c[name] = c[name] + n if name in c else n

    def cap(self, live, limit: int, site: str) -> None:
        if not self.stack:
            return
        if isinstance(live, torch.Tensor) and live.dtype == torch.bool:
            live = live.sum()
        dropped = ((live - limit).clamp_min(0)
                   if isinstance(live, torch.Tensor) else max(live - limit, 0))
        c = self.stack[-1].caps
        if site in c:
            old = c[site]
            c[site] = {"live": old["live"] + live, "cap": old["cap"] + limit,
                       "dropped": old["dropped"] + dropped}
        else:
            c[site] = {"live": live, "cap": limit, "dropped": dropped}

    def sync_seen(self, filename: str, lineno: int) -> None:
        if self.stack:
            self.count("syncs", 1)
        else:
            self.loose_syncs += 1
        where = "/".join(filename.replace(os.sep, "/").split("/")[-2:])
        key = f"{self.stack[-1].name if self.stack else '-'} {where}:{lineno}"
        self.sync_sites[key] = self.sync_sites.get(key, 0) + 1

    def records(self) -> list[Record]:
        """The closed spans in the order they opened: one synchronize,
        then every event pair and device tally read at once."""
        if self.cuda:
            torch.cuda.synchronize()
        done = sorted(self.closed, key=lambda s: s.index)
        tensors = [v for s in done for tally in
                   (s.counts, *s.caps.values()) for v in tally.values()
                   if isinstance(v, torch.Tensor)]
        values = iter(torch.stack([t.reshape(()).to(torch.float64)
                                   for t in tensors]).tolist()
                      if tensors else [])

        def plain(v):
            if not isinstance(v, torch.Tensor):
                return v
            x = next(values)
            return int(x) if x.is_integer() else x

        out = []
        for s in done:
            counts = {k: plain(v) for k, v in s.counts.items()}
            caps = {site: {k: plain(v) for k, v in c.items()}
                    for site, c in s.caps.items()}
            ms = (s.events[0].elapsed_time(s.events[1])
                  if s.events is not None else None)
            out.append(Record(s.index, s.name, s.parent, s.frame, s.start_ns,
                              s.end_ns, ms, counts, caps))
        return out


def span(name: str):
    """The block as a span named ``name`` (a null context when off)."""
    if _RECORDER is None:
        return _NULL
    return _RECORDER.span(name)


def spanned(name: str):
    """A decorator: the function runs as the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _RECORDER is None:
                return fn(*args, **kwargs)
            with _RECORDER.span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-d device tensor summed on the device) to
    the innermost open span's count ``name``."""
    if _RECORDER is not None:
        _RECORDER.count(name, n)


def cap(live, limit: int, site: str) -> None:
    """Record a capped site whose overflow loses energy: its live count
    ``live`` (an int, a 0-d device tensor, or a bool mask summed here on
    the device), the cap ``limit`` and ``max(live - limit, 0)`` dropped,
    under the innermost open span as ``site``."""
    if _RECORDER is not None:
        _RECORDER.cap(live, limit, site)


@contextlib.contextmanager
def tracing(device: torch.device | str = "cuda"):
    """Turn the tracer on for the block and yield its :class:`Recorder`
    (``recorder.frame(i)``, ``recorder.records()``). On CUDA the block
    runs under ``torch.cuda.set_sync_debug_mode("warn")`` (the old mode
    comes back at its end) and each implicit sync is counted, not shown;
    other warnings pass on."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a tracing block is already open")
    rec = Recorder(torch.device(device))
    old_mode = torch.cuda.get_sync_debug_mode() if rec.cuda else None
    with warnings.catch_warnings():
        shown = warnings.showwarning

        def seen(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                rec.sync_seen(filename, lineno)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
        warnings.showwarning = seen
        if rec.cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _RECORDER = rec
        try:
            yield rec
        finally:
            _RECORDER = None
            if rec.cuda:
                torch.cuda.set_sync_debug_mode(old_mode)
