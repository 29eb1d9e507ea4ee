"""Profiling and timing helpers.

Counterpart of ``neuralradiancecaching_tpu/utils/profiling.py``: the
reference's FPS title bar and frame-dt Time class (SURVEY.md §5) become a
``torch.profiler`` trace and named phase timers that synchronize the
device before they read the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from neuralradiancecaching_tpu_torch.utils.debug import leaves_with_path


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


def _sync(tree) -> None:
    """Wait for the current stream of the device that the first tensor of
    ``tree`` lives on (nothing to wait for on the CPU)."""
    for _, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.current_stream(leaf.device).synchronize()
            return


class PhaseTimer:
    """Accumulating wall-clock timers keyed by phase name. A phase given
    ``sync_on`` (a tensor or a nested state) synchronizes that tensor's
    device at its end, so asynchronous launches do not hide the cost."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {t / c * 1000:.1f} ms/call"
                         f" x{c}")
        return "\n".join(lines)


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6  # Mrays/s
