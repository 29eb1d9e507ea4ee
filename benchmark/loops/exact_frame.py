"""The reference application's exact frame (``config.reference_exact()``):
``frame_step``'s loop -- each frame one ``render.frame.frame_step`` that
trains then renders at a static camera -- with the program's own
transmittance span handed to the harness in a traced run.

Traffic parameters: ``train`` (every frame trains). Untraced, a frame
launches what :mod:`benchmark.loops.frame_step` launches. Traced (``spans``
given), each frame also runs under the program's tracer
(``utils/profiling.tracing``), and its ``transmittance`` spans -- every
call of the quadrature and ratio-tracking estimators of ``ops/volume.py``
-- are summed: their milliseconds go into the harness's spans under
``transmittance`` (the span's CUDA events; off the card its host clock),
their ``density_samples`` count into :meth:`Loop.work`. The tracer's
records cost one synchronize a traced frame. A program without the tracer
or without the span (the control, an older port) hands nothing over, and
the readers of ``transmittance_ms`` and ``march_gsamples_s`` find nothing.
"""

from __future__ import annotations

import contextlib

from benchmark import harness
from benchmark.loops import frame_step
from benchmark.program_trace import tracer

SPAN, COUNT = "transmittance", "density_samples"
# frames under the profiler in a traced run, which the harness looks up by
# the loop's name: an exact frame holds ~10x the launches of config 4's,
# so 2 of them trace more kernels than config 4's 4
harness.PROFILE_FRAMES.setdefault("exact_frame", 2)


class Loop(frame_step.Loop):
    def __init__(self, run):
        super().__init__(run)
        self.samples = []   # density samples of each traced frame

    def frame(self, i: int, spans) -> None:
        prof = tracer(self.run) if spans is not None else None
        if prof is None:    # untraced, or a program without the tracer
            super().frame(i, spans)
            return
        with contextlib.ExitStack() as stack:
            try:
                rec = stack.enter_context(prof.tracing(self.run.device))
            except RuntimeError:
                # another tracing block is open: the program window of
                # benchmark/program_trace.py records the frame itself
                super().frame(i, spans)
                return
            with rec.frame(i):
                super().frame(i, spans)
            records = [x for x in rec.records() if x.name == SPAN]
        if records:
            spans.add_ms(SPAN, sum(
                x.device_ms if x.device_ms is not None
                else (x.host_end_ns - x.host_start_ns) * 1e-6
                for x in records))
            self.samples.append(sum(x.counts.get(COUNT, 0)
                                    for x in records))

    def work(self) -> dict:
        return {**super().work(), COUNT: list(self.samples)}
