"""The cells ``reference_exact_800`` (``config.reference_exact()`` through
the loop ``exact_frame``) and ``c4_serve_800`` (config 4 with training
paused): whole runs on the CPU at the tests' cut, sound and with the
timed path broken underneath; the readers of the transmittance span by
hand; the loop's hand-over of the span in a traced run, and nothing
handed over by the control or inside the program window. On the card, at
the cells' own size, the program is correct and the control is not:

    python3 -m pytest -q benchmark/tests/test_bench_exact.py -m card
"""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.spec import metric_reader
from benchmark.tests.conftest import SMALL
from benchmark.tests.test_bench_faults import (_altered, _bias_only,
                                               _unchanged)
from neuralradiancecaching_tpu_torch.ops import optimizers, volume
from neuralradiancecaching_tpu_torch.render import frame

SPANS = {"reference_exact_800": 4, "c4_serve_800": 8}
NEW = ("transmittance_ms", "march_gsamples_s")


def half_quadrature(monkeypatch):
    """A broken quadrature: every transmittance at half its steps."""
    orig = volume.transmittance

    def half(field, start, end, steps, cfg):
        return orig(field, start, end, max(1, steps // 2), cfg)
    monkeypatch.setattr(volume, "transmittance", half)


def no_momentum(monkeypatch):
    """A broken optimizer: the MLP's step without its momentum."""
    orig = optimizers.momentum_sgd_step

    def step(params, momentum, grads, cfg):
        zero = {k: torch.zeros_like(v) for k, v in momentum.items()}
        return orig(params, zero, grads, cfg)
    monkeypatch.setattr(optimizers, "momentum_sgd_step", step)


FAULTS = {
    "reference_exact_800": {"half_quadrature": half_quadrature,
                            "momentum_dropped": no_momentum,
                            "state_unchanged": _unchanged,
                            "query_bias_only": _bias_only},
    "c4_serve_800": {"image_altered": _altered(frame, "render_only_step"),
                     "query_bias_only": _bias_only},
}
CASES = [(c, None) for c in FAULTS] + [(c, f) for c in FAULTS
                                       for f in FAULTS[c]]


def _run(cell, trace=False, **kw):
    span = SPANS[cell]
    return harness.run_cell(cell, 2**31 + 20202, 1e9, trace, "cpu",
                            overrides=SMALL, max_frames=span,
                            check_span=span, **kw)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    if fault is not None:
        FAULTS[cell][fault](monkeypatch)
    r = _run(cell)
    assert r["attempted"] == SPANS[cell]
    assert r["correct"] is (fault is None), r["checks"]
    if fault is None:
        assert r["failed"] == 0
        assert set(r["metrics"]) == {"frame_ms", "frame_ms_p90", "setup_s"}


def test_the_readers_by_hand():
    r = SimpleNamespace(spans={"transmittance": [10.0, 30.0],
                               "train": [5.0]},
                        work={"density_samples": [1e9, 3e9]})
    assert metric_reader("transmittance_ms")(r) == pytest.approx(20.0)
    # 4e9 samples in 40 ms
    assert metric_reader("march_gsamples_s")(r) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NEW)
def test_the_readers_read_nothing_without_the_span(name):
    read = metric_reader(name)
    plain = {"k1_rows": 640000, "k1_row_bytes": 256, "train_rows": 10000}
    assert read(SimpleNamespace(spans={}, work=plain)) is None
    assert read(SimpleNamespace(spans={"render": [1.0]}, work=plain)) is None
    if name == "march_gsamples_s":
        # spans without their counts (or the other way round)
        assert read(SimpleNamespace(spans={"transmittance": [1.0]},
                                    work=plain)) is None
        assert read(SimpleNamespace(spans={}, work={
            **plain, "density_samples": [5]})) is None


def test_a_traced_run_hands_the_span_over():
    r = _run("reference_exact_800", trace=True)
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    # off the card the span's host clock stands in for its CUDA events
    assert m["transmittance_ms"] > 0.0 and m["march_gsamples_s"] > 0.0
    assert m["transmittance_ms"] <= m["train_ms"] + m["render_ms"]
    serve = _run("c4_serve_800", trace=True)
    assert serve["correct"] is True and not set(NEW) & set(serve["metrics"])


def test_the_control_hands_nothing_over():
    r = _run("reference_exact_800", trace=True, control=True)
    assert not set(NEW) & set(r["metrics"])
    assert {"train_ms", "render_ms"} <= set(r["metrics"])


def test_inside_the_program_window_the_loop_runs_plainly():
    out = program_trace.trace_cell("reference_exact_800", 2**31 + 11, 1e9,
                                   "cpu", overrides=SMALL, max_frames=4)
    assert "transmittance" in out["spans"]
    assert out["spans"]["transmittance"][2] > 0  # calls a frame
    got = out["result"]["metrics"]
    assert set(NEW) <= set(got)
    assert list(out["result"])[-1] == "checks"


def _card_run(cell, device, **kw):
    return harness.run_cell(cell, 2**31 + 7, 1e9, False, device,
                            to_last_checked=True, **kw)


@pytest.mark.card
@pytest.mark.parametrize("cell", list(SPANS))
def test_the_program_is_correct_and_the_control_is_not(cell, card):
    assert _card_run(cell, card)["correct"] is True
    control = _card_run(cell, card, control=True)
    assert control["correct"] is False, control["checks"]
