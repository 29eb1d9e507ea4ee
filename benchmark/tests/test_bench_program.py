"""The readers of the program's own spans (``Reading.program``) on
synthetic records, the idle gaps' split by span, and a traced harness run
with the program window of two cells on the CPU at the tests' cut."""

from types import SimpleNamespace

import pytest

from benchmark import program_trace
from benchmark.spec import metric_reader
from benchmark.tests.conftest import SMALL
from neuralradiancecaching_tpu_torch.utils.profiling import Record

NEW = program_trace.METRICS


def rec(index, name, parent, frame, ms, counts=None, caps=None):
    return Record(index, name, parent, frame, index, index + 1, ms,
                  counts or {}, caps or {})


def two_frames():
    """Frame 0 trains and renders, frame 1 renders; a 0.5 ms bake outside
    the frames is left out."""
    caps = {"live_pack": {"live": 90, "cap": 80, "dropped": 10}}
    return [
        rec(0, "bake", None, None, 0.5),
        rec(1, "frame", None, 0, 30.0, {"syncs": 4}),
        rec(2, "train", 1, 0, 20.0),
        rec(3, "train.batch", 2, 0, 12.0, {"syncs": 1}),
        rec(4, "train.grads", 2, 0, 5.0),
        rec(5, "train.apply", 2, 0, 2.0),
        rec(6, "render", 1, 0, 9.0),
        rec(7, "render.walk", 6, 0, 4.0),
        rec(8, "render.shade", 6, 0, 2.0,
            caps={"deferred_shade": {"live": 100, "cap": 200,
                                     "dropped": 0}}),
        rec(9, "render.query", 6, 0, 2.0),
        rec(10, "k1", 9, 0, 1.0, {"rows": 460800}),
        rec(11, "render.finish", 6, 0, 0.5),
        rec(12, "frame", None, 1, 10.0),
        rec(13, "render", 12, 1, 8.0),
        rec(14, "render.walk", 13, 1, 6.0, {"syncs": 2}, caps),
        rec(15, "render.query", 13, 1, 1.0),
        rec(16, "render.finish", 13, 1, 0.5),
    ]


@pytest.mark.parametrize("name,value", [
    ("walk_ms", (4.0 + 6.0) / 2), ("shade_ms", 2.0 / 2),
    ("query_ms", (2.0 + 1.0) / 2), ("finish_ms", 0.5),
    ("batch_ms", 12.0), ("grads_ms", 5.0), ("apply_ms", 2.0),
    ("syncs_per_frame", 3 / 2), ("cap_drop_pct", 100.0 * 10 / 190)])
def test_the_readers_by_hand(name, value):
    assert metric_reader(name)(SimpleNamespace(program=two_frames())) \
        == pytest.approx(value)


@pytest.mark.parametrize("name", NEW)
def test_the_readers_read_nothing_from_nothing(name):
    read = metric_reader(name)
    assert read(SimpleNamespace()) is None            # the harness's Reading
    assert read(SimpleNamespace(program=[])) is None
    off_card = [rec(0, "frame", None, 0, None),
                rec(1, "render", 0, 0, None),
                rec(2, "render.walk", 1, 0, None)]
    got = read(SimpleNamespace(program=off_card))
    assert got == (0.0 if name == "syncs_per_frame" else None)


def test_training_metrics_read_nothing_without_a_training_frame():
    plain = [r for r in two_frames() if r.frame != 0]
    for name in ("batch_ms", "grads_ms", "apply_ms"):
        assert metric_reader(name)(SimpleNamespace(program=plain)) is None
    assert metric_reader("walk_ms")(SimpleNamespace(program=plain)) == 6.0


def test_idle_gaps_split_by_the_innermost_span():
    notes = [(0.0, 10.0, "frame"), (1.0, 6.0, "render"),
             (2.0, 4.0, "render.walk"), (2.0, 3.0, "k1")]
    gaps = [(0.5, 1.5), (2.5, 3.5), (5.0, 7.0), (11.0, 12.0)]
    out = program_trace.split_gaps(gaps, notes)
    assert out == pytest.approx({"frame": 0.5 + 1.0, "render": 0.5 + 1.0,
                                 "k1": 0.5, "render.walk": 0.5,
                                 "outside": 1.0})


@pytest.mark.parametrize("cell", ["c5_view_static", "c4_online_800"])
def test_the_program_window_on_the_cpu(cell):
    out = program_trace.trace_cell(cell, 2**31 + 11, 1e9, "cpu",
                                   overrides=SMALL, max_frames=4)
    m = out["metrics"]
    # the counters read on the CPU; the spans' device ms do not
    assert m["syncs_per_frame"] == 0.0
    assert m["cap_drop_pct"] is not None and 0.0 <= m["cap_drop_pct"] < 100
    assert all(m[k] is None for k in NEW[:7])
    spans = out["spans"]
    assert {"frame", "train", "train.batch", "train.grads", "train.apply",
            "render", "render.walk", "render.query",
            "render.finish"} <= set(spans)
    assert ("render.shade" in spans) == (cell != "c4_online_800")
    assert out["idle_ms"] == {} and out["on_cost"] > 0
    assert set(out["harness_spans"]) >= {"train", "render"}
    assert set(out["window_spans"]) == set(out["harness_spans"])
    # the harness's own traced run around it: its readers as they were
    got = out["result"]["metrics"]
    assert {"train_ms", "render_ms"} <= set(got)
    assert not set(got) & set(NEW)
    assert list(out["result"])[-1] == "checks"
