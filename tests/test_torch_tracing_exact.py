"""The tracer's ``transmittance`` span (``ops/volume.py``) on the CPU: every
call of the quadrature and ratio-tracking estimators is one span with the
count ``density_samples`` (its rows x steps); in a small reference-exact
frame (``config.reference_exact()`` at tests/test_torch_tracing.py's
sizes, K1's f32 query switched on) the spans sit under ``render.walk`` and
under ``train.batch``; off, the estimators dispatch the ops of the
undecorated functions and the frame the same ops as traced; the traced
and untraced outputs are bit for bit the same."""

import dataclasses

import pytest
import torch

from neuralradiancecaching_tpu_torch import config as cfg_mod
from neuralradiancecaching_tpu_torch.config import VolumeConfig
from neuralradiancecaching_tpu_torch.ops import volume
from neuralradiancecaching_tpu_torch.utils import profiling
from tests.test_torch_tracing import (Ops, assert_bitwise, c4_frames,
                                      check_tree, small)

R = dataclasses.replace
EXACT_TREE = {"train": "frame", "train.batch": "train",
              "train.grads": "train", "train.apply": "train",
              "render": "frame", "bake": "render", "render.walk": "render",
              "render.query": "render", "render.finish": "render"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exact_cfg():
    cfg = small(cfg_mod.reference_exact())
    cfg = R(cfg, path=R(cfg.path, max_bounces=8))
    return R(cfg, mlp=R(cfg.mlp, fused_inference=True))


class Calls:
    """Each call of the two estimators as (rows, steps), taken around the
    traced functions (outside their spans)."""

    def __init__(self, monkeypatch):
        self.seen = []
        for name in ("transmittance", "transmittance_ratio"):
            monkeypatch.setattr(volume, name, self.wrap(getattr(volume,
                                                                name), name))

    def wrap(self, fn, name):
        def call(field, start, end, *a):
            if name == "transmittance":
                rows, steps = start.shape[:-1].numel(), a[0]
            else:
                rows, steps = start.shape[:-1].numel(), a[0].shape[0]
            self.seen.append((rows, steps))
            return fn(field, start, end, *a)
        return call


def samples(records):
    return sum(r.counts.get("density_samples", 0) for r in records
               if r.name == "transmittance")


def test_each_estimator_call_is_a_span_with_its_samples():
    vol = VolumeConfig(grid_shape=(16, 12, 20))
    grid = torch.rand((16, 12, 20), generator=torch.Generator().manual_seed(1))
    table = volume.build_corner_table(grid)
    g = torch.Generator().manual_seed(2)
    a = torch.rand((5, 7, 3), generator=g) * 40.0 - 20.0
    b = torch.rand((5, 7, 3), generator=g) * 40.0 - 20.0
    u = torch.rand((24, 5, 7), generator=g)
    off = (volume.transmittance(table, a, b, 32, vol),
           volume.transmittance_ratio(table, a, b, u, 3.0, vol))
    with profiling.tracing("cpu") as rec:
        with profiling.span("outer"):
            on = (volume.transmittance(table, a, b, 32, vol),
                  volume.transmittance_ratio(table, a, b, u, 3.0, vol))
    records = rec.records()
    spans = [r for r in records if r.name == "transmittance"]
    outer = next(r for r in records if r.name == "outer")
    assert [r.counts for r in spans] == [{"density_samples": 35 * 32},
                                         {"density_samples": 35 * 24}]
    assert all(r.parent == outer.index for r in spans)
    assert all(torch.equal(x, y) for x, y in zip(off, on))


def test_off_the_estimators_dispatch_what_the_undecorated_ones_do():
    vol = VolumeConfig(grid_shape=(4, 3, 5))
    grid = torch.rand((4, 3, 5), generator=torch.Generator().manual_seed(3))
    a, b = torch.zeros((6, 3)), torch.ones((6, 3))
    u = torch.rand((8, 6), generator=torch.Generator().manual_seed(4))
    for fn, args in ((volume.transmittance, (grid, a, b, 16, vol)),
                     (volume.transmittance_ratio, (grid, a, b, u, 2.0, vol))):
        fn(*args)  # the constants' first upload (ops/consts.py)
        with Ops() as plain:
            fn.__wrapped__(*args)
        with Ops() as decorated:
            fn(*args)
        assert [str(o) for o in decorated.ops] == [str(o) for o in plain.ops]


def test_exact_frame_spans_sit_under_the_walk_and_the_train_batch(
        monkeypatch):
    cfg = exact_cfg()
    off = c4_frames(cfg)
    calls = Calls(monkeypatch)
    with profiling.tracing("cpu") as rec:
        with Ops() as traced:
            on = c4_frames(cfg, rec)
    assert_bitwise(off, on)
    records = rec.records()
    framed = [r for r in records if r.frame is not None]
    check_tree(framed, EXACT_TREE, (0, 1))
    by_index = {r.index: r for r in records}
    for i in (0, 1):
        parents = {by_index[r.parent].name for r in framed
                   if r.frame == i and r.name == "transmittance"}
        assert parents == {"render.walk", "train.batch"}, (i, parents)
    # the scene's 8-bit grid builds no field: no span outside the frames
    assert all(r.frame is not None for r in records)
    assert samples(records) == sum(r * s for r, s in calls.seen) > 0
    # off, the same frames dispatch the same ops as traced on the CPU
    with Ops() as untraced:
        c4_frames(cfg)
    assert [str(o) for o in untraced.ops] == [str(o) for o in traced.ops]
