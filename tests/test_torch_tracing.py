"""The port's tracer (``utils/profiling.py``) on the CPU: off it dispatches
nothing; on it gives config 5's progressive frame and config 4's online
frame their span trees, leaves every output bit for bit as it was,
records what a deliberately low cap drops, counts implicit syncs under the
innermost span and annotates a ``torch.profiler`` trace.

Sizes are the render tests' (tests/test_torch_tiled.py): a 32x30 frame
over a 16x12x20 cloud, a 16x16 train grid of 16-slot target walks."""

import dataclasses
import warnings

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neuralradiancecaching_tpu_torch import config as cfg_mod
from neuralradiancecaching_tpu_torch.io import assets
from neuralradiancecaching_tpu_torch.models import nrc
from neuralradiancecaching_tpu_torch.render import frame, tiled
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from neuralradiancecaching_tpu_torch.utils import profiling

R = dataclasses.replace
W, H, BAND = 32, 30, 10

# the span tree of each frame: child -> parent
C5_TREE = {"train": "frame", "train.batch": "train", "train.grads": "train",
           "train.apply": "train", "bake": "frame", "render": "frame",
           "render.walk": "render", "render.shade": "render",
           "render.query": "render", "render.finish": "render"}
C4_TREE = {"train": "frame", "train.batch": "train", "train.grads": "train",
           "train.apply": "train", "render": "frame", "bake": "render",
           "render.walk": "render", "render.query": "render",
           "render.finish": "render"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(cfg, w=W, h=H, **render):
    """A preset cut to the tests' size (a w x h frame)."""
    return R(cfg, camera=R(cfg.camera, aspect=w / h),
             render=R(cfg.render, width=w, height=h, **render),
             path=R(cfg.path, collision_field_steps=8),
             volume=R(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8), field_dir_buckets=(8, 16)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)),
             train=R(cfg.train, train_width=16, train_height=16,
                     target_bounces=16))


def c5_cfg(shade_cap_fraction=8.0, w=W, h=H):
    """Config 5 with bench.py's production settings (bf16 fields and
    query, live-tau 0.005, slot-0-dense shade, the live-ray pack)."""
    cfg = cfg_mod.progressive_1080p_config()
    cfg = small(cfg, w, h, live_tau_threshold=0.005, shade_slot0_dense=True,
                live_pack_fraction=1.0, query_cap_fraction=1.0,
                shade_cap_fraction=shade_cap_fraction)
    return R(cfg, mlp=R(cfg.mlp, fused_inference=True,
                        inference_dtype="bfloat16"))


def c4_cfg():
    """Config 4 as it ships, with K1's f32 query switched on."""
    cfg = small(cfg_mod.nrc_online_config())
    return R(cfg, mlp=R(cfg.mlp, fused_inference=True))


def scene_state(cfg):
    dens = assets.synthesize_cloud(cfg.volume.grid_shape, seed=3)
    scene = tscene.make_scene(cfg, torch.tensor(dens),
                              torch.tensor(assets.synthesize_sky(32, 64)),
                              device="cpu")
    state = nrc.init_state(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    return scene, state


def c5_frames(cfg, rec=None, frames=(0, 1)):
    """Config 5's progressive frames: the hoists, then per frame a train
    step, the bake and render_banded (frame 0) or render_banded alone;
    under ``rec.frame(i)`` when a recorder is given. Returns the hoists,
    every state, bake and image."""
    scene, state = scene_state(cfg)
    env = tiled.frame_env_color(scene, cfg)
    pack = tiled.frame_live_pack(scene, cfg, BAND)
    baked = nrc.bake(state, cfg)
    out = {"env": env, "pack": list(pack)}
    for i in frames:
        gen = torch.Generator().manual_seed(100 + i)
        with rec.frame(i) if rec else profiling.span("frame"):
            if i % 2 == 0:
                state, mse = frame.train_only_step(state, scene, gen, cfg)
                baked = nrc.bake(state, cfg)
                out[f"mse{i}"] = mse
            out[f"image{i}"] = tiled.render_banded(
                state, scene, gen, cfg, band_rows=BAND, env_rgb=env,
                baked=baked, pack=pack)
        out[f"baked{i}"] = baked
        out[f"state{i}"] = dataclasses.asdict(state)
    return out


def c4_frames(cfg, rec=None, frames=(0, 1)):
    """Config 4's online frames through ``frame_step``."""
    scene, state = scene_state(cfg)
    out = {}
    for i in frames:
        gen = torch.Generator().manual_seed(200 + i)
        with rec.frame(i) if rec else profiling.span("frame"):
            state, res = frame.frame_step(state, scene, gen, cfg)
        out[f"image{i}"], out[f"mse{i}"] = res.image, res.mse
        out[f"state{i}"] = dataclasses.asdict(state)
    return out


def flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_bitwise(a, b):
    fa, fb = dict(flat(a)), dict(flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(bits(x), bits(y)), k


def bits(x):
    x = x.reshape(-1)
    return x.view(torch.uint8) if x.dtype.is_floating_point else x


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


# -- off ----------------------------------------------------------------------

def test_off_the_tracer_returns_one_null_context_and_dispatches_nothing():
    mask = torch.tensor([True, False, True])
    live = torch.tensor(7)

    @profiling.spanned("decorated")
    def f(x):
        return x

    with Ops() as seen:
        a, b = profiling.span("render"), profiling.span("render.walk")
        with a:
            with b:
                profiling.count("rows", live)
                profiling.cap(mask, 1, "site")
                profiling.cap(live, 5, "site")
        assert f(3) == 3
    assert a is b is profiling._NULL
    assert seen.ops == []


def test_tracing_blocks_do_not_nest_and_turn_off_at_their_end():
    with profiling.tracing("cpu"):
        with pytest.raises(RuntimeError):
            with profiling.tracing("cpu"):
                pass
        assert profiling.span("x") is not profiling._NULL
    assert profiling.span("x") is profiling._NULL


# -- on ---------------------------------------------------------------------

def test_counts_caps_and_syncs_land_in_the_innermost_span():
    with profiling.tracing("cpu") as rec:
        with rec.frame(7):
            with profiling.span("outer"):
                profiling.count("rows", 3)
                profiling.count("rows", torch.tensor(4))
                with profiling.span("inner"):
                    profiling.cap(torch.tensor([True] * 5 + [False]), 3,
                                  "pack")
                    profiling.cap(torch.tensor(2), 3, "pack")
                    profiling.cap(9, 10, "events")
                    warnings.warn(profiling.SYNC_WARNING)
                    warnings.warn(profiling.SYNC_WARNING)
                with pytest.warns(UserWarning, match="another warning"):
                    warnings.warn("another warning")
        warnings.warn(profiling.SYNC_WARNING)
        profiling.count("rows", 1)  # outside every span: dropped
    recs = {r.name: r for r in rec.records()}
    assert list(recs) == ["frame", "outer", "inner"]
    assert all(r.frame == 7 and r.device_ms is None for r in recs.values())
    assert recs["outer"].counts == {"rows": 7}
    assert recs["inner"].counts == {"syncs": 2}
    assert recs["inner"].caps == {
        "pack": {"live": 7, "cap": 6, "dropped": 2},
        "events": {"live": 9, "cap": 10, "dropped": 0}}
    assert recs["frame"].counts == {} and rec.loose_syncs == 1
    by_span = {}
    for k, v in rec.sync_sites.items():
        where = k.split(":")[0]
        by_span[where] = by_span.get(where, 0) + v
    assert by_span == {"inner tests/test_torch_tracing.py": 2,
                       "- tests/test_torch_tracing.py": 1}
    assert len(rec.sync_sites) == 3  # a site a line
    assert recs["inner"].parent == recs["outer"].index
    assert recs["outer"].parent == recs["frame"].index


def check_tree(records, tree, frames):
    by_index = {r.index: r for r in records}
    for r in records:
        assert r.frame in frames
        assert r.host_start_ns <= r.host_end_ns
        if r.name == "frame":
            assert r.parent is None
            continue
        p = by_index[r.parent]
        if r.name in tree:
            assert p.name == tree[r.name], r.name
        assert p.frame == r.frame
        assert p.host_start_ns <= r.host_start_ns <= r.host_end_ns \
            <= p.host_end_ns, r.name
    for i in frames:
        names = {r.name for r in records if r.frame == i}
        assert names >= ({"frame"} | set(tree) if i == frames[0]
                         else {"frame", "render", "render.walk",
                               "render.query", "render.finish"}), (i, names)


def test_config5_progressive_frame_span_tree_and_bits():
    cfg = c5_cfg()
    off = c5_frames(cfg)
    with profiling.tracing("cpu") as rec:
        on = c5_frames(cfg, rec)
    records = rec.records()
    framed = [r for r in records if r.frame is not None]
    check_tree(framed, C5_TREE, (0, 1))
    # the hoists and the first bake ran outside any frame (and the
    # quadrature of the scene's field bake and of the pack's entry tau,
    # each call its own ``transmittance`` span)
    top = [r.name for r in records
           if r.frame is None and r.name != "transmittance"]
    assert top == ["hoist.env", "hoist.pack", "bake"]
    assert not any(r.frame == 1 and r.name.startswith("train")
                   for r in records)
    assert_bitwise(off, on)


def test_config4_online_frame_span_tree_and_bits():
    cfg = c4_cfg()
    off = c4_frames(cfg)
    with profiling.tracing("cpu") as rec:
        on = c4_frames(cfg, rec)
    records = rec.records()
    # only the scene's field bake ran outside any frame: its quadrature,
    # each call its own top-level ``transmittance`` span
    outside = [r for r in records if r.frame is None]
    assert {r.name for r in outside} == {"transmittance"}
    assert all(r.parent is None for r in outside)
    records = [r for r in records if r.frame is not None]
    check_tree(records, C4_TREE, (0, 1))
    for i in (0, 1):
        names = {r.name for r in records if r.frame == i}
        assert names >= set(C4_TREE) and "render.shade" not in names
    assert_bitwise(off, on)


def drops(records, span):
    return {site: c["dropped"] for r in records if r.name == span
            for site, c in r.caps.items()}


def test_a_low_shade_cap_reports_its_drops():
    """At 96x90 the frame's tail events outnumber the cap's floor of 1024
    rows, so a cap fraction of 0.05 drops some."""
    recs = {}
    for frac in (8.0, 0.05):
        with profiling.tracing("cpu") as rec:
            c5_frames(c5_cfg(frac, 96, 90), rec, frames=(1,))
        recs[frac] = rec.records()
    assert drops(recs[8.0], "render.shade") == {"deferred_shade": 0}
    low = drops(recs[0.05], "render.shade")
    assert low["deferred_shade"] > 0
    shade = next(r for r in recs[0.05] if r.name == "render.shade")
    c = shade.caps["deferred_shade"]
    assert c["dropped"] == c["live"] - c["cap"] and c["cap"] == 1024
    pack = next(r for r in recs[8.0] if r.name == "hoist.pack")
    assert pack.caps["live_pack"]["dropped"] == 0
    assert pack.caps["live_pack"]["live"] > 0


def test_spans_annotate_the_profiler_trace_around_their_ops():
    from torch.profiler import ProfilerActivity, profile
    cfg = c5_cfg()
    scene, state = scene_state(cfg)
    with profiling.tracing("cpu"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("outer"):
                torch.ones(16, 16) @ torch.ones(16, 16)
            nrc.bake(state, cfg)
    events = prof.profiler.kineto_results.events()

    def interval(e):
        return e.start_ns(), e.start_ns() + e.duration_ns()

    notes = {e.name(): interval(e) for e in events
             if e.name() in ("outer", "bake")}
    assert set(notes) == {"outer", "bake"}
    mm = [interval(e) for e in events if e.name() == "aten::mm"]
    s, t = notes["outer"]
    assert mm and all(s <= a and b <= t for a, b in mm)
    s, t = notes["bake"]
    inside = [e.name() for e in events if e.name().startswith("aten::")
              and s <= interval(e)[0] and interval(e)[1] <= t]
    assert inside
