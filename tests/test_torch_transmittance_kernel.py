"""The quadrature transmittance kernel (``csrc/transmittance.cu``) against
the plain path it replaces on the card (``volume.transmittance_plain``).

On the card (marker ``card``; each test skips without CUDA): the kernel's
density samples are bit for bit ``density_at`` at the plain path's points,
and the transmittance it gives is bit for bit the plain path on the same
CUDA tensors at every step count the port uses (16 and 32 in the walks
and shades, 48 and 128 in the field bakes, 64 for the entry tau) and at
step counts that are no multiple of 4, over segments inside, across and
wholly outside the box and of zero length, at ragged and at large row
counts and on the full 125x85x153 stand-in table; the finish kernel
against the plain path's last operations; the probe of
``torch.sum``'s order over the 8 corners that the kernel reproduces; its
counts; what it refuses. On the CPU: the dispatcher keeps the plain path
and counts no kernel sample, the plain path at any step count, what the
wrapper refuses before it looks at the device.

The card tests run on the card with

    python3 -m pytest -q --noconftest -m card \
        tests/test_torch_transmittance_kernel.py

(this file imports no JAX; the suite's conftest does)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralradiancecaching_tpu_torch import config as cfg_mod
from neuralradiancecaching_tpu_torch import kernels
from neuralradiancecaching_tpu_torch.io import assets
from neuralradiancecaching_tpu_torch.ops import volume
from neuralradiancecaching_tpu_torch.utils import profiling

VOL = cfg_mod.reference_exact().volume  # the 125x85x153 grid, factor 0.4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def stand_in():
    """The synthesized 125x85x153 stand-in cloud, 8-bit as reference_exact
    stores it."""
    return volume.quantize_8bit(torch.as_tensor(assets.synthesize_cloud()))


def small_table(shape=(6, 5, 7), seed=0):
    grid = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return volume.build_corner_table(torch.as_tensor(grid))


def segments(n: int, vol, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """n segments, a fifth of each kind: both ends anywhere in 1.5 times the
    box (most cross its border), box entry to exit along a ray (the entry
    tau's), a point inside to the box exit (the shade's sky rays), wholly
    outside the box, and of zero length."""
    g = torch.Generator().manual_seed(seed)
    size = torch.tensor(vol.box_size)
    center = torch.tensor(vol.box_center)

    def anywhere(k, scale):
        return (torch.rand((k, 3), generator=g) - 0.5) * size * scale + center

    def dirs(k):
        d = torch.randn((k, 3), generator=g)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    k = -(-n // 5)
    a1, b1 = anywhere(k, 1.5), anywhere(k, 1.5)
    ro = anywhere(k, 4.0)
    rd = F.normalize(anywhere(k, 0.5) - ro, dim=-1)
    a2, b2, _ = volume.entry_exit_points(ro, rd, vol.box_size, vol.box_center)
    a3 = anywhere(k, 0.9)
    _, b3, _ = volume.entry_exit_points(a3, dirs(k), vol.box_size,
                                        vol.box_center)
    off = center + size * 2.0
    a4, b4 = anywhere(k, 0.5) + off, anywhere(k, 0.5) + off
    a5 = anywhere(k, 1.2)
    start = torch.cat([a1, a2, a3, a4, a5])[:n]
    end = torch.cat([b1, b2, b3, b4, a5.clone()])[:n]
    return start, end


def corner_fold(x: np.ndarray) -> np.ndarray:
    """``torch.sum(x, -1)`` over 8 values as the card's reduce kernel
    orders it: 8 lanes folded in halves (the order of the kernel's corner
    sum), in float32."""
    v = [x[:, i] for i in range(8)]
    while len(v) > 1:
        h = len(v) // 2
        v = [(v[i] + v[i + h]).astype(np.float32) for i in range(h)]
    return v[0]


# -- on the CPU ---------------------------------------------------------------

def test_cpu_takes_the_plain_path():
    """CPU tensors take the plain path, bit for bit, with no launch and no
    kernel samples counted; the span still counts its density samples."""
    table = small_table()
    vol = cfg_mod.VolumeConfig(grid_shape=(6, 5, 7), box_size=(3.0, 2.5, 3.5))
    start, end = segments(101, vol)
    launches = volume.LAUNCHES
    with profiling.tracing("cpu") as rec:
        got = volume.transmittance(table, start, end, 16, vol)
    assert torch.equal(got, volume.transmittance_plain(table, start, end, 16,
                                                       vol))
    assert volume.LAUNCHES == launches
    (span,) = [r for r in rec.records() if r.name == "transmittance"]
    assert span.counts["density_samples"] == 101 * 16
    assert span.counts.get("density_samples_kernel", 0) == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    table = small_table()
    vol = cfg_mod.VolumeConfig(grid_shape=(6, 5, 7))
    start, end = segments(10, vol)
    with pytest.raises(ValueError, match="CUDA"):
        volume.transmittance_kernel(table, start, end, 16, vol)


@pytest.mark.parametrize("what, match", [
    ("float64 start", "float32"), ("float64 table", "float32"),
    ("non-contiguous table", "contiguous"), ("another grid", "grid_shape"),
    ("start and end differ in shape", "one shape"), ("no steps", "steps"),
])
def test_kernel_wrapper_checks_its_inputs_before_the_device(what, match):
    """What the kernel does not take is refused by name, on any device."""
    table = small_table()
    vol = cfg_mod.VolumeConfig(grid_shape=(6, 5, 7))
    start, end = segments(100, vol)
    t, s, e, steps = {
        "float64 start": (table, start.double(), end.double(), 16),
        "float64 table": (table.double(), start, end, 16),
        "non-contiguous table": (table.t().contiguous().t(), start, end, 16),
        "another grid": (small_table((5, 5, 7)), start, end, 16),
        "start and end differ in shape": (table, start, end[:50], 16),
        "no steps": (table, start, end, 0),
    }[what]
    with pytest.raises(ValueError, match=match):
        volume.transmittance_kernel(t, s, e, steps, vol)


@pytest.mark.parametrize("steps", [1, 3, 16, 32, 48, 64, 128, 130, 150])
def test_plain_path_takes_any_step_count(steps):
    """The plain path (the CPU's, and the kernel's reference on the card)
    at any step count: within float32 rounding of the same quadrature in
    float64, exactly 1 on zero-length segments and on segments wholly
    outside the box."""
    table = small_table()
    vol = cfg_mod.VolumeConfig(grid_shape=(6, 5, 7), box_size=(3.0, 2.5, 3.5))
    start, end = segments(500, vol, seed=steps)
    got = volume.transmittance(table, start, end, steps, vol)
    want = volume.transmittance_plain(table.double(), start.double(),
                                      end.double(), steps, vol)
    assert got.dtype == torch.float32 and got.shape == (500,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-6)
    assert bool((got[300:] == 1.0).all())  # wholly outside, zero length
    assert float(got[:300].min()) < 1.0


def test_kernels_lists_every_cuda_source():
    assert set(kernels.CUDA_KERNELS) == {
        p.stem for p in kernels.CSRC_DIR.glob("*.cu")}
    assert "transmittance" in kernels.CUDA_KERNELS


# -- on the card --------------------------------------------------------------

@pytest.mark.card
def test_torch_sum_order_probe(card):
    """The probe: inputs whose sum differs by order (values over 24
    binades), summed over 8 by torch.sum on the card, equal the kernel's
    corner fold at every row count."""
    rng = np.random.default_rng(8)
    for m in (1, 3, 15, 16, 1000, 100_003):
        x = np.abs(rng.standard_normal((m, 8)) * 2.0 ** rng.integers(
            -12, 12, (m, 8))).astype(np.float32)
        got = torch.sum(torch.from_numpy(x).to(card), dim=-1).cpu().numpy()
        want = corner_fold(x)
        assert np.array_equal(got, want), (m, int((got != want).sum()))
    # the inputs tell orders apart: a running sum differs on most rows
    assert not np.array_equal(want, np.cumsum(x, axis=-1,
                                              dtype=np.float32)[:, -1])


@pytest.mark.card
@pytest.mark.parametrize("n", [16, 24, 48, 130])
def test_division_by_steps_is_a_reciprocal_multiply(card, n):
    """``arange(n) / n`` on the card multiplies by the float reciprocal,
    which the kernel's fractions reproduce (they differ from a true
    division below at 24 and 48)."""
    a = torch.arange(n, dtype=torch.float32, device=card) / n
    recip = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(n))
    assert np.array_equal(a.cpu().numpy(), recip)


@pytest.mark.card
@pytest.mark.parametrize("steps", [16, 32, 48, 64, 128, 130, 150])
@pytest.mark.parametrize("rows", [1, 5, 15, 100_003])
def test_kernel_equals_plain_on_the_stand_in_table(card, stand_in, steps,
                                                   rows):
    """Bit for bit the plain path on the full stand-in table, every kind of
    segment, at the step counts of the port and at 130 and 150 (no whole
    number of torch.sum's vectors of 4), at row counts that change
    torch.sum's layout or are no multiple of the block."""
    table = volume.build_corner_table(stand_in.to(card))
    start, end = (t.to(card) for t in segments(rows, VOL, seed=steps))
    launches = volume.LAUNCHES
    got = volume.transmittance(table, start, end, steps, VOL)
    assert volume.LAUNCHES == launches + 2
    want = volume.transmittance_plain(table, start, end, steps, VOL)
    assert got.shape == want.shape and torch.equal(got, want)
    if rows > 1000:  # the cloud absorbs, zero-length segments give 1
        assert float(got.min()) < 1.0 and float(got.max()) == 1.0


@pytest.mark.card
@pytest.mark.parametrize("steps", [16, 130])
def test_densities_equal_density_at(card, stand_in, steps):
    """The kernel's (..., steps) samples are ``density_at`` at the plain
    path's points, bit for bit, in its shape."""
    table = volume.build_corner_table(stand_in.to(card))
    start, end = (t.to(card).reshape(7, 1429, 3)
                  for t in segments(7 * 1429, VOL, seed=steps))
    seg = end - start
    fracs = torch.arange(steps, dtype=torch.float32, device=card) / steps
    pts = start[..., None, :] + fracs[:, None] * seg[..., None, :]
    want = volume.density_at(table, pts, VOL)
    got = volume.quadrature_densities(table, start, seg, steps, VOL)
    assert got.shape == (7, 1429, steps) and got.is_contiguous()
    assert torch.equal(got, want)
    assert float(got.max()) > 0.0


@pytest.mark.card
def test_finish_equals_the_plain_ops(card):
    """The finish kernel is the plain path's product, exp and zero-length
    test, bit for bit, over sums and lengths of every kind: zero, -0, NaN,
    inf, and optical depths from 1e-30 to past exp's underflow."""
    g = torch.Generator().manual_seed(5)
    n = 100_003
    total = torch.rand(n, generator=g) * 10.0 ** torch.randint(
        -30, 4, (n,), generator=g).float()
    length = torch.rand(n, generator=g) * 10.0 ** torch.randint(
        -6, 3, (n,), generator=g).float()
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf")])
    total[:16], length[:16] = special.repeat(4), special.repeat_interleave(4)
    total, length = total.to(card), length.to(card)
    step_size = length / 32
    got = volume._quadrature_finish(total, step_size, length)
    want = torch.where(length > 0.0, torch.exp(-(step_size * total)), 1.0)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    rest = want[16:]  # the range reaches exp's underflow and its middle
    assert bool((rest == 0.0).any()) and bool(((rest > 0.0) & (rest < 0.5)
                                               ).any())


@pytest.mark.card
def test_kernel_equals_plain_at_a_million_rows(card, stand_in):
    """Over a million rows (no multiple of the block), in one dimension and
    in two, on the 8-bit and the unquantized cloud at config 5's volume."""
    vol = cfg_mod.progressive_1080p_config().volume
    start, end = (t.to(card) for t in segments(89 * 11_783, vol, seed=1))
    for grid in (stand_in, torch.as_tensor(assets.synthesize_cloud())):
        table = volume.build_corner_table(grid.to(card))
        for steps, shape in ((16, (89 * 11_783,)), (32, (89, 11_783))):
            s, e = start.reshape(*shape, 3), end.reshape(*shape, 3)
            got = volume.transmittance(table, s, e, steps, vol)
            assert got.shape == shape
            assert torch.equal(got, volume.transmittance_plain(table, s, e,
                                                               steps, vol))


@pytest.mark.card
def test_kernel_takes_a_strided_start(card):
    """An expanded start (the point light's position) gives the plain
    path's bits."""
    table = small_table().to(card)
    vol = cfg_mod.VolumeConfig(grid_shape=(6, 5, 7), box_size=(3.0, 2.5, 3.5))
    _, end = (t.to(card) for t in segments(1000, vol))
    start = torch.tensor([0.3, -0.2, 0.9], device=card).expand(end.shape)
    assert torch.equal(volume.transmittance(table, start, end, 32, vol),
                       volume.transmittance_plain(table, start, end, 32, vol))


@pytest.mark.card
def test_kernel_counts(card):
    """Two launches a call (the samples and the finish), none without rows;
    in the span every density sample is the kernel's."""
    table = small_table().to(card)
    vol = cfg_mod.VolumeConfig(grid_shape=(6, 5, 7), box_size=(3.0, 2.5, 3.5))
    start, end = (t.to(card) for t in segments(777, vol))
    launches = volume.LAUNCHES
    with profiling.tracing(card) as rec:
        for steps in (16, 32, 64):
            volume.transmittance(table, start, end, steps, vol)
        volume.transmittance(table, start[:0], end[:0], 16, vol)  # no rows
    assert volume.LAUNCHES == launches + 6
    spans = [r for r in rec.records() if r.name == "transmittance"]
    assert [r.counts["density_samples"] for r in spans] == [
        777 * 16, 777 * 32, 777 * 64, 0]
    assert [r.counts.get("density_samples_kernel", 0) for r in spans] == [
        777 * 16, 777 * 32, 777 * 64, 0]


@pytest.mark.card
@pytest.mark.parametrize("what", ["float64 start", "float64 table",
                                  "non-contiguous table", "another grid",
                                  "end on the CPU"])
def test_kernel_refuses_what_it_does_not_take(card, what):
    """On the card the wrapper raises; it never falls back to the plain
    path."""
    table = small_table().to(card)
    vol = cfg_mod.VolumeConfig(grid_shape=(6, 5, 7))
    start, end = (t.to(card) for t in segments(100, vol))
    launches = volume.LAUNCHES
    t, s, e = {
        "float64 start": (table, start.double(), end.double()),
        "float64 table": (table.double(), start, end),
        "non-contiguous table": (table.t().contiguous().t(), start, end),
        "another grid": (small_table((5, 5, 7)).to(card), start, end),
        "end on the CPU": (table, start, end.cpu()),
    }[what]
    with pytest.raises(ValueError):
        volume.transmittance(t, s, e, 16, vol)
    assert volume.LAUNCHES == launches
