"""The port's native asset library (``io/native.py`` over its own
``csrc/nrcio.cpp``, the HDR decode) and ``utils/runtime.setup_cache``
against the JAX package.

- ``native.hdr_decode`` and the port's ``assets.read_hdr`` (which decodes
  through it) equal JAX's ``io/hdr.read_hdr`` bit for bit, JAX taking its
  pure-Python decode, on ``.hdr`` files written here from seeded images:
  RLE scanlines mixing runs and literals (127-byte runs, 127- and 128-byte
  literals), rows of runs only, flat scanlines, a width under 8, the
  narrowest RLE width (8) and every RGBE exponent 0-255. The port's plain
  decode ``assets.hdr_decode_plain`` agrees too. Corrupt payloads raise
  ``ValueError``.
- ``setup_cache`` names the build directory and refuses to move it once a
  library is loaded, a second process does not rebuild, the compiler keys
  the library, and a missing compiler makes ``read_hdr`` raise (no
  fallback).
- Every public top-level name of the JAX package has a counterpart in the
  port, but for the native bindings that only the JAX package's tests call.
"""

import ast
import collections
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from neuralradiancecaching_tpu.io import hdr as jhdr
from neuralradiancecaching_tpu.io import native as jnative
from neuralradiancecaching_tpu_torch import kernels
from neuralradiancecaching_tpu_torch.io import assets as tassets
from neuralradiancecaching_tpu_torch.io import native
from neuralradiancecaching_tpu_torch.utils import runtime, setup_cache

REPO = Path(__file__).resolve().parent.parent
HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


@pytest.fixture(autouse=True)
def jax_python_hdr(monkeypatch):
    """JAX's ``read_hdr`` takes its pure-Python decode (its own library is
    not built here; this holds the reference to that path if it were)."""
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.fixture
def fresh_build(monkeypatch):
    """No library loaded in this process; the build directory is restored
    after the test."""
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)


# ---------------------------------------------------------------------------
# a Radiance writer: flat and new-style RLE scanlines
# ---------------------------------------------------------------------------

def rle_channel(v: np.ndarray, packets: collections.Counter) -> bytes:
    """One channel of a scanline as the Radiance encoder writes it: runs of
    3 to 127 equal bytes, literals of up to 128 bytes between them."""
    out, x, n = bytearray(), 0, len(v)

    def run_at(i):
        r = 1
        while i + r < n and r < 127 and v[i + r] == v[i]:
            r += 1
        return r

    while x < n:
        r = run_at(x)
        if r >= 3:
            out += bytes([128 + r, v[x]])
            packets["run", r] += 1
            x += r
            continue
        s = x
        while x < n and x - s < 128 and run_at(x) < 3:
            x += 1
        out += bytes([x - s]) + v[s:x].tobytes()
        packets["literal", x - s] += 1
    return bytes(out)


def encode_hdr(rgbe: np.ndarray, rle_rows=None):
    """(H, W, 4) uint8 -> (payload, packet counts); the rows in
    ``rle_rows`` (all by default) are RLE, the others flat."""
    h, w, _ = rgbe.shape
    rle_rows = range(h) if rle_rows is None else rle_rows
    payload, packets = bytearray(), collections.Counter()
    for y in range(h):
        if y in rle_rows:
            payload += bytes([2, 2, w >> 8, w & 0xFF])
            for c in range(4):
                payload += rle_channel(rgbe[y, :, c], packets)
        else:
            payload += rgbe[y].tobytes()
    return bytes(payload), packets


def write_hdr(path: Path, payload: bytes, width: int, height: int) -> str:
    path.write_bytes(HEADER + f"-Y {height} +X {width}\n".encode() + payload)
    return str(path)


def segmented_image(rng, h: int) -> np.ndarray:
    """(h, 512, 4) RGBE: each channel of a row is random 127 bytes, a
    constant 130, random 200 and a constant 55 (a 127-byte literal, a
    127-byte run, a 128-byte literal ...), in a rotated order per row."""
    out = np.empty((h, 512, 4), np.uint8)
    for y in range(h):
        for c in range(4):
            segs = [rng.integers(0, 256, 127), np.full(130, rng.integers(256)),
                    rng.integers(0, 256, 200), np.full(55, rng.integers(256))]
            k = (y + c) % 4
            out[y, :, c] = np.concatenate(segs[k:] + segs[:k])
    out[..., 3] = np.maximum(out[..., 3], 100)  # keep the pixels lit
    return out


def exponent_image(rng) -> np.ndarray:
    """(4, 256, 4) RGBE: every exponent 0-255 in each row, random RGB."""
    out = rng.integers(0, 256, (4, 256, 4)).astype(np.uint8)
    out[..., 3] = (np.arange(256)[None, :] + 37 * np.arange(4)[:, None]) % 256
    return out


def hdr_cases(rng):
    """(name, rgbe, rle_rows) for every valid file of the HDR tests."""
    mixed = rng.integers(0, 256, (6, 40, 4)).astype(np.uint8)
    mixed[..., 3] = rng.integers(120, 140, (6, 40))
    mixed[2, 5:30] = mixed[2, 5]  # runs in every channel of a row
    runs = np.repeat(rng.integers(0, 256, (3, 1, 4)), 300, axis=1).astype(
        np.uint8)
    runs[1, 150:] = rng.integers(0, 256, 4)  # two runs per channel
    return [("segmented_rle", segmented_image(rng, 6), None),
            ("runs_only", runs, None),
            ("width_8_rle", rng.integers(0, 256, (4, 8, 4)).astype(np.uint8),
             None),
            ("flat", rng.integers(0, 256, (5, 33, 4)).astype(np.uint8), ()),
            ("narrow", rng.integers(0, 256, (7, 5, 4)).astype(np.uint8), ()),
            ("mixed_flat_and_rle", mixed, (0, 2, 3)),
            ("exponents_rle", exponent_image(rng), None),
            ("exponents_flat", exponent_image(rng), ())]


CASE_NAMES = [c[0] for c in hdr_cases(np.random.default_rng(0))]


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", CASE_NAMES)
def test_hdr_decode_matches_jax(case, tmp_path):
    """The native decode, the port's loader and its plain decode equal
    JAX's pure-Python ``read_hdr`` bit for bit; the native scale
    ``ldexp(1.0f, e - 136)`` in float and JAX's in float64 cast to float32
    are the same powers of two, subnormals at e = 1 included."""
    name, rgbe, rle_rows = next(c for c in hdr_cases(np.random.default_rng(0))
                                if c[0] == case)
    h, w, _ = rgbe.shape
    payload, packets = encode_hdr(rgbe, rle_rows)
    if case == "segmented_rle":
        for packet in (("run", 127), ("literal", 127), ("literal", 128)):
            assert packets[packet] > 0, packet
        assert any(k[0] == "run" and k[1] < 127 for k in packets)
    if case == "runs_only":
        assert {k[0] for k in packets} == {"run"}
    if case == "width_8_rle":  # the narrowest width that is RLE-coded
        assert payload[:4] == bytes([2, 2, 0, 8])
    path = write_hdr(tmp_path / f"{case}.hdr", payload, w, h)
    ref = jhdr.read_hdr(path)
    assert ref.shape == (h, w, 3) and ref.dtype == np.float32
    if case.startswith("exponents"):
        lit = rgbe[..., :3] > 0
        sub = ref[(rgbe[..., 3] == 1)[..., None] & lit]
        assert sub.size and (sub > 0).all() and (sub < 2.0 ** -126).all()
        assert (ref[(rgbe[..., 3] == 0)] == 0).all()
    for got in (native.hdr_decode(payload, w, h), tassets.read_hdr(path),
                tassets.hdr_decode_plain(payload, w, h),
                tassets.load_env_map(path)):
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_array_equal(bits(got), bits(ref))


def corrupt_payloads():
    w = 16
    head = bytes([2, 2, 0, w])
    good, _ = encode_hdr(segmented_image(np.random.default_rng(1), 1)[:, :w])
    return {
        "zero_count": (head + bytes([0]) + b"\x00" * 64, w, 1),
        "truncated": (good[:len(good) // 2], w, 1),
        "run_past_width": (head + bytes([128 + 20, 7]) + b"\x00" * 64, w, 1),
        "literal_past_width": (head + bytes([20]) + b"\x01" * 64, w, 1),
        "flat_truncated": (b"\x01" * (4 * 5 * 3 - 1), 5, 3),
    }


@pytest.mark.parametrize("case", sorted(corrupt_payloads()))
def test_corrupt_hdr_raises(case, tmp_path):
    payload, w, h = corrupt_payloads()[case]
    with pytest.raises(ValueError):
        native.hdr_decode(payload, w, h)
    path = write_hdr(tmp_path / "corrupt.hdr", payload, w, h)
    with pytest.raises(ValueError):
        tassets.read_hdr(path)


def test_hdr_header_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"P6\n\n-Y 1 +X 1\n\x00\x00\x00\x00")
    rot = tmp_path / "rot.hdr"
    rot.write_bytes(HEADER + b"+Y 1 +X 1\n\x00\x00\x00\x00")
    for path in (bad, rot):
        with pytest.raises(ValueError) as je:
            jhdr.read_hdr(str(path))
        with pytest.raises(ValueError) as te:
            tassets.read_hdr(str(path))
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the build: setup_cache, a second process, a missing compiler
# ---------------------------------------------------------------------------

def test_setup_cache_builds_there(tmp_path, fresh_build):
    """``setup_cache(path)`` makes every build land in ``path`` and is
    idempotent; ``available`` reports the build without building; a second
    process loads it without a rebuild; ``setup_cache()`` restores the
    default directory."""
    cache = tmp_path / "cache"
    setup_cache(cache)
    setup_cache(cache)
    assert kernels.BUILD_DIR == cache and not native.available()
    assert not cache.exists()
    rgbe = np.random.default_rng(4).integers(0, 256, (2, 12, 4)).astype(
        np.uint8)
    payload, _ = encode_hdr(rgbe)
    native.hdr_decode(payload, 12, 2)
    lib = kernels.library_path("nrcio")
    assert lib.parent == cache and lib.exists() and native.available()
    assert kernels.BUILD_SECONDS["nrcio"] > 0.0
    assert sorted(p.name for p in cache.iterdir()) == [lib.name]
    code = (
        "import sys; from neuralradiancecaching_tpu_torch import kernels\n"
        "from neuralradiancecaching_tpu_torch.utils import setup_cache\n"
        "from neuralradiancecaching_tpu_torch.io import native\n"
        f"setup_cache({str(cache)!r}); assert native.available()\n"
        f"native.hdr_decode({payload!r}, 12, 2)\n"
        "print(kernels.BUILD_SECONDS['nrcio'], kernels.library_path('nrcio'))"
        "\nassert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seconds, path = proc.stdout.split()
    assert float(seconds) == 0.0 and path == str(lib)
    kernels._LIBS.clear()
    runtime.setup_cache()
    assert kernels.BUILD_DIR == kernels.DEFAULT_BUILD_DIR
    assert kernels.DEFAULT_BUILD_DIR == REPO / (
        "neuralradiancecaching_tpu_torch/_build")


def test_setup_cache_refuses_to_move_loaded_libraries(tmp_path, fresh_build):
    """Once a library is loaded from the build directory, naming the same
    directory again is a no-op and naming another raises (the loaded
    library would go on coming from the first)."""
    setup_cache(tmp_path / "first")
    payload, _ = encode_hdr(np.full((1, 9, 4), 130, np.uint8))
    native.hdr_decode(payload, 9, 1)
    assert kernels.library_path("nrcio").parent == tmp_path / "first"
    setup_cache(tmp_path / "first")
    with pytest.raises(RuntimeError, match="already loaded"):
        setup_cache(tmp_path / "second")
    with pytest.raises(RuntimeError, match="already loaded"):
        setup_cache()
    assert kernels.BUILD_DIR == tmp_path / "first"
    assert not (tmp_path / "second").exists()


def test_compiler_keys_the_host_library(tmp_path, monkeypatch):
    """The host library's path changes with the compiler ``CXX`` resolves
    to, and with nothing else of the environment; a CUDA kernel's does
    not change with ``CXX``."""
    cxx = kernels._cxx()
    other = tmp_path / "other-c++"
    other.symlink_to(cxx)
    monkeypatch.delenv("CXX", raising=False)
    default = kernels.library_path("nrcio")
    cu = kernels.library_path("matmul")
    monkeypatch.setenv("CXX", cxx)
    assert kernels.library_path("nrcio") == default  # the same compiler
    monkeypatch.setenv("CXX", str(tmp_path / "missing-c++"))
    assert kernels.library_path("nrcio") != default
    assert kernels.library_path("matmul") == cu
    other.unlink()
    other.write_text("#!/bin/sh\nexit 0\n")
    other.chmod(0o755)
    monkeypatch.setenv("CXX", str(other))
    assert kernels.library_path("nrcio") != default


def test_missing_compiler_raises_no_fallback(tmp_path, fresh_build,
                                             monkeypatch):
    """With ``CXX`` naming a missing compiler and an empty build directory
    the port's ``read_hdr`` raises, though the plain decode would read the
    file."""
    rgbe = np.random.default_rng(5).integers(0, 256, (3, 9, 4)).astype(
        np.uint8)
    payload, _ = encode_hdr(rgbe)
    path = write_hdr(tmp_path / "ok.hdr", payload, 9, 3)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    setup_cache(tmp_path / "empty")
    with pytest.raises(RuntimeError, match="no-such-c"):
        tassets.read_hdr(path)
    with pytest.raises(RuntimeError):
        tassets.load_env_map(path)
    assert not native.available()
    assert list((tmp_path / "empty").glob("*.so")) == []
    np.testing.assert_array_equal(tassets.hdr_decode_plain(payload, 9, 3),
                                  jhdr.read_hdr(path))


def test_failed_compile_raises_with_output(tmp_path, fresh_build,
                                           monkeypatch):
    """A compiler that exits non-zero raises with its output, and leaves no
    library or temporary file behind."""
    fake = tmp_path / "fake-c++"
    fake.write_text("#!/bin/sh\necho 'fake compiler error' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    setup_cache(tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler error"):
        native.hdr_decode(b"\x00" * 16, 1, 4)
    assert list((tmp_path / "build").iterdir()) == []


# ---------------------------------------------------------------------------
# the port has every public name of the JAX package
# ---------------------------------------------------------------------------

def public_names(root: Path) -> dict:
    """{module path: public top-level def and class names} of a package."""
    out = {}
    for f in root.rglob("*.py"):
        tree = ast.parse(f.read_text())
        out[f.relative_to(root).as_posix()] = {
            n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}
    return out


# JAX names with no counterpart in the port, each with its reason
NOT_PORTED = {
    # native bindings that no loader of the JAX package calls, only its own
    # tests/test_native.py; the port's loaders, like JAX's, use their
    # Python counterparts (ops/envmap.build_inverse_cdfs,
    # io/assets.read_density3d, io/assets.read_idx_labels, io/exr.write_exr,
    # and io/assets.synthesize_cloud, which is another function than the
    # native fbm), so a binding here would be a second copy with no caller
    "io/native.py": {"build_inv_cdfs", "read_density", "synthesize_cloud",
                     "write_exr", "read_idx1"},
    # folded into the port's tracer (utils/profiling.py: span, tracing):
    # a phase timer that synchronized the device at each phase's end, and
    # a rate that no caller read
    "utils/profiling.py": {"PhaseTimer", "rays_per_second"},
}


def test_port_has_every_public_name():
    """An AST diff of the public top-level defs and classes: every name of
    the JAX package is in some module of the port, but for NOT_PORTED;
    ``io/native.py`` and ``utils/runtime.py`` have the rest of theirs."""
    jax_names = public_names(REPO / "neuralradiancecaching_tpu")
    port_names = public_names(REPO / "neuralradiancecaching_tpu_torch")
    everywhere = set().union(*port_names.values())
    missing = {m: sorted(ns - everywhere - NOT_PORTED.get(m, set()))
               for m, ns in jax_names.items()}
    assert not {m: ns for m, ns in missing.items() if ns}, missing
    for module, names in NOT_PORTED.items():
        assert names <= jax_names[module], module
    for module in ("io/native.py", "utils/runtime.py"):
        assert jax_names[module] - NOT_PORTED.get(module, set()) \
            == port_names[module], module
    assert port_names["io/native.py"] == {"available", "hdr_decode"}
    assert port_names["utils/runtime.py"] == {"setup_cache"}
