"""Asset loading with synthesize fallbacks -- the port's own copy of the
loaders of ``neuralradiancecaching_tpu/io/assets.py`` and ``io/hdr.py``
(numpy, and the native library of ``io/native.py`` for the HDR decode).

The loaders (a) parse the real files when present in the checkout's
``data/`` directory, with the reference's exact layout (ReadFileDensity3D
raw fp32 x-major, read_file.cpp:50-78; Radiance RGBE ``.hdr``), and (b)
otherwise synthesize deterministic stand-ins with identical shapes: an fbm
procedural cloud and an analytic sky. The arrays equal the JAX package's
for the same files or the same synthesis. Nothing outside the checkout is
read: the JAX package also looks in a fixed absolute directory first,
which the port does not follow; put the reference's ``cloud_sixteenth`` and
``image/photostudio*.hdr`` in ``data/`` to load them. MNIST reads the idx
label files from ``data/mnist/`` (none ships with the repository, and
nothing is downloaded: without a label file ``load_mnist`` raises, as the
JAX loader does), and the idx image files beside them when present, else
images synthesized from the labels.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from neuralradiancecaching_tpu_torch.io import native

# the checkout's data directory (git-ignored): reference assets when
# present, and the cached synthesized cloud
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "data")

CLOUD_SHAPE = (125, 85, 153)  # (x, y, z), src/main.cpp:123

CLOUD_FILES = (os.path.join(CACHE_DIR, "cloud_sixteenth"),)
ENV_FILES = (os.path.join(CACHE_DIR, "image/photostudio_4k.hdr"),
             os.path.join(CACHE_DIR, "image/photostudio.hdr"),
             os.path.join(CACHE_DIR, "photostudio.hdr"))
# directories searched in order for MNIST's {train,t10k}-labels-idx1-ubyte
# (the images are read from beside the labels found)
MNIST_DIRS = (os.path.join(CACHE_DIR, "mnist"),)


def read_density3d(path: str, shape: Tuple[int, int, int]) -> np.ndarray:
    """ReadFileDensity3D (read_file.cpp:50-78): raw fp32, x-major ([x][y][z]
    nesting => x varies slowest). Returns (Nx, Ny, Nz) float32."""
    data = np.fromfile(path, dtype=np.float32)
    nx, ny, nz = shape
    if data.size != nx * ny * nz:
        raise ValueError(f"{path}: expected {nx*ny*nz} floats, got {data.size}")
    return data.reshape(nx, ny, nz)


def _value_noise_3d(rng: np.random.Generator, shape, cells) -> np.ndarray:
    """Trilinearly-interpolated lattice noise, one octave."""
    lattice = rng.random((cells + 1, cells + 1, cells + 1)).astype(np.float32)
    coords = [np.linspace(0, cells, n, endpoint=False, dtype=np.float32)
              for n in shape]
    gx, gy, gz = np.meshgrid(*coords, indexing="ij")
    i0 = np.floor(gx).astype(int), np.floor(gy).astype(int), \
        np.floor(gz).astype(int)
    f = gx - i0[0], gy - i0[1], gz - i0[2]
    out = np.zeros(shape, dtype=np.float32)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                w = ((f[0] if cx else 1 - f[0])
                     * (f[1] if cy else 1 - f[1])
                     * (f[2] if cz else 1 - f[2]))
                out += w * lattice[i0[0] + cx, i0[1] + cy, i0[2] + cz]
    return out


def synthesize_cloud(shape=CLOUD_SHAPE, seed: int = 7) -> np.ndarray:
    """Deterministic fbm cloud with an ellipsoidal falloff, density in
    [0, 1] like the reference volume (which is 8-bit quantized on upload)."""
    rng = np.random.default_rng(seed)
    fbm = np.zeros(shape, dtype=np.float32)
    amp, total = 1.0, 0.0
    for octave_cells in (4, 8, 16, 32):
        fbm += amp * _value_noise_3d(rng, shape, octave_cells)
        total += amp
        amp *= 0.5
    fbm /= total

    # ellipsoid falloff so the cloud floats inside the box
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    r2 = (gx / 0.8) ** 2 + (gy / 0.7) ** 2 + (gz / 0.8) ** 2
    falloff = np.clip(1.0 - r2, 0.0, 1.0)

    dens = np.clip((fbm - 0.4) * 2.5, 0.0, 1.0) * falloff
    return dens.astype(np.float32)


def load_cloud(path: str | None = None) -> np.ndarray:
    """The cloud_sixteenth volume: real file if present, else a cached
    synthesized stand-in of identical shape."""
    candidates = ([path] if path else []) + list(CLOUD_FILES)
    for cand in candidates:
        if os.path.exists(cand):
            return read_density3d(cand, CLOUD_SHAPE)
    dens = synthesize_cloud()
    os.makedirs(CACHE_DIR, exist_ok=True)
    dens.astype(np.float32).tofile(CLOUD_FILES[0])
    return dens


def load_env_map(path: str | None = None) -> np.ndarray:
    """The HDR environment map: photostudio_4k if present, else the small
    photostudio.hdr of the reference, else a synthetic sky."""
    candidates = ([path] if path else []) + list(ENV_FILES)
    for cand in candidates:
        if os.path.exists(cand):
            return read_hdr(cand)
    return synthesize_sky()


def synthesize_sky(height: int = 128, width: int = 256) -> np.ndarray:
    """Simple analytic sky: blue gradient + warm 'sun' disc, (H, W, 3)."""
    v = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    u = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    sky = np.stack([
        0.3 + 0.2 * v + 0 * u, 0.5 + 0.2 * v + 0 * u, 0.8 + 0.2 * v + 0 * u,
    ], axis=-1)
    d2 = ((u - 0.7) ** 2 + (v - 0.3) ** 2)
    sun = 50.0 * np.exp(-d2 / 0.001)[..., None] * np.array([1.0, 0.9, 0.7],
                                                           np.float32)
    return (sky + sun).astype(np.float32)


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE) reader (the reference's stb_image path,
# read_file.cpp:80-121): new-style per-channel RLE scanlines and the flat
# fallback, (H, W, 3) float32 linear radiance. The payload is decoded by the
# native library (native.hdr_decode, csrc/nrcio.cpp), as the JAX loader does
# when its library is built; hdr_decode_plain is its plain version.
# ---------------------------------------------------------------------------

def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 (stb semantics:
    f = ldexp(1, e - 136), rgb = c * f; e == 0 -> black)."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _read_hdr_payload(path: str) -> tuple[bytes, int, int]:
    """A Radiance file's pixel payload (the bytes after its header) and its
    width and height."""
    with open(path, "rb") as f:
        data = f.read()

    # header: lines until the blank line, then the resolution line
    pos = 0

    def readline():
        nonlocal pos
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        return line

    magic = readline()
    if not (magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    while True:
        line = readline()
        if line == b"":
            break
    res = readline().split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    return data[pos:], int(res[3]), int(res[1])


def read_hdr(path: str) -> np.ndarray:
    """Decode a Radiance file through the native library, which is built at
    first use; a failed build raises (there is no fallback)."""
    payload, width, height = _read_hdr_payload(path)
    return native.hdr_decode(payload, width, height)


def hdr_decode_plain(payload: bytes, width: int, height: int) -> np.ndarray:
    """The plain version of ``native.hdr_decode``: the pure-Python RLE
    decode, one Python iteration per packet (the tests and chip_smoke.py
    hold the native decode to it bit for bit)."""
    out = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(payload, dtype=np.uint8)
    bp = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2 \
                or (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) != width:
            # flat (non-RLE) scanline: width RGBE pixels
            row = buf[bp:bp + width * 4].reshape(width, 4)
            out[y] = row
            bp += width * 4
            continue
        bp += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bp])
                bp += 1
                if count > 128:  # run
                    out[y, x:x + count - 128, c] = buf[bp]
                    bp += 1
                    x += count - 128
                else:  # literal
                    if count == 0:
                        # a zero-count packet never advances x; treat as a
                        # corrupt/truncated file instead of spinning forever
                        raise ValueError(
                            f"corrupt HDR RLE scanline (zero-count packet) "
                            f"at y={y}")
                    out[y, x:x + count, c] = buf[bp:bp + count]
                    bp += count
                    x += count
    return _decode_rgbe(out)


# ---------------------------------------------------------------------------
# MNIST: the idx readers, and digit images synthesized from the labels when
# the image files are missing (as in the reference checkout)
# ---------------------------------------------------------------------------

# 5x7 digit glyph bitmaps for the synthetic images
_DIGIT_GLYPHS = [
    "01110 10001 10011 10101 11001 10001 01110",  # 0
    "00100 01100 00100 00100 00100 00100 01110",  # 1
    "01110 10001 00001 00010 00100 01000 11111",  # 2
    "11110 00001 00001 01110 00001 00001 11110",  # 3
    "00010 00110 01010 10010 11111 00010 00010",  # 4
    "11111 10000 11110 00001 00001 10001 01110",  # 5
    "00110 01000 10000 11110 10001 10001 01110",  # 6
    "11111 00001 00010 00100 01000 01000 01000",  # 7
    "01110 10001 10001 01110 10001 10001 01110",  # 8
    "01110 10001 10001 01111 00001 00010 01100",  # 9
]


def read_idx_labels(path: str) -> np.ndarray:
    """MNIST idx1 label file parser (mnist_reader.hpp equivalent)."""
    with open(path, "rb") as f:
        magic, count = struct.unpack(">ii", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx1 magic {magic}")
        return np.frombuffer(f.read(count), dtype=np.uint8)


def read_idx_images(path: str) -> np.ndarray:
    """MNIST idx3 image file parser -> (N, 28, 28) uint8."""
    with open(path, "rb") as f:
        magic, count, rows, cols = struct.unpack(">iiii", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx3 magic {magic}")
        data = np.frombuffer(f.read(count * rows * cols), dtype=np.uint8)
        return data.reshape(count, rows, cols)


def synthesize_digit_images(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """Render 28x28 digit images from labels: upscaled glyphs with random
    shift + blur + noise. Deterministic; learnable by a tiny MLP."""
    rng = np.random.default_rng(seed)
    glyphs = np.zeros((10, 7, 5), dtype=np.float32)
    for d, rows in enumerate(_DIGIT_GLYPHS):
        for r, row in enumerate(rows.split()):
            for c, ch in enumerate(row):
                glyphs[d, r, c] = float(ch == "1")
    big = np.kron(glyphs, np.ones((3, 4), dtype=np.float32))  # (10, 21, 20)

    n = labels.shape[0]
    out = np.zeros((n, 28, 28), dtype=np.float32)
    dx = rng.integers(0, 28 - 20, size=n)
    dy = rng.integers(0, 28 - 21, size=n)
    for i in range(n):
        g = big[labels[i]]
        out[i, dy[i]:dy[i] + 21, dx[i]:dx[i] + 20] = g
    # box blur + noise
    blurred = out.copy()
    blurred[:, 1:] += out[:, :-1]
    blurred[:, :-1] += out[:, 1:]
    blurred[:, :, 1:] += out[:, :, :-1]
    blurred[:, :, :-1] += out[:, :, 1:]
    blurred /= 5.0
    blurred += rng.normal(0, 0.05, size=blurred.shape).astype(np.float32)
    return np.clip(blurred, 0.0, 1.0)


def load_mnist(split: str = "train", limit: int | None = None):
    """Returns (images (N, 784) float32 in [0,1], labels (N,) int32).

    Reads the first ``{name}-labels-idx1-ubyte`` of :data:`MNIST_DIRS`
    (FileNotFoundError when there is none), and the
    ``{name}-images-idx3-ubyte`` beside it if present, else synthesizes
    the images from the labels.
    """
    name = "train" if split == "train" else "t10k"
    label_paths = [os.path.join(d, f"{name}-labels-idx1-ubyte")
                   for d in MNIST_DIRS]
    label_path = next((p for p in label_paths if os.path.exists(p)), None)
    if label_path is None:
        raise FileNotFoundError(
            f"no MNIST label file {name}-labels-idx1-ubyte in {MNIST_DIRS}")
    labels = read_idx_labels(label_path)
    if limit:
        labels = labels[:limit]
    image_path = os.path.join(os.path.dirname(label_path),
                              f"{name}-images-idx3-ubyte")
    if os.path.exists(image_path):
        images = read_idx_images(image_path)[:len(labels)]
        images = images.astype(np.float32) / 255.0
    else:
        images = synthesize_digit_images(labels)
    return images.reshape(len(labels), -1), labels.astype(np.int32)
