"""Minimal OpenEXR writer/reader (uncompressed scanlines, HALF or FLOAT)
-- the port's own copy of ``neuralradiancecaching_tpu/io/exr.py`` (numpy,
struct and zlib only), kept equal to it so the port imports nothing of the
JAX package.

The reference links OpenEXR for ReadEXR/WriteEXR RGBA half
(openexr_helper.cpp:15-73); this is a dependency-free re-implementation of
exactly the subset the framework needs -- headless frame output and
golden-image tests. Also provides a PNG writer (zlib from the stdlib) for
quick previews, replacing the swapchain presentation path.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_HALF, _FLOAT = 1, 2


def _attr(name: bytes, typ: bytes, value: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(value)) + value


def _chlist(channels, pixel_type: int) -> bytes:
    out = b""
    for name in channels:  # must be alphabetical in the file
        out += name + b"\0" + struct.pack("<i", pixel_type) + b"\0\0\0\0" \
            + struct.pack("<ii", 1, 1)
    return out + b"\0"


def write_exr(path: str, image: np.ndarray, half: bool = True) -> None:
    """Write (H, W, 3) or (H, W, 4) float image as scanline EXR, no
    compression. Channels B,G,R(,A) in file order per the spec."""
    image = np.asarray(image)
    h, w, c = image.shape
    assert c in (3, 4), "RGB or RGBA"
    names = [b"A", b"B", b"G", b"R"] if c == 4 else [b"B", b"G", b"R"]
    # channel name -> source index in the RGB(A) image
    src = {b"R": 0, b"G": 1, b"B": 2, b"A": 3}
    dtype = np.float16 if half else np.float32
    ptype = _HALF if half else _FLOAT
    psize = 2 if half else 4

    header = b""
    header += _attr(b"channels", b"chlist", _chlist(names, ptype))
    header += _attr(b"compression", b"compression", b"\0")
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", b"\0")
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    prefix = struct.pack("<ii", _MAGIC, 2) + header
    offset_table_size = 8 * h
    scan_bytes = 8 + len(names) * w * psize
    first = len(prefix) + offset_table_size
    offsets = struct.pack("<" + "Q" * h,
                          *[first + y * scan_bytes for y in range(h)])

    rows = []
    img = image.astype(dtype)
    for y in range(h):
        payload = b"".join(img[y, :, src[n]].tobytes() for n in names)
        rows.append(struct.pack("<ii", y, len(payload)) + payload)

    with open(path, "wb") as f:
        f.write(prefix)
        f.write(offsets)
        f.write(b"".join(rows))


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed scanline EXR (as written above; also handles
    arbitrary channel orders / HALF/FLOAT). Returns (H, W, C) float32 with
    channels in R,G,B(,A) order when those names exist."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    channels = []
    data_window = None
    compression = None
    while data[pos] != 0:
        nend = data.index(b"\0", pos)
        name = data[pos:nend]
        pos = nend + 1
        tend = data.index(b"\0", pos)
        typ = data[pos:tend]
        pos = tend + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        value = data[pos:pos + size]
        pos += size
        if name == b"channels":
            cp = 0
            while value[cp] != 0:
                ce = value.index(b"\0", cp)
                cname = value[cp:ce]
                ptype = struct.unpack_from("<i", value, ce + 1)[0]
                channels.append((cname, ptype))
                cp = ce + 1 + 4 + 4 + 8
        elif name == b"dataWindow":
            data_window = struct.unpack("<iiii", value)
        elif name == b"compression":
            compression = value[0]
    pos += 1  # header terminator
    if compression != 0:
        raise ValueError("only uncompressed EXR supported")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    pos += 8 * h  # offset table

    chans = {}
    for _y in range(h):
        y, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        for cname, ptype in channels:
            n = w * (2 if ptype == _HALF else 4)
            dt = np.float16 if ptype == _HALF else np.float32
            row = np.frombuffer(data, dtype=dt, count=w, offset=pos)
            chans.setdefault(cname, np.zeros((h, w), np.float32))[y - y0] = row
            pos += n

    order = [n for n in (b"R", b"G", b"B", b"A") if n in chans]
    if not order:
        order = sorted(chans)
    return np.stack([chans[n] for n in order], axis=-1)


# ---------------------------------------------------------------------------
# PNG (preview output)
# ---------------------------------------------------------------------------

def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 or float (tonemapped+gamma if float) PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\0" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = tag + payload
        return struct.pack(">I", len(payload)) + c \
            + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def tonemap(image: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """Simple Reinhard tonemap for HDR preview PNGs."""
    x = np.maximum(np.asarray(image, np.float32), 0.0) * exposure
    return x / (1.0 + x)
