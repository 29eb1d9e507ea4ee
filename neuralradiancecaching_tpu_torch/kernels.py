"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. At first use
(or together, one nvcc each, through :func:`build_all`) it is compiled with
``nvcc`` for Hopper (``sm_90a``) into
``neuralradiancecaching_tpu_torch/_build/`` (git-ignored), under a file name
keyed by a hash of the source and the flags, and loaded with ``ctypes``.
Nothing here runs at import time; a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# seconds the fresh build of each library took in this process (0.0 when
# it was built before)
BUILD_SECONDS: dict[str, float] = {}
# nvcc's output of that build: ptxas registers, shared memory and spills
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


class _Build:
    """One nvcc process compiling ``csrc/<name>.cu`` into a temporary file
    beside its final library path."""

    def __init__(self, name: str):
        self.name, self.so = name, library_path(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, self.tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        self.cmd = [_nvcc(), *NVCC_FLAGS, "-o", self.tmp,
                    str(CSRC_DIR / f"{name}.cu")]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def finish(self) -> None:
        out, err = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({self.proc.returncode}) building "
                f"{self.name}:\n{' '.join(self.cmd)}\n{out}\n{err}")
        BUILD_LOG[self.name] = (out + err).strip()
        os.replace(self.tmp, self.so)
        BUILD_SECONDS[self.name] = time.perf_counter() - self.t0


def build_all(names) -> list[Path]:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no build of
    its exact source yet, one nvcc per source, all started together."""
    builds = []
    for name in names:
        if library_path(name).exists():  # keep the record of its build
            BUILD_SECONDS.setdefault(name, 0.0)
            BUILD_LOG.setdefault(name, "")
        else:
            builds.append(_Build(name))
    try:
        for b in builds:
            b.finish()
    finally:
        for b in builds:  # a failed build stops the others still running
            if b.proc.poll() is None:
                b.proc.kill()
                b.proc.wait()
            if os.path.exists(b.tmp):
                os.unlink(b.tmp)
    return [library_path(name) for name in names]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists."""
    return build_all([name])[0]


def sass(name: str) -> str:
    """The machine code of the built ``csrc/<name>.cu``, as the toolkit's
    ``cuobjdump -sass`` prints it (to see which instructions it uses)."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(build(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
