"""Build and load the port's hand-written CUDA kernels and its host library.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. At first use
(or together, one nvcc each, through :func:`build_all`) it is compiled with
``nvcc`` for Hopper (``sm_90a``) into the build directory, under a file name
keyed by a hash of the source and the flags, and loaded with ``ctypes``.
The host library ``csrc/nrcio.cpp`` (a ``csrc/<name>.cpp``, also a plain C
interface) is built the same way with the host C++ compiler (``CXX`` if set,
else ``c++`` on ``PATH``), whose resolved path joins the hash. The build
directory is
``neuralradiancecaching_tpu_torch/_build/`` (git-ignored) unless
``utils.runtime.setup_cache`` names another. Nothing here runs at import
time; a failed build raises with the compiler's output.
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
DEFAULT_BUILD_DIR = PKG_DIR / "_build"
# where every library is built and loaded from (utils.runtime.setup_cache)
BUILD_DIR = DEFAULT_BUILD_DIR
# the hand-written CUDA kernels, csrc/<name>.cu: K1 (the query MLP), K2
# (the fp32 matrix product) and the quadrature transmittance
CUDA_KERNELS = ("fused_mlp", "matmul", "transmittance")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the Makefile's flags for the JAX package's copy of nrcio, without
# -march=native: a library is keyed by source and flags, not by the host's
# ISA, and -march=native would let the compiler contract multiply-adds
# differently from one host to another
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_LIBS: dict[str, ctypes.CDLL] = {}
# seconds the fresh build of each library took in this process (0.0 when
# it was built before)
BUILD_SECONDS: dict[str, float] = {}
# the compiler's output of that build (nvcc's: ptxas registers, shared
# memory and spills)
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


def _cxx_named() -> tuple[str, str | None]:
    """The host C++ compiler as named (``CXX``, else ``c++``) and where it
    resolves on ``PATH`` (None when it does not)."""
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    return cxx, os.path.realpath(found) if found else None


def _cxx() -> str:
    cxx, found = _cxx_named()
    if not found:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found: set CXX or "
                           f"put c++ on PATH")
    return found


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """``csrc/<name>.cu`` with nvcc's flags, else ``csrc/<name>.cpp`` with
    the host compiler's."""
    cu = CSRC_DIR / f"{name}.cu"
    if cu.exists():
        return cu, NVCC_FLAGS
    return CSRC_DIR / f"{name}.cpp", CXX_FLAGS


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` or ``.cpp`` lives:
    keyed by the source and the flags, and for a ``.cpp`` by the compiler,
    so that a change of ``CXX`` builds anew."""
    src, flags = _source(name)
    key = " ".join(flags)
    if src.suffix == ".cpp":
        cxx, found = _cxx_named()
        key += " " + (found or cxx)
    digest = hashlib.sha256(src.read_bytes() + key.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


class _Build:
    """One compiler process (nvcc for a ``.cu``, the host compiler for a
    ``.cpp``) building ``csrc/<name>`` into a temporary file beside its final
    library path."""

    def __init__(self, name: str):
        self.name, self.so = name, library_path(name)
        src, flags = _source(name)
        compiler = _nvcc() if src.suffix == ".cu" else _cxx()
        self.compiler = Path(compiler).name
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, self.tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        self.cmd = [compiler, *flags, "-o", self.tmp, str(src)]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def finish(self) -> None:
        out, err = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(
                f"{self.compiler} failed ({self.proc.returncode}) building "
                f"{self.name}:\n{' '.join(self.cmd)}\n{out}\n{err}")
        BUILD_LOG[self.name] = (out + err).strip()
        os.replace(self.tmp, self.so)
        BUILD_SECONDS[self.name] = time.perf_counter() - self.t0


def build_all(names) -> list[Path]:
    """Compile every ``csrc/<name>`` of ``names`` that has no build of its
    exact source yet, one compiler per source, all started together."""
    builds = []
    try:
        for name in names:
            if library_path(name).exists():  # keep the record of its build
                BUILD_SECONDS.setdefault(name, 0.0)
                BUILD_LOG.setdefault(name, "")
            else:
                builds.append(_Build(name))
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
    """Compile ``csrc/<name>`` unless a build of this exact source exists."""
    return build_all([name])[0]


def sass(name: str) -> str:
    """The machine code of the built ``csrc/<name>.cu``, as the toolkit's
    ``cuobjdump -sass`` prints it (to see which instructions it uses)."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(build(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, building it
    at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
