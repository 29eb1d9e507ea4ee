"""Process groups for the data-parallel steps: one rank per card.

Counterpart of ``neuralradiancecaching_tpu/parallel/mesh.py``. The JAX
package's 1-D device mesh becomes a ``torch.distributed`` process group of
one process per card (SPMD: every rank runs the same program on its own
share of the rays). :func:`make_mesh` joins the group a launcher set up --
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or :func:`spawn` (the same ranks plus a ``FileStore``
path in ``NRC_DIST_STORE``) -- or, without a launcher, a group of one.

  torchrun --nproc-per-node 4 -m neuralradiancecaching_tpu_torch.cli \\
      progressive --mesh auto
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

STORE_ENV = "NRC_DIST_STORE"


class Mesh(NamedTuple):
    """This rank's view of the data-parallel group."""
    group: dist.ProcessGroup  # the default (world) group
    rank: int
    size: int                 # the world size: the mesh's device count
    device: torch.device      # this rank's device
    backend: str              # "nccl" or "gloo"


def world_size() -> int:
    """The launcher's world size (1 without a launcher)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(n: Optional[int] = None,
              device: torch.device | str | None = None,
              backend: Optional[str] = None) -> Mesh:
    """Join (or start) the data-parallel group and return this rank's
    :class:`Mesh`.

    n: the expected world size (None: whatever the launcher set); a
    mismatch raises. device: this rank's device, by default
    ``cuda:LOCAL_RANK``; a bare "cuda" takes the local rank's card,
    "cpu" the CPU. backend: NCCL on the card, gloo on the CPU, unless
    named (gloo over CUDA tensors puts several ranks on one card, which
    NCCL refuses). A failed init raises: there is no fallback.
    """
    size = world_size()
    if n is not None and n != size:
        raise ValueError(f"a mesh of {n} needs {n} ranks; this process "
                         f"group has {size} (launch with torchrun "
                         f"--nproc-per-node {n})")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", "0"))
        store_path = os.environ.get(STORE_ENV)
        if store_path:
            dist.init_process_group(backend,
                                    store=dist.FileStore(store_path, size),
                                    rank=rank, world_size=size)
        elif "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=size)
        elif size == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise RuntimeError(f"WORLD_SIZE={size} without a rendezvous: "
                               f"launch with torchrun or spawn()")
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                device, backend)


def default_mesh() -> Mesh:
    """:func:`make_mesh` with its defaults: every rank the launcher
    started, each on its card."""
    return make_mesh()


def close_mesh() -> None:
    """Leave the process group (no-op when none is initialized)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(args: Sequence[str], n: int, store_dir: str | os.PathLike,
          env: Optional[dict] = None, timeout: float = 600.0) -> list[str]:
    """Run ``python <args>`` as n ranks of one group, without torchrun.

    Each rank is its own process (``sys.executable``) with ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and a ``FileStore`` in ``store_dir``
    (which must not hold one yet), so concurrent callers need no TCP port.
    A rank's output goes to ``rank<r>.out`` / ``.err`` there. Waits for all
    of them and returns their stdouts; raises when a rank exits non-zero or
    ``timeout`` seconds pass (the ranks still running are then killed).
    """
    store_dir = Path(store_dir)
    store_dir.mkdir(parents=True, exist_ok=True)
    store = store_dir / "filestore"
    if store.exists():
        raise FileExistsError(f"{store} holds an earlier group's store")
    procs, files = [], []
    try:
        for r in range(n):
            out = open(store_dir / f"rank{r}.out", "w")
            err = open(store_dir / f"rank{r}.err", "w")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, *args], stdout=out, stderr=err,
                env={**os.environ, **(env or {}), "RANK": str(r),
                     "WORLD_SIZE": str(n), "LOCAL_RANK": str(r),
                     "LOCAL_WORLD_SIZE": str(n), STORE_ENV: str(store)}))
        # a rank that fails leaves the others blocked in a collective: stop
        # waiting at the first failure
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        # a rank killed here (-9) was waiting on the first failed one
        tails = "\n".join(
            f"rank {r} exit {procs[r].returncode}:\n"
            + (store_dir / f"rank{r}.err").read_text()[-3000:] for r in bad)
        raise RuntimeError(f"ranks {bad} of {n} failed\n{tails}")
    return [(store_dir / f"rank{r}.out").read_text() for r in range(n)]
