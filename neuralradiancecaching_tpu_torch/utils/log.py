"""Console logger -- the en::Log equivalent (src/Log.cpp:6-27: Info/Warn/
Error to stdout, Error throws)."""

from __future__ import annotations

import sys
import time


class Log:
    _t0 = time.perf_counter()
    verbose = True

    @classmethod
    def _stamp(cls) -> str:
        return f"[{time.perf_counter() - cls._t0:8.2f}s]"

    @classmethod
    def info(cls, msg: str) -> None:
        if cls.verbose:
            print(f"{cls._stamp()} INFO  {msg}")

    @classmethod
    def warn(cls, msg: str) -> None:
        print(f"{cls._stamp()} WARN  {msg}", file=sys.stderr)

    @classmethod
    def error(cls, msg: str) -> None:
        """Like the reference's Log::Error, raises (src/Log.cpp:22-26)."""
        print(f"{cls._stamp()} ERROR {msg}", file=sys.stderr)
        raise RuntimeError(msg)
