"""Crash-safe file commit shared by the prefix cache's disk tier and the
flight recorder. Only ``atomic_write`` is ported; the kernel cache
itself has no counterpart in the port (CUDA kernels are built by
``ops/_build.py``)."""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

__all__ = ["atomic_write"]


def atomic_write(path: Path, text: str) -> None:
    """tmp + fsync + rename + dir-fsync commit: rename alone only
    orders the DIRECTORY entry — after a host crash the kernel may
    surface the committed name over zero-length data. fsync the file
    before the rename and the parent directory after it, so a crash
    leaves either the old state or the complete new one."""
    path = Path(path)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
    except OSError:
        return      # platform without O_RDONLY dir opens: rename stands
    try:
        os.fsync(dfd)
    except OSError:
        pass        # the durability fsync is best-effort on exotic fs
    finally:
        os.close(dfd)
