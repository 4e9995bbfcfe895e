"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``<checkout>/build/cuda/`` (listed in ``.gitignore``)
under a name keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads in milliseconds. Nothing is built at import time:
the first call to :func:`load` builds; :func:`build_all` runs one
``nvcc`` per source, all at once.

A build failure raises ``RuntimeError`` with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load", "build", "build_all",
           "aligned16", "build_log", "stream_call"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took in this process, 0.0 when loaded from
# an earlier build; the compiler's output)
_logs: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels build on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source
    hash exists; returns its path."""
    out = _target(name)
    if out.is_file():
        _logs.setdefault(name, (0.0, ""))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(exit {res.returncode}):\n{log}")
    os.replace(tmp, out)    # a concurrent builder's identical file wins
    _logs[name] = (dt, log)
    return out


def build_all(names: Iterable[str]) -> List[Path]:
    """:func:`build` every name, one ``nvcc`` process per source, all
    started together; raises the first build failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return list(ex.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def aligned16(*ts):
    """Each tensor contiguous, and copied where its base is not 16-byte
    aligned: the kernels read rows 16 bytes a copy (cp.async)."""
    out = []
    for t in ts:
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def stream_call(fn, dev, *args):
    """``fn(*args, stream)`` with ``dev``'s current CUDA stream (a C
    launcher taking the stream last)."""
    import torch
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def build_log(name: str) -> Tuple[float, str]:
    """(build seconds in this process, compiler output) of a library
    :func:`load` has built or found."""
    return _logs.get(name, (0.0, ""))
