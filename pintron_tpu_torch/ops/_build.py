"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, never at import, into ``build/kernels/`` at
the root of the checkout; the library's name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a current one is
reused.  Only the repository's own sources are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda):"
                       " the CUDA kernels cannot be built")


def _build() -> Path:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libpintron_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        BUILD_INFO.update(path=str(so), seconds=0.0, cached=True, log="")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in srcs if p.suffix == ".cu"]]
    t0 = time.monotonic()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent builder sees all or none
    BUILD_INFO.update(path=str(so), seconds=time.monotonic() - t0,
                      cached=False, log=res.stdout + res.stderr)
    return so


def load():
    """Build (if needed) and load the kernel library; idempotent and
    thread-safe.  Raises when nvcc is missing or the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pintron_kband.restype = I
        lib.pintron_kband.argtypes = [P, I, P, I, P, P, P, P, P, I, I, I, P]
        lib.pintron_edit_score.restype = I
        lib.pintron_edit_score.argtypes = [P, I, P, I, P, P, P, P, I, I, P]
        _LIB = lib
        return lib
