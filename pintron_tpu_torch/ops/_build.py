"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into one
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    tag = f"{so.stem}.tmp{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.monotonic()
    objs, jobs = [], []
    for p in srcs:
        if p.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{p.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(p)]
        objs.append(obj)
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    tmp = so.with_name(f"{tag}.so")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    BUILD_INFO.update(path=str(so), seconds=time.monotonic() - t0,
                      cached=False, log="".join(log))
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
        lib.pintron_kband.argtypes = [P, I, P, I, P, P, P, P, I, I, I, P]
        lib.pintron_edit_score.restype = I
        lib.pintron_edit_score.argtypes = [P, I, P, I, P, P, P, P, I, I, I,
                                           I, P]
        lib.pintron_nw.restype = I
        lib.pintron_nw.argtypes = [P, I, P, I, P, P, P, P, P, P, P, I, P]
        lib.pintron_gap.restype = I
        lib.pintron_gap.argtypes = [P, I, P, I, P, P, P, P, P, P, P, P, I, I,
                                     P]
        lib.pintron_rowmin.restype = I
        lib.pintron_rowmin.argtypes = [P, I, P, I, P, P, P, P, P, I, I, I,
                                       I, P]
        lib.pintron_pwm.restype = I
        lib.pintron_pwm.argtypes = [P, I, P, ctypes.c_float, P, I, P]
        _LIB = lib
        return lib
