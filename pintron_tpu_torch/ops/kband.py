"""Wrappers of the K-band CUDA kernels (``csrc/kband.cu``).

Counterpart of the JAX package's ``banded_edit_distance_pallas``
(``ops/pallas_align.py``) and of the XLA ``batch_edit_distance_score``
(``ops/align.py``) the offload uses for the full-matrix problems.  Same
arguments and results as the plain versions in
``pintron_tpu_torch.ops.align``:

  * a batch on the CPU runs the plain version;
  * a batch on a CUDA device launches the kernel, or the call raises.
    There is no fallback from a failed build or launch to the plain
    version.

``LAUNCHES`` counts kernel launches per kernel, for these wrappers and
for those of ``pintron_tpu_torch.ops.traceback`` and ``.pwm``.
Launches come from the offload's executor thread and its dispatch
threads, so the count is taken under a lock.
"""

from __future__ import annotations

import threading

import torch

from pintron_tpu_torch.ops import align

# the widest band kband_kernel takes: W = 2*k_max+1 <= 33 cells a lane
# of 32 lanes (csrc/kband.cu), the reference's widest budget route
KMAX = 512

LAUNCHES = {"kband": 0, "edit_score": 0, "nw": 0, "gap": 0,
            "rowmin": 0, "pwm": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def _check_batch(seq1, len1, seq2, len2, band=None) -> None:
    dev = seq1.device
    named = [("seq1", seq1, torch.int8, 2), ("len1", len1, torch.int32, 1),
             ("seq2", seq2, torch.int8, 2), ("len2", len2, torch.int32, 1)]
    if band is not None:
        named.append(("band", band, torch.int32, 1))
    B = seq1.shape[0] if seq1.dim() == 2 else -1
    for name, t, dtype, ndim in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, seq1 on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                             f"{t.dim()}-d {t.dtype}")
        if t.shape[0] != B:
            raise ValueError(f"{name}: batch {t.shape[0]} != {B}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seq1.shape[1] < 1 or seq2.shape[1] < 1:
        raise ValueError("sequence widths must be >= 1")


def _cuda_launch_context(dev: torch.device, what: str = "K-band"):
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    from pintron_tpu_torch.ops import _build
    return _build.load(), torch.cuda.current_stream(dev).cuda_stream


def banded_edit_distance_cuda(seq1, len1, seq2, len2, band, *,
                              max_rows: int, k_max: int) -> torch.Tensor:
    """K-band edit distance; see ``align.banded_edit_distance``.  The
    kernel takes ``k_max`` <= ``KMAX``; a wider band raises, on the CPU
    too (the plain version never stands in for the kernel)."""
    _check_batch(seq1, len1, seq2, len2, band)
    if max_rows < 0 or k_max < 0:
        raise ValueError("max_rows and k_max must be >= 0")
    if k_max > KMAX:
        # on every device, so that a CPU run fails where the card would
        raise ValueError(f"kband_kernel: k_max {k_max} > {KMAX} (band "
                         f"width {2 * k_max + 1} > {2 * KMAX + 1})")
    dev = seq1.device
    if dev.type == "cpu":
        return align.banded_edit_distance(seq1, len1, seq2, len2, band,
                                          max_rows=max_rows, k_max=k_max)
    B = seq1.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib, stream = _cuda_launch_context(dev)
    with torch.cuda.device(dev):
        err = lib.pintron_kband(
            seq1.data_ptr(), seq1.shape[1], seq2.data_ptr(), seq2.shape[1],
            len1.data_ptr(), len2.data_ptr(), band.data_ptr(),
            out.data_ptr(), B, max_rows, k_max, stream)
    if err:
        raise RuntimeError(f"kband_kernel launch failed: cudaError {err}")
    _count("kband")
    return out


def batch_edit_distance_score_cuda(seq1, len1, seq2, len2, *,
                                   max_rows: int) -> torch.Tensor:
    """Full edit distance, final cell; see
    ``align.batch_edit_distance_score``."""
    _check_batch(seq1, len1, seq2, len2)
    if max_rows < 0:
        raise ValueError("max_rows must be >= 0")
    dev = seq1.device
    if dev.type == "cpu":
        return align.batch_edit_distance_score(seq1, len1, seq2, len2,
                                               max_rows=max_rows)
    B, N = seq1.shape
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib, stream = _cuda_launch_context(dev)
    dp_rows = torch.empty((N + 1, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pintron_edit_score(
            seq1.data_ptr(), N, seq2.data_ptr(), seq2.shape[1],
            len1.data_ptr(), len2.data_ptr(), dp_rows.data_ptr(),
            out.data_ptr(), B, max_rows, stream)
    if err:
        raise RuntimeError(
            f"edit_score_kernel launch failed: cudaError {err}")
    _count("edit_score")
    return out
