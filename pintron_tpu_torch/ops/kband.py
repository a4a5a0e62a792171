"""Wrappers of the K-band CUDA kernel (``csrc/kband.cu``) and of the
full edit DP's ``edit_score_kernel`` (``csrc/rowmin.cu``).

Counterpart of the JAX package's ``banded_edit_distance_pallas``
(``ops/pallas_align.py``) and of the XLA ``batch_edit_distance_score``
(``ops/align.py``) the offload uses for the full-matrix problems and
STEP 4's edit stats.  Same arguments and results as the plain versions
in ``pintron_tpu_torch.ops.align``:

  * a batch on the CPU runs the plain version;
  * a batch on a CUDA device launches the kernel, or the call raises.
    There is no fallback from a failed build or launch to the plain
    version.

``LAUNCHES`` counts kernel launches per kernel, for these wrappers and
for those of ``pintron_tpu_torch.ops.traceback`` and ``.pwm``; it and
``KMAX`` live in ``ops/limits.py``, which a service client reads
without loading torch.
"""

from __future__ import annotations

import torch

from pintron_tpu_torch.ops import align
from pintron_tpu_torch.ops.limits import (  # noqa: F401 - kband's names
    KMAX, LAUNCHES, reset_launches)
from pintron_tpu_torch.ops.limits import count as _count


def edit_layout(max_rows: int) -> tuple:
    """The layout (R, G) of the edit-row kernels (``csrc/rowmin.cu``)
    for a row bucket: R pattern rows a lane and G lanes a problem.  The
    16-row bucket takes (1, 16), two problems a warp, and the 64-row
    bucket (2, 32), one pass of a warp (of the layouts timed at STEP 2's
    24 rowmin launches on an H100, measure_rowmin, PERF.md); longer
    patterns (16, 32), in passes of 512 rows through the row buffer."""
    if max_rows <= 16:
        return 1, 16
    if max_rows <= 64:
        return 2, 32
    return 16, 32


def edit_rowbuf(B: int, N: int, max_rows: int, layout, device):
    """The row buffer of the edit-row kernels, (B, N + 1) int32, which
    carries a pass's last row to the next; None when one pass of R x G
    rows covers the bucket (the kernel then reads none)."""
    R, G = layout
    if max_rows <= R * G:
        return None
    return torch.empty((B, N + 1), dtype=torch.int32, device=device)


def launch_edit_rows(key: str, seq1, len1, seq2, len2, outs, max_rows: int,
                     what: str, layout=None, lib=None) -> None:
    """Launch ``rowmin_kernel`` (key "rowmin", outs (vals, pos)) or
    ``edit_score_kernel`` ("edit_score", outs (out,)) on a checked batch;
    a batch off the card raises, naming ``what``.  ``layout`` (default
    ``edit_layout(max_rows)``) and ``lib`` (default this checkout's
    library) let measure_rowmin time other layouts and builds."""
    (B, N), dev = seq1.shape, seq1.device
    own, stream = _cuda_launch_context(dev, what)
    lib = lib or own
    layout = layout or edit_layout(max_rows)
    rowbuf = edit_rowbuf(B, N, max_rows, layout, dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"pintron_{key}")(
            seq1.data_ptr(), N, seq2.data_ptr(), seq2.shape[1],
            len1.data_ptr(), len2.data_ptr(),
            0 if rowbuf is None else rowbuf.data_ptr(),
            *(t.data_ptr() for t in outs), B, max_rows, *layout, stream)
    if err:
        raise RuntimeError(f"{key}_kernel launch failed: cudaError {err}")


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
    B = seq1.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    launch_edit_rows("edit_score", seq1, len1, seq2, len2, (out,), max_rows,
                     "K-band")
    _count("edit_score")
    return out
