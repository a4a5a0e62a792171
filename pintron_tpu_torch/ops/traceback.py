"""Wrappers of the warp-per-problem CUDA kernels of the NW, gap and
refine-borders families (``csrc/nw.cu``, ``csrc/gap.cu``,
``csrc/rowmin.cu``).

Counterparts of the JAX package's XLA ops ``batch_nw_traceback``,
``batch_gap_traceback`` and ``batch_edit_rowmin`` (``ops/align.py``).
Same arguments and results as the plain versions in
``pintron_tpu_torch.ops.align``:

  * a batch on the CPU runs the plain version;
  * a batch on a CUDA device launches the kernel, or the call raises.
    There is no fallback from a failed build or launch to the plain
    version.

Launches are counted in ``pintron_tpu_torch.ops.kband.LAUNCHES``; the
widest row the kernels take, ``MAX_WIDTH``, is ``ops/limits.py``'s.
"""

from __future__ import annotations

import torch

from pintron_tpu_torch.ops import align
from pintron_tpu_torch.ops.kband import (_check_batch, _count,
                                         _cuda_launch_context,
                                         launch_edit_rows)
from pintron_tpu_torch.ops.limits import MAX_WIDTH


def _check_width(name: str, width: int) -> None:
    if width > MAX_WIDTH:
        raise ValueError(f"{name}: {width} columns > {MAX_WIDTH}, the widest "
                         "row the kernels take")


# nw_kernel keeps the directions of a lane's strip of NW_ROWS est rows at
# one gen column in one 32-bit word (csrc/nw.cu)
NW_ROWS = 16


def nw_scratch(B: int, max_n: int, max_m: int, device):
    """nw_kernel's two int32 scratch buffers: the 2-bit directions, one
    word a strip of NW_ROWS rows and a column, and the row buffer that
    carries a pass's last row to the next."""
    return (torch.empty((B, -(-max_n // NW_ROWS), max_m), dtype=torch.int32,
                        device=device),
            torch.empty((B, max_m + 1), dtype=torch.int32, device=device))


def gap_rows(max_n: int) -> int:
    """The est rows a lane of gap_kernel holds (csrc/gap.cu), from the
    est bucket: 2 while the bucket's rows fit one pass of 32 lanes, so
    that every lane of a 60-row window holds rows, else 16."""
    return 2 if max_n <= 64 else 16


def gap_scratch(B: int, max_n: int, max_m: int, device, rows: int):
    """gap_kernel's scratch for ``rows`` (R) est rows a lane: the
    direction planes, (B, passes, max_m, lanes a pass) words, at R = 2
    one 16-bit word holding the 5 bits of each row and an empty second
    plane, at R = 16 a 64-bit word of L's and R's bits and a 16-bit word
    of G's; and the row buffer that carries a pass's last L and R rows to
    the next, empty when one pass of 32R rows covers the bucket."""
    shape = (B, -(-max_n // (32 * rows)), max_m,
             min(32, -(-max_n // rows)))
    joint = rows == 2
    return (torch.empty(shape, dtype=torch.int16 if joint else torch.int64,
                        device=device),
            torch.empty((0,) if joint else shape, dtype=torch.int16,
                        device=device),
            torch.empty((B, 2, max_m + 1) if max_n > 32 * rows else (0,),
                        dtype=torch.int32, device=device))


def _traceback_cuda(key: str, est, elen, gen, glen, max_n: int,
                    max_m: int):
    """Launch ``{key}_kernel`` (``pintron_{key}`` in the library)."""
    align._check_widths(est, gen, max_n, max_m)
    _check_width(key, max_m)
    dev = est.device
    B = est.shape[0]
    head = torch.empty(B, dtype=torch.int32, device=dev)
    ops = torch.empty((B, max_n + max_m), dtype=torch.int8, device=dev)
    nsteps = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return head, ops, nsteps
    lib, stream = _cuda_launch_context(dev, key)
    if key == "nw":
        scratch, extra = nw_scratch(B, max_n, max_m, dev), ()
    else:
        rows = gap_rows(max_n)
        scratch, extra = gap_scratch(B, max_n, max_m, dev, rows), (rows,)
    with torch.cuda.device(dev):
        err = getattr(lib, f"pintron_{key}")(
            est.data_ptr(), max_n, gen.data_ptr(), max_m, elen.data_ptr(),
            glen.data_ptr(), *(t.data_ptr() for t in scratch),
            head.data_ptr(), ops.data_ptr(), nsteps.data_ptr(), *extra, B,
            stream)
    if err:
        raise RuntimeError(f"{key}_kernel launch failed: cudaError {err}")
    _count(key)
    return head, ops, nsteps


def batch_nw_traceback_cuda(est, elen, gen, glen, *, max_n: int,
                            max_m: int):
    """NW with the traceback; see ``align.batch_nw_traceback``.
    Returns (score, ops, nsteps)."""
    _check_batch(est, elen, gen, glen)
    if est.device.type == "cpu":
        return align.batch_nw_traceback(est, elen, gen, glen, max_n=max_n,
                                        max_m=max_m)
    return _traceback_cuda("nw", est, elen, gen, glen, max_n, max_m)


def batch_gap_traceback_cuda(est, elen, gen, glen, *, max_n: int,
                             max_m: int):
    """Gap alignment with the traceback; see
    ``align.batch_gap_traceback``.  Returns (sm, ops, nsteps)."""
    _check_batch(est, elen, gen, glen)
    if est.device.type == "cpu":
        return align.batch_gap_traceback(est, elen, gen, glen, max_n=max_n,
                                         max_m=max_m)
    return _traceback_cuda("gap", est, elen, gen, glen, max_n, max_m)


def batch_edit_rowmin_cuda(seq1, len1, seq2, len2, *, max_rows: int):
    """Per-row minima and first argmins of the edit DP; see
    ``align.batch_edit_rowmin``.  Returns (vals, pos)."""
    _check_batch(seq1, len1, seq2, len2)
    if max_rows < 0:
        raise ValueError("max_rows must be >= 0")
    dev = seq1.device
    if dev.type == "cpu":
        return align.batch_edit_rowmin(seq1, len1, seq2, len2,
                                       max_rows=max_rows)
    B, N = seq1.shape
    _check_width("rowmin", N)
    vals = torch.empty((B, max_rows + 1), dtype=torch.int32, device=dev)
    pos = torch.empty_like(vals)
    if B == 0:
        return vals, pos
    launch_edit_rows("rowmin", seq1, len1, seq2, len2, (vals, pos),
                     max_rows, "rowmin")
    _count("rowmin")
    return vals, pos
