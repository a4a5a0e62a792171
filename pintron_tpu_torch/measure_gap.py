"""``gap_kernel`` at the launch shapes of the main path: seeded batches
with the batch sizes, (est, gen) length buckets and longest, median and
shortest lengths that STEP 2 gives the kernel on TP53 and issue-13 (8
launches, all in the (64, 256) bucket), each held against the plain
version on every problem and timed with CUDA events.

    python -m pintron_tpu_torch.measure_gap [--old LABEL=GAP_CU ...]
        [--alt LABEL=GAP_CU ...] [--out FILE]

``--old`` builds another version of ``csrc/gap.cu`` with the C
interface of the block-per-problem kernel (an int8 (B, N, M) direction
scratch), ``--alt`` one with this checkout's (two direction planes, a
row buffer and the rows a lane); each is checked against the plain
version on its start matrices (the record says whether its ops agree
too: a build with the traceback walk compiled out gives only the fill's
time) and timed in turns with this checkout's kernel (old, new, new,
old), so that they are compared in one process on one card: each launch
back to back (the wrapper's dispatch included) and on the card alone
(``measure_kband.device_ms``).  Writes ``chiprun_out/gap_measure.json``
by default and prints one line per shape.  ``chip_smoke.py`` takes the
shapes, the batch maker and the bound from here.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from pintron_tpu_torch.measure_kband import (HBM_BYTES_PER_S,
                                             INT32_OPS_PER_S, build_other)
from pintron_tpu_torch.measure_nw import _lengths, measure_main

# (locus, B, est bucket N, gen bucket M, longest est, longest gen,
#  median est, median gen, shortest est, shortest gen): the 8 gap
# launches of STEP 2 with a fresh memo (PINTRON_FRESH_MEMO=1), recorded
# from the offload's groups on the two loci.  Every refine-intron
# window pair is an est window of at most 60 bases and its gen window
# 140 bases longer.
MAIN_PATH_GAP_SHAPES = (
    ("TP53", 119, 64, 256, 60, 200, 60, 200, 50, 190),
    ("TP53", 384, 64, 256, 60, 200, 60, 200, 38, 178),
    ("TP53", 729, 64, 256, 60, 200, 60, 200, 38, 177),
    ("TP53", 788, 64, 256, 60, 200, 60, 200, 45, 185),
    ("issue-13", 686, 64, 256, 60, 200, 60, 200, 30, 170),
    ("issue-13", 363, 64, 256, 60, 200, 60, 200, 38, 178),
    ("issue-13", 998, 64, 256, 60, 200, 60, 200, 45, 185),
    ("issue-13", 1334, 64, 256, 60, 200, 60, 200, 40, 179),
)

# integer operations a cell of each of the three matrices: the match
# test with its wildcards, the candidates, their maximum and the
# direction's tests
OPS_PER_CELL = 10


def main_path_gap_batch(shape, seed: int):
    """A seeded batch of one main-path gap launch.  The est windows are
    random bases with a few N; each gen window is its est window split
    at one point with an intron of random bases inserted there, with 3%
    point mutations, cut or extended with random bases to its length,
    as a refine-intron window is.  Returns (est, elen, gen, glen, N,
    M)."""
    _locus, B, N, M, le, lg, me, mg, se, sg = shape
    rng = np.random.default_rng(seed)
    order = rng.permutation(B)
    elen = _lengths(B, N, le, me, se)[order]
    glen = _lengths(B, M, lg, mg, sg)[order]
    alpha = np.frombuffer(b"ACGT", dtype=np.int8)
    est = alpha[rng.integers(0, 4, (B, N))]
    est[rng.random((B, N)) < 0.002] = ord("N")
    gen = alpha[rng.integers(0, 4, (B, M))]
    for b in range(B):
        n, m = int(elen[b]), int(glen[b])
        cut = int(rng.integers(0, n + 1))
        intron = alpha[rng.integers(0, 4, max(m - n, 0))]
        row = np.concatenate([est[b, :cut], intron, est[b, cut:n]])[:m]
        hits = rng.random(len(row)) < 0.03
        row[hits] = alpha[rng.integers(0, 4, int(hits.sum()))]
        gen[b, :len(row)] = row
    return (est, elen.astype(np.int32), gen, glen.astype(np.int32), N, M)


def gap_bound(elen, glen, clock_hz: float):
    """The least time of one launch: (bound ms, "bytes" or "operations",
    chain floor ms).  Bytes: both windows and the lengths read once, the
    ops (at most elen + glen a problem), the start matrix and the step
    count written once.  Operations: OPS_PER_CELL a cell of the three
    (elen + 1) x (glen + 1) matrices, over the INT32 peak.  The chain
    floor: the longest problem's chain, elen rows, each at least
    ceil(log2(glen + 1)) + 2 dependent integer operations (the
    candidates' maximum, then a prefix-max over the row), then elen +
    glen traceback steps, all of 4 cycles at the card's highest SM
    clock."""
    e = np.asarray(elen, dtype=np.int64)
    g = np.asarray(glen, dtype=np.int64)
    nbytes = 2 * int((e + g).sum()) + 16 * len(e)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (OPS_PER_CELL * 3 * int(((e + 1) * (g + 1)).sum())
             / INT32_OPS_PER_S * 1e3)
    chain = max(((int(a) * (int(np.ceil(np.log2(max(int(b) + 1, 2)))) + 2)
                  + int(a) + int(b)) * 4 / clock_hz * 1e3
                 for a, b in zip(e, g)), default=0.0)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", chain
    return t_ops, "operations", chain


def build_warp_kernel(src: str, label: str):
    """Build another version of gap.cu with this checkout's C interface
    (two direction planes, a row buffer and the rows a lane) and return
    a launcher."""
    from pintron_tpu_torch.ops.traceback import gap_rows, gap_scratch
    lib = build_other(src, f"gap-{label}")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pintron_gap.restype = I
    lib.pintron_gap.argtypes = [P, I, P, I, P, P, P, P, P, P, P, P, I, I, P]

    def launch(est, elen, gen, glen, *, max_n, max_m):
        B, dev = est.shape[0], est.device
        sm = torch.empty(B, dtype=torch.int32, device=dev)
        ops = torch.empty((B, max_n + max_m), dtype=torch.int8, device=dev)
        nsteps = torch.empty(B, dtype=torch.int32, device=dev)
        rows = gap_rows(max_n)
        scratch = gap_scratch(B, max_n, max_m, dev, rows)
        err = lib.pintron_gap(
            est.data_ptr(), max_n, gen.data_ptr(), max_m, elen.data_ptr(),
            glen.data_ptr(), *(t.data_ptr() for t in scratch),
            sm.data_ptr(), ops.data_ptr(), nsteps.data_ptr(), rows, B,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{label} gap_kernel launch failed: {err}")
        return sm, ops, nsteps
    return launch


def main(argv=None) -> int:
    from pintron_tpu_torch.ops import align, traceback
    return measure_main(
        argv, key="gap", doc=__doc__, shapes=MAIN_PATH_GAP_SHAPES,
        make_batch=main_path_gap_batch, bound_fn=gap_bound,
        kernel=traceback.batch_gap_traceback_cuda,
        plain=align.batch_gap_traceback, build_alt=build_warp_kernel)


if __name__ == "__main__":
    sys.exit(main())
