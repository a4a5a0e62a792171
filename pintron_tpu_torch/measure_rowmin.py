"""``rowmin_kernel`` and ``edit_score_kernel`` at the launch shapes of
the main path: seeded batches with the batch sizes, (text, pattern)
length buckets and longest, median and shortest lengths that STEP 2
gives ``rowmin_kernel`` on TP53 and issue-13 (24 launches) and STEP 4
gives ``edit_score_kernel`` (2 launches), then ``edit_score_kernel`` at
(256, 16, 16) and on the four 9 kb exons of the K-band budget checks at
full length.  Every launch is held against the plain version (rowmin on
its live rows 0..len2, edit_score on every problem) and timed with CUDA
events, back to back (the wrapper's dispatch included) and on the card
alone (``measure_kband.device_ms``).

    python -m pintron_tpu_torch.measure_rowmin [--old LABEL=ROWMIN_CU]
        [--old-edit LABEL=KBAND_CU] [--alt LABEL=ROWMIN_CU]
        [--layout R,G] [--reps N] [--out FILE]

``--old`` builds another ``rowmin.cu`` with the block-per-problem
kernel's C interface (no row buffer; its ``rowscan.cuh`` beside it),
``--old-edit`` another ``kband.cu`` whose ``pintron_edit_score`` takes
the one-thread-per-problem kernel's (N + 1, B) int32 row scratch,
``--alt`` another ``rowmin.cu`` with this checkout's C interface (both
kernels), and ``--layout`` runs this checkout's kernels at another of
the library's layouts of R rows a lane and G lanes a problem (``ops/
kband.py`` edit_layout); each is checked like
this checkout's kernel and timed in turns with it (old, new, new, old),
so that they are compared in one process on one card.
Writes ``chiprun_out/rowmin_measure.json`` by default and prints one
line per launch and the sums.  ``chip_smoke.py`` takes the shapes, the
batch makers and the bounds from here.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pintron_tpu_torch.measure_kband import (HBM_BYTES_PER_S,
                                             INT32_OPS_PER_S, build_other,
                                             cuda_ms, device_ms,
                                             max_sm_clock_hz,
                                             wide_budget_batches)
from pintron_tpu_torch.measure_nw import _lengths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (locus, B, text bucket N, pattern bucket M, text longest, median,
#  shortest, pattern longest, median, shortest): the 24 rowmin launches
# of STEP 2 with a fresh memo (PINTRON_FRESH_MEMO=1), recorded from a
# wrapper around offload.batch_edit_rowmin_cuda on a device="cpu" run of
# run_est_fact on the two loci.  A problem is a (gen window, est piece)
# pair, run forward and reversed (stages/est_fact.py, the refine-borders
# phase); offload._buckets groups the problems of a chunk by
# power-of-four N and M, and each locus runs the phase in four chunks of
# three buckets.  The median is the upper middle length.  No pattern is
# longer than 30 rows, no text wider than 60 columns.
MAIN_PATH_RB_SHAPES = (
    ("TP53", 10, 16, 16, 14, 2, 2, 7, 1, 1),
    ("TP53", 16, 64, 16, 30, 24, 18, 15, 12, 9),
    ("TP53", 4, 64, 64, 56, 56, 40, 28, 28, 20),
    ("TP53", 24, 16, 16, 16, 16, 2, 8, 8, 1),
    ("TP53", 6, 64, 16, 22, 20, 20, 11, 10, 10),
    ("TP53", 10, 64, 64, 54, 44, 44, 27, 22, 22),
    ("TP53", 98, 16, 16, 16, 10, 2, 8, 5, 1),
    ("TP53", 34, 64, 16, 32, 26, 18, 16, 13, 9),
    ("TP53", 14, 64, 64, 48, 48, 31, 28, 24, 21),
    ("TP53", 54, 16, 16, 16, 10, 2, 8, 5, 1),
    ("TP53", 28, 64, 16, 30, 24, 18, 15, 12, 9),
    ("TP53", 6, 64, 64, 52, 46, 38, 26, 23, 19),
    ("issue-13", 762, 16, 16, 16, 10, 2, 8, 5, 1),
    ("issue-13", 410, 64, 16, 32, 26, 18, 16, 13, 9),
    ("issue-13", 612, 64, 64, 58, 56, 31, 30, 28, 18),
    ("issue-13", 1458, 16, 16, 16, 10, 2, 8, 5, 1),
    ("issue-13", 1206, 64, 16, 32, 28, 18, 16, 14, 9),
    ("issue-13", 1408, 64, 64, 58, 46, 34, 29, 23, 17),
    ("issue-13", 114, 16, 16, 16, 10, 2, 8, 5, 1),
    ("issue-13", 56, 64, 16, 32, 24, 18, 16, 12, 9),
    ("issue-13", 56, 64, 64, 60, 52, 34, 30, 26, 17),
    ("issue-13", 108, 16, 16, 16, 10, 2, 8, 5, 1),
    ("issue-13", 34, 64, 16, 26, 22, 18, 13, 11, 9),
    ("issue-13", 2, 64, 64, 36, 36, 36, 18, 18, 18),
)

# (locus, B padded, live, N, M, text longest, median, shortest, pattern
#  longest, median, shortest): the one edit_score launch a locus of
# STEP 4's edit stats (offload.eval_edit_batch from
# stages/intron_agreement.py), recorded the same way on a device="cpu"
# run of run_intron_agreement: the unequal window pairs, both of at most
# 15 bases, padded to a power of two of at least 64 problems
MAIN_PATH_EDIT_SHAPES = (
    ("TP53", 256, 141, 16, 16, 15, 15, 15, 15, 15, 15),
    ("issue-13", 256, 222, 16, 16, 15, 15, 15, 15, 15, 10),
)

# integer operations a cell: the mismatch test, the diagonal's add, the
# minimum of the three candidates with its add, and (rowmin) the row
# minimum's compare and two selects
RB_OPS_PER_CELL = 8
EDIT_OPS_PER_CELL = 6


def edit_batch(B: int, live: int, N: int, M: int, text, pattern,
               seed: int):
    """A seeded batch of ``live`` (text, pattern) problems padded with
    empty ones to ``B``: lengths from the quantiles (longest, median,
    shortest) of ``text`` and ``pattern``, paired in order; each text is
    its pattern with 3% point mutations at a random offset among random
    bases (cut to the text's length).  Returns (seq1, len1, seq2, len2)
    as the offload encodes them: seq1 the texts (B, N), seq2 the
    patterns (B, M)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(live)
    len1 = np.zeros(B, dtype=np.int32)
    len2 = np.zeros(B, dtype=np.int32)
    len1[:live] = _lengths(live, N, *text)[order]
    len2[:live] = _lengths(live, M, *pattern)[order]
    alpha = np.frombuffer(b"ACGT", dtype=np.int8)
    s1 = np.zeros((B, N), dtype=np.int8)
    s2 = np.zeros((B, M), dtype=np.int8)
    for b in range(live):
        n, m = int(len1[b]), int(len2[b])
        p = alpha[rng.integers(0, 4, m)]
        t = alpha[rng.integers(0, 4, n)]
        row = p.copy()
        hits = rng.random(m) < 0.03
        row[hits] = alpha[rng.integers(0, 4, int(hits.sum()))]
        at = int(rng.integers(0, max(n - m, 0) + 1))
        t[at:at + m] = row[:n - at]
        s1[b, :n], s2[b, :m] = t, p
    return s1, len1, s2, len2


def main_path_rb_batch(shape, seed: int):
    """A seeded batch of one main-path rowmin launch (every problem
    live).  Returns (seq1, len1, seq2, len2, max_rows)."""
    _locus, B, N, M, *lens = shape
    return (*edit_batch(B, B, N, M, lens[:3], lens[3:], seed), M)


def main_path_edit_batch(shape, seed: int):
    """A seeded batch of one STEP 4 edit_score launch.  Returns (seq1,
    len1, seq2, len2, max_rows)."""
    _locus, B, live, N, M, *lens = shape
    return (*edit_batch(B, live, N, M, lens[:3], lens[3:], seed), M)


def row_chain_ms(rows: int, width: int, clock_hz: float) -> float:
    """The dependent chain of a row-serial DP: ``rows`` rows, each at
    least ceil(log2 width) + 2 dependent integer operations (the
    candidates' minimum, then a prefix-min of depth log2 width) of 4
    cycles at the card's highest SM clock."""
    width = max(int(width), 2)
    return rows * (int(np.ceil(np.log2(width))) + 2) * 4 / clock_hz * 1e3


def _bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rb_bound(len1, len2, clock_hz: float):
    """The least time of one rowmin launch: (bound ms, "bytes" or
    "operations", chain floor ms).  Bytes: text, pattern and lengths
    read once, the (value, column) int32 pairs of rows 0..len2 written
    once.  Operations: RB_OPS_PER_CELL a cell of the (len1 + 1) x
    (len2 + 1) DP over the INT32 peak.  The chain floor: the longest
    chain, len2 rows of len1 + 1 columns (row_chain_ms)."""
    t = np.asarray(len1, dtype=np.int64)
    p = np.asarray(len2, dtype=np.int64)
    b_ms, by = _bound(int((t + p).sum()) + 8 * len(t) + 8 * int((p + 1).sum()),
                      RB_OPS_PER_CELL * int(((t + 1) * (p + 1)).sum()))
    chain = max((row_chain_ms(int(b), int(a) + 1, clock_hz)
                 for a, b in zip(t, p)), default=0.0)
    return b_ms, by, chain


def edit_bound(len1, len2, clock_hz: float):
    """The least time of one edit_score launch, as rb_bound: both
    sequences and the lengths read once, the distance written once;
    EDIT_OPS_PER_CELL a cell of the len1 x len2 DP; len2 rows of len1 + 1
    columns."""
    t = np.asarray(len1, dtype=np.int64)
    p = np.asarray(len2, dtype=np.int64)
    b_ms, by = _bound(int((t + p).sum()) + 12 * len(t),
                      EDIT_OPS_PER_CELL * int((t * p).sum()))
    chain = max((row_chain_ms(int(b), int(a) + 1, clock_hz)
                 for a, b in zip(t, p)), default=0.0)
    return b_ms, by, chain


def nine_kb_exons():
    """The four 9 kb exons of chip_smoke.py's wide budgets (their
    K-band checks at budgets of about 270) as full-matrix edit_score
    problems.  Returns (seq1, len1, seq2, len2, max_rows)."""
    s1, l1, s2, l2, _band, M = wide_budget_batches()[1]
    return s1, l1, s2, l2, M


def rowmin_live(len2, max_rows: int):
    """The rows a rowmin result defines: 0..len2 of each problem."""
    return (torch.arange(max_rows + 1, device=len2.device)[None, :]
            <= len2[:, None].long())


def build_old_rowmin(src: str, label: str):
    """Build a ``rowmin.cu`` with the block-per-problem kernel's C
    interface and return a launcher of it."""
    lib = build_other(src, f"rowmin-{label}")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pintron_rowmin.restype = I
    lib.pintron_rowmin.argtypes = [P, I, P, I, P, P, P, P, I, I, P]

    def launch(s1, l1, s2, l2, *, max_rows):
        B, dev = s1.shape[0], s1.device
        vals = torch.empty((B, max_rows + 1), dtype=torch.int32, device=dev)
        pos = torch.empty_like(vals)
        err = lib.pintron_rowmin(
            s1.data_ptr(), s1.shape[1], s2.data_ptr(), s2.shape[1],
            l1.data_ptr(), l2.data_ptr(), vals.data_ptr(), pos.data_ptr(),
            B, max_rows, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{label} rowmin_kernel launch failed: {err}")
        return vals, pos
    return launch


def build_old_edit(src: str, label: str):
    """Build a ``kband.cu`` whose ``pintron_edit_score`` takes the
    one-thread-per-problem kernel's (N + 1, B) row scratch and return a
    launcher of it."""
    lib = build_other(src, f"edit-{label}")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pintron_edit_score.restype = I
    lib.pintron_edit_score.argtypes = [P, I, P, I, P, P, P, P, I, I, P]

    def launch(s1, l1, s2, l2, *, max_rows):
        (B, N), dev = s1.shape, s1.device
        out = torch.empty(B, dtype=torch.int32, device=dev)
        rows = torch.empty((N + 1, B), dtype=torch.int32, device=dev)
        err = lib.pintron_edit_score(
            s1.data_ptr(), N, s2.data_ptr(), s2.shape[1], l1.data_ptr(),
            l2.data_ptr(), rows.data_ptr(), out.data_ptr(), B, max_rows,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{label} edit_score_kernel launch failed: "
                               f"{err}")
        return out
    return launch


def editrow_launchers(layout=None, lib=None):
    """rowmin and edit_score launchers of this checkout's C interface
    (``lib``, or this checkout's library), at ``layout`` (R, G) or the
    wrappers'.  They count no launch."""
    from pintron_tpu_torch.ops import kband

    def rowmin(s1, l1, s2, l2, *, max_rows):
        vals = torch.empty((s1.shape[0], max_rows + 1), dtype=torch.int32,
                           device=s1.device)
        pos = torch.empty_like(vals)
        kband.launch_edit_rows("rowmin", s1, l1, s2, l2, (vals, pos),
                               max_rows, "rowmin", layout, lib)
        return vals, pos

    def edit(s1, l1, s2, l2, *, max_rows):
        out = torch.empty(s1.shape[0], dtype=torch.int32, device=s1.device)
        kband.launch_edit_rows("edit_score", s1, l1, s2, l2, (out,),
                               max_rows, "K-band", layout, lib)
        return out
    return rowmin, edit


def build_alt(src: str, label: str):
    """Build another ``rowmin.cu`` with this checkout's C interface and
    return its (rowmin, edit_score) launchers."""
    lib = build_other(src, f"editrow-{label}")
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.pintron_rowmin, lib.pintron_edit_score):
        fn.restype = I
    lib.pintron_rowmin.argtypes = [P, I, P, I, P, P, P, P, P, I, I, I, I, P]
    lib.pintron_edit_score.argtypes = [P, I, P, I, P, P, P, P, I, I, I, I,
                                       P]
    return editrow_launchers(lib=lib)


def _time_in_turns(rec, new, olds, reps: int) -> None:
    """Time this checkout's kernel and the old builds in turns (old,
    new, new, old): each call back to back (``{label}_ms``) and on the
    card alone (``{label}_dev_ms``), the best of the turns."""
    order = olds + [("new", new), ("new", new)] + olds[::-1]
    for label, fn in order:
        rec.setdefault(f"{label}_ms", []).append(cuda_ms(fn, reps))
        rec.setdefault(f"{label}_dev_ms", []).append(device_ms(fn, reps))


def _measure(name, batches, kernel, plain, olds, dev, clock, gpu, reps,
             bound_fn, live_fn=None):
    """Check and time one kernel on every batch on ``dev``; returns
    (records, sums)."""
    from pintron_tpu_torch.ops.align import from_numpy_batch
    rows, sums = [], {}
    for label, (s1, l1, s2, l2, M) in batches:
        t = from_numpy_batch(s1, l1, s2, l2, device=dev)
        kw = dict(max_rows=M)
        want = plain(*t, **kw)
        live = live_fn(t[3], M) if live_fn else None

        def check(got, who):
            torch.cuda.synchronize()
            for g, w in zip(got if live_fn else (got,),
                            want if live_fn else (want,)):
                if live is not None:
                    g, w = g[live], w[live]
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} {label}: {who} != plain on "
                                         f"{int((g != w).sum())} entries")

        check(kernel(*t, **kw), "kernel")
        timed = []
        for olabel, launch in olds:
            check(launch(*t, **kw), olabel)
            timed.append((olabel, lambda launch=launch: launch(*t, **kw)))
        b_ms, by, chain = bound_fn(l1, l2, clock)
        rec = {"launch": label, "B": int(s1.shape[0]), "N": int(s1.shape[1]),
               "M": int(M), "text_max": int(l1.max()),
               "pattern_max": int(l2.max()), "bound_ms": b_ms,
               "bound_by": by, "chain_floor_ms": chain, "gpu": gpu}
        # a call of seconds (the old kernel on the 9 kb exons) once a turn
        _time_in_turns(rec, lambda: kernel(*t, **kw), timed,
                       1 if s1.shape[1] > 4096 else reps)
        rec["plain_ms"] = cuda_ms(lambda: plain(*t, **kw), 1)
        for k, v in rec.items():
            if k.endswith("_ms"):
                sums[k] = sums.get(k, 0.0) + (min(v) if isinstance(v, list)
                                              else v)
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    return rows, sums


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", action="append", default=[],
                   metavar="LABEL=ROWMIN_CU",
                   help="a rowmin.cu with the block-per-problem kernel's C "
                        "interface, timed beside this checkout's kernel")
    p.add_argument("--old-edit", action="append", default=[],
                   metavar="LABEL=KBAND_CU",
                   help="a kband.cu with the one-thread-per-problem "
                        "edit_score_kernel, timed beside this checkout's")
    p.add_argument("--alt", action="append", default=[],
                   metavar="LABEL=ROWMIN_CU",
                   help="a rowmin.cu with this checkout's C interface, "
                        "timed beside this checkout's kernels")
    p.add_argument("--layout", action="append", default=[], metavar="R,G",
                   help="this checkout's kernels at R rows a lane and G "
                        "lanes a problem, timed beside the wrappers' layout")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "rowmin_measure.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_rowmin: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from pintron_tpu_torch.ops import _build, align, kband, traceback
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    clock = max_sm_clock_hz()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    print(f"built in {time.perf_counter() - t0:.2f} s  [{gpu}]", flush=True)
    if _build.BUILD_INFO["log"]:
        print(_build.BUILD_INFO["log"].strip(), flush=True)
    olds = {"rowmin": [], "edit": []}
    for key, specs, build in (("rowmin", args.old, build_old_rowmin),
                              ("edit", args.old_edit, build_old_edit)):
        for spec in specs:
            label, src = spec.split("=", 1)
            olds[key].append((label, build(src, label)))
    alts = [(spec.split("=", 1)[0], build_alt(*spec.split("=", 1)[::-1]))
            for spec in args.alt]
    alts += [(f"R{spec.replace(',', 'G')}", editrow_launchers(
        tuple(int(x) for x in spec.split(","))))
        for spec in args.layout]
    for label, (rowmin, edit) in alts:
        olds["rowmin"].append((label, rowmin))
        olds["edit"].append((label, edit))

    rb = [(f"{s[0]} {i}", main_path_rb_batch(s, i))
          for i, s in enumerate(MAIN_PATH_RB_SHAPES)]
    rb_rows, rb_sums = _measure(
        "rowmin", rb, traceback.batch_edit_rowmin_cuda,
        align.batch_edit_rowmin, olds["rowmin"], dev, clock, gpu, args.reps,
        rb_bound, rowmin_live)
    by_locus = {}
    for rec, shape in zip(rb_rows, MAIN_PATH_RB_SHAPES):
        sums = by_locus.setdefault(shape[0], {})
        for k, v in rec.items():
            if k.endswith("dev_ms"):
                sums[k] = sums.get(k, 0.0) + min(v)
    edit = [(f"{s[0]} STEP 4", main_path_edit_batch(s, 100 + i))
            for i, s in enumerate(MAIN_PATH_EDIT_SHAPES)]
    edit.append(("(256, 16, 16)", main_path_edit_batch(
        ("", 256, 256, 16, 16, 16, 15, 10, 16, 15, 10), 102)))
    edit.append(("four 9 kb exons", nine_kb_exons()))
    edit_rows, _ = _measure(
        "edit_score", edit, kband.batch_edit_distance_score_cuda,
        align.batch_edit_distance_score, olds["edit"], dev, clock, gpu,
        args.reps, edit_bound)
    print("rowmin: the 24 main-path launches == plain on every live row; "
          "sums " + ", ".join(f"{k} {v:.4f}" for k, v in rb_sums.items())
          + "; on the card alone by locus " + json.dumps(by_locus)
          + f"  [{gpu}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": gpu, "max_sm_clock_hz": clock,
                   "rowmin": {"sums": rb_sums, "by_locus": by_locus,
                              "launches": rb_rows},
                   "edit_score": edit_rows}, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
