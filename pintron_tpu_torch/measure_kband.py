"""``kband_kernel`` at the launch shapes of the main path: seeded batches
with the batch sizes, length buckets, row counts and band widths that
STEP 2 gives the kernel on TP53 and issue-13 (12 launches), each held
against the plain version on every problem and timed with CUDA events.

    python -m pintron_tpu_torch.measure_kband [--old KBAND_CU] [--out FILE]

``--old`` builds another version of ``csrc/kband.cu`` whose
``pintron_kband`` takes the (W, B) int32 band scratch of the first
port's kernel (one thread per problem), checks it against the plain
version too, and times it in turns with this checkout's kernel (old,
new, new, old), so that the two are compared in one process on one
card.  Writes ``chiprun_out/kband_measure.json`` by default and prints
one line per shape.  ``chip_smoke.py`` takes the shapes and the batch
maker from here.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (locus, live problems, batch padded to, length bucket N, longest
#  problem's rows, band cells of the launch, k_max): the 12 K-band
# launches of STEP 2 with a fresh memo, recorded from the offload's
# groups on the two loci
MAIN_PATH_SHAPES = (
    ("TP53", 98, 128, 1024, 881, 2_150_000, 32),
    ("TP53", 97, 128, 1024, 881, 2_540_000, 32),
    ("TP53", 256, 256, 1024, 690, 3_480_000, 32),
    ("TP53", 301, 512, 1024, 786, 4_570_000, 32),
    ("TP53", 6, 64, 4096, 1289, 990_000, 64),
    ("TP53", 7, 64, 4096, 1287, 1_150_000, 64),
    ("issue-13", 261, 512, 1024, 929, 2_720_000, 32),
    ("issue-13", 52, 64, 1024, 948, 750_000, 32),
    ("issue-13", 571, 1024, 1024, 890, 8_400_000, 32),
    ("issue-13", 275, 512, 1024, 724, 3_100_000, 32),
    ("issue-13", 12, 64, 4096, 1520, 2_010_000, 64),
    ("issue-13", 6, 64, 4096, 2420, 3_730_000, 128),
)

# 8 integer operations per band cell: the mismatch test, the diag and
# up adds, their minimum, the band and boundary selects, and the left
# chain's subtract, minimum, add and clamp counted as two
OPS_PER_CELL = 8
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # 64 INT32 lanes an SM at 1.98 GHz


def _p4(x: int, lo: int = 16) -> int:
    v = lo
    while v < x:
        v <<= 2
    return v


def main_path_batch(shape, seed: int):
    """A seeded batch of one main-path launch: ``live`` problems padded
    with empty ones to ``Bp``, the longest of ``rows_max`` rows, the
    others drawn so that the launch's band cells come near ``cells``;
    each problem's band grows with its rows up to ``k_max``, len1 -
    len2 runs from 0 to the band, and seq2 is seq1's prefix with point
    mutations.  Returns (seq1, len1, seq2, len2, band, max_rows, k_max)
    with max_rows the offload's row bucket."""
    _locus, live, Bp, N, rows_max, cells, k_max = shape
    rng = np.random.default_rng(seed)
    W = 2 * k_max + 1
    mean = max(cells / (W * live), 1.0 + 1e-9)
    # rows = 1 + u**p * (rows_max - 1) has mean 1 + (rows_max - 1)/(p+1)
    p = max((rows_max - 1) / max(mean - 1, 1e-9) - 1, 0.0)
    rows = 1 + np.floor(rng.random(live) ** p * (rows_max - 1)).astype(int)
    rows[0] = rows_max
    k = np.clip(np.ceil(k_max * rows / rows_max), 1, k_max).astype(int)
    max_rows = _p4(rows_max)
    alpha = np.frombuffer(b"ACGT", dtype=np.int8)
    s1 = alpha[rng.integers(0, 4, (Bp, N))]
    s2 = np.zeros((Bp, max_rows), dtype=np.int8)
    len1 = np.zeros(Bp, dtype=np.int32)
    len2 = np.zeros(Bp, dtype=np.int32)
    band = np.zeros(Bp, dtype=np.int32)
    for b in range(live):
        m = int(rows[b])
        n = min(m + int(rng.integers(0, k[b] + 1)), N)
        row = s1[b, :m].copy()
        hits = rng.random(m) < 0.02
        row[hits] = alpha[rng.integers(0, 4, int(hits.sum()))]
        s2[b, :m] = row
        len1[b], len2[b], band[b] = n, m, k[b]
    return s1, len1, s2, len2, band, max_rows, k_max


def wide_budget_batch(rng, B, n_lo, n_hi, ub_lo, ub_hi):
    """Noisy-exon checks of long exons: len1 in [n_lo, n_hi], a budget
    ub in [ub_lo, ub_hi] the band does not cover (2ub+1 < len1), len2
    within ub of len1, seq2 seq1's prefix with ub/2 to 3ub point
    mutations, so that some verdicts pass and some fail."""
    alpha = np.frombuffer(b"ACGT", dtype=np.int8)
    N = max(1024, _p4(n_hi))
    s1 = alpha[rng.integers(0, 4, (B, N))]
    len1 = rng.integers(n_lo, n_hi + 1, B).astype(np.int32)
    band = np.array([rng.integers(ub_lo, min(ub_hi, (n - 2) // 2) + 1)
                     for n in len1], dtype=np.int32)
    len2 = (len1 - rng.integers(0, band // 4 + 1)).astype(np.int32)
    M = _p4(int(len2.max()))
    s2 = np.zeros((B, M), dtype=np.int8)
    for b in range(B):
        m = int(len2[b])
        row = s1[b, :m].copy()
        hits = rng.integers(0, m, int(rng.integers(band[b] // 2,
                                                   3 * band[b])))
        row[hits] = alpha[rng.integers(0, 4, len(hits))]
        s2[b, :m] = row
    return s1, len1, s2, len2, band, M


def wide_budget_batches():
    """chip_smoke.py's two batches of long exons, seeded: 8 checks at
    budgets of 257 to 512 (exons of 600 to 1100 bases), then four exons
    of about 9 kb at budgets of about 270 (3% of their length).  Returns
    the two batches of wide_budget_batch."""
    rng = np.random.default_rng(20261017)
    return (wide_budget_batch(rng, 8, 600, 1100, 257, 512),
            wide_budget_batch(rng, 4, 8800, 9200, 264, 276))


def kband_bound(len1, len2, band, max_rows: int, clock_hz: float):
    """The least time of one launch: (bound ms, "bytes" or "operations",
    chain floor ms).  Bytes: each problem's two sequences, its lengths
    and band read once, its result written once.  Operations: the band
    cells its rows need at OPS_PER_CELL each, over the INT32 peak.  The
    chain floor: the longest problem's rows, each at least
    ceil(log2 W) + 2 dependent integer operations (the diag and up
    minimum, then a prefix-min of depth log2 W) of 4 cycles at the
    card's highest SM clock."""
    rows = np.minimum(len2.astype(np.int64), max_rows)
    cells = int((rows * (2 * band.astype(np.int64) + 1)).sum())
    nbytes = int(len1.sum()) + int(len2.sum()) + 16 * int((len2 > 0).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_CELL * cells / INT32_OPS_PER_S * 1e3
    W = 2 * int(band.max(initial=0)) + 1
    row_s = (int(np.ceil(np.log2(W))) + 2) * 4 / clock_hz
    chain = int(rows.max(initial=0)) * row_s * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", chain
    return t_ops, "operations", chain


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """ms a call on the card alone: ``reps`` calls queued behind a 20M
    cycle sleep of the stream (10 ms and more), so that the events time
    the kernels back to back and not the host's dispatch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_sm_clock_hz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return float(r.stdout.split()[0]) * 1e6


def build_other(src: str, name: str) -> ctypes.CDLL:
    """Build another version of one kernel source into build/<name>/ and
    load it (beside this checkout's library, which it does not touch)."""
    from pintron_tpu_torch.ops._build import NVCC_FLAGS, _nvcc
    out_dir = os.path.join(REPO, "build", name)
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stdout}"
                           f"{res.stderr}")
    print(f"built {src}\n{(res.stdout + res.stderr).strip()}", flush=True)
    return ctypes.CDLL(so)


def build_old(src: str):
    """Build another version of kband.cu and return a launcher with the
    first port's arguments (the band scratch)."""
    lib = build_other(src, "kband-old")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pintron_kband.restype = I
    lib.pintron_kband.argtypes = [P, I, P, I, P, P, P, P, P, I, I, I, P]

    def launch(seq1, len1, seq2, len2, band, *, max_rows, k_max):
        B = seq1.shape[0]
        out = torch.empty(B, dtype=torch.int32, device=seq1.device)
        scratch = torch.empty((2 * k_max + 1, B), dtype=torch.int32,
                              device=seq1.device)
        err = lib.pintron_kband(
            seq1.data_ptr(), seq1.shape[1], seq2.data_ptr(), seq2.shape[1],
            len1.data_ptr(), len2.data_ptr(), band.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, max_rows, k_max,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old kband_kernel launch failed: {err}")
        return out
    return launch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", default="",
                   help="a kband.cu of the first port's kernel to time "
                        "beside this checkout's")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "kband_measure.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_kband: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from pintron_tpu_torch.ops import _build, align, kband
    from pintron_tpu_torch.ops.align import from_numpy_batch
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
    old = build_old(args.old) if args.old else None
    rows = []
    for i, shape in enumerate(MAIN_PATH_SHAPES):
        s1, l1, s2, l2, band, max_rows, k_max = main_path_batch(shape, i)
        kw = dict(max_rows=max_rows, k_max=k_max)
        t = from_numpy_batch(s1, l1, s2, l2, band, device=dev)
        want = align.banded_edit_distance(*t, **kw)
        got = kband.banded_edit_distance_cuda(*t, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{shape}: kband_kernel != plain on "
                                 f"{int((got != want).sum())} problems")
        new = lambda: kband.banded_edit_distance_cuda(*t, **kw)  # noqa: E731
        rec = {"shape": shape, "W": 2 * k_max + 1, "max_rows": max_rows,
               "gpu": gpu}
        bound, by, chain = kband_bound(l1, l2, band, max_rows, clock)
        rec.update(bound_ms=bound, bound_by=by, chain_floor_ms=chain)
        if old is not None:
            o = old(*t, **kw)
            torch.cuda.synchronize()
            if not torch.equal(o, want):
                raise AssertionError(f"{shape}: old kernel != plain")
            fo = lambda: old(*t, **kw)  # noqa: E731
            a = cuda_ms(fo, 3)
            b1 = cuda_ms(new, 20)
            b2 = cuda_ms(new, 20)
            a2 = cuda_ms(fo, 3)
            rec.update(old_ms=[a, a2], new_ms=[b1, b2],
                       speedup=min(a, a2) / max(b1, b2))
        else:
            rec["new_ms"] = [cuda_ms(new, 20)]
        rec["plain_ms"] = cuda_ms(
            lambda: align.banded_edit_distance(*t, **kw), 1)
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": gpu, "max_sm_clock_hz": clock, "shapes": rows}, f,
                  indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
