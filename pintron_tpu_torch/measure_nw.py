"""``nw_kernel`` at the launch shapes of the main path: seeded batches
with the batch sizes, (est, gen) length buckets and longest and median
lengths that STEP 2 gives the kernel on TP53 and issue-13 (21
launches), each held against the plain version on every problem and
timed with CUDA events (the profiler drops ``nw_kernel`` events).

    python -m pintron_tpu_torch.measure_nw [--old LABEL=NW_CU ...]
        [--alt LABEL=NW_CU ...] [--out FILE]

``--old`` builds another version of ``csrc/nw.cu`` with the C interface
of the block-per-problem kernel (an int8 (B, N, M) direction scratch,
no row buffer), ``--alt`` one with this checkout's; each is checked
against the plain version on its scores (the record says whether its
ops agree too: a build with the traceback walk compiled out gives only
the fill's time) and timed in turns with this checkout's kernel (old,
new, new, old), so that they are compared in one process on one card:
each launch back to back (the wrapper's dispatch included) and on the
card alone (``measure_kband.device_ms``).  Writes
``chiprun_out/nw_measure.json`` by default and prints one line per
shape.  ``chip_smoke.py`` takes the shapes, the batch maker and the
bound from here.

    python -m pintron_tpu_torch.measure_nw --record [--device cpu]
        [case ...]

prints the NW launches STEP 2 makes on golden cases (by default
OVERSIZED_NW_CASES), in MAIN_PATH_NW_SHAPES' form: how
OVERSIZED_NW_SHAPES was recorded.
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
                                             max_sm_clock_hz)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (locus, B, est bucket N, gen bucket M, longest est, longest gen,
#  median est, median gen): the 21 NW launches of STEP 2 with a fresh
# memo (PINTRON_FRESH_MEMO=1), recorded from the offload's groups on the
# two loci; a launch of one problem, and the two whose medians were not
# recorded, carry their longest as the median.  They were recorded under
# the JAX package's traceback bound: since the kernels' own bound,
# issue-13's (4096, 4096) launch holds 18 problems of up to 2421 x 2421
# (OVERSIZED_NW_SHAPES has its launches as they are now)
MAIN_PATH_NW_SHAPES = (
    ("TP53", 15, 64, 64, 64, 63, 51, 53),
    ("TP53", 1, 256, 64, 66, 64, 66, 64),
    ("TP53", 56, 256, 256, 236, 236, 98, 99),
    ("TP53", 12, 1024, 1024, 852, 852, 668, 669),
    ("TP53", 13, 4096, 4096, 1297, 1289, 1295, 1287),
    ("TP53", 21, 64, 64, 64, 64, 54, 54),
    ("TP53", 331, 256, 256, 252, 252, 138, 137),
    ("TP53", 1, 1024, 256, 258, 254, 258, 254),
    ("TP53", 71, 1024, 1024, 788, 786, 417, 417),
    ("issue-13", 82, 64, 64, 63, 61, 54, 54),
    ("issue-13", 15, 64, 256, 61, 65, 61, 65),
    ("issue-13", 2, 256, 64, 66, 60, 66, 60),
    ("issue-13", 70, 256, 256, 255, 255, 116, 116),
    ("issue-13", 64, 1024, 1024, 949, 949, 419, 420),
    ("issue-13", 9, 4096, 4096, 1442, 1445, 1240, 1241),
    ("issue-13", 91, 64, 64, 64, 64, 51, 51),
    ("issue-13", 1, 64, 256, 64, 65, 64, 65),
    ("issue-13", 1, 256, 64, 65, 64, 65, 64),
    ("issue-13", 256, 256, 256, 255, 255, 146, 145),
    ("issue-13", 1, 1024, 256, 262, 256, 262, 256),
    ("issue-13", 220, 1024, 1024, 890, 893, 435, 435),
)

# The NW launches of STEP 2 on the four loci whose endpoint problems the
# JAX package's traceback bound (2^21 cells, 8192 in length) left to the
# host and the kernels' bound (offload.TRACEBACK_BOUND) sends to the card,
# in the same form, recorded with device="cpu" and a fresh memo by
# ``python -m pintron_tpu_torch.measure_nw --record``
OVERSIZED_NW_CASES = ("test-788", "test-issue-2", "test-issue-13",
                      "test_gtf5")
OVERSIZED_NW_SHAPES = (
    ("788", 14, 4096, 4096, 3128, 3128, 2862, 2862),
    ("788", 5, 1024, 1024, 690, 690, 518, 518),
    ("issue-2", 14, 64, 64, 55, 55, 49, 49),
    ("issue-2", 3, 64, 256, 62, 70, 61, 69),
    ("issue-2", 1, 256, 64, 76, 62, 76, 62),
    ("issue-2", 21, 256, 256, 207, 207, 89, 83),
    ("issue-2", 15, 1024, 1024, 804, 804, 691, 691),
    ("issue-2", 1, 4096, 4096, 2249, 2249, 2249, 2249),
    ("issue-2", 4, 16384, 16384, 4202, 4202, 4183, 4183),
    ("issue-2", 1, 64, 64, 62, 63, 62, 63),
    ("issue-2", 8, 256, 256, 232, 232, 192, 192),
    ("issue-2", 24, 1024, 1024, 586, 586, 345, 343),
    ("issue-13", 82, 64, 64, 63, 61, 54, 53),
    ("issue-13", 15, 64, 256, 61, 65, 61, 65),
    ("issue-13", 2, 256, 64, 66, 60, 65, 59),
    ("issue-13", 70, 256, 256, 255, 255, 114, 114),
    ("issue-13", 64, 1024, 1024, 949, 949, 418, 419),
    ("issue-13", 18, 4096, 4096, 2421, 2421, 1453, 1454),
    ("issue-13", 91, 64, 64, 64, 64, 51, 51),
    ("issue-13", 1, 64, 256, 64, 65, 64, 65),
    ("issue-13", 1, 256, 64, 65, 64, 65, 64),
    ("issue-13", 256, 256, 256, 255, 255, 145, 145),
    ("issue-13", 1, 1024, 256, 262, 256, 262, 256),
    ("issue-13", 220, 1024, 1024, 890, 893, 433, 434),
    ("gtf5", 5, 64, 64, 57, 57, 49, 50),
    ("gtf5", 25, 256, 256, 256, 256, 131, 131),
    ("gtf5", 31, 1024, 1024, 729, 730, 485, 486),
    ("gtf5", 6, 4096, 4096, 1666, 1667, 1666, 1666),
    ("gtf5", 12, 64, 64, 64, 64, 45, 44),
    ("gtf5", 62, 256, 256, 253, 253, 141, 142),
    ("gtf5", 283, 1024, 1024, 885, 885, 497, 497),
)

# integer operations a cell: the match test with its wildcards, the diag,
# up and left candidates, their minima, and the direction's two tests
OPS_PER_CELL = 10


def _lengths(B: int, bucket: int, longest: int, median: int,
             shortest: int = 0):
    """B lengths in the bucket (bucket/4, bucket]: evenly spaced
    quantiles, piecewise linear from the shortest (by default the
    bucket's floor) through the median to the longest, the largest set
    to the longest."""
    lo = shortest or bucket // 4 + 1
    u = (np.arange(B) + 0.5) / B
    med = min(max(median, lo), longest)
    x = np.where(u <= 0.5, lo + (med - lo) * u / 0.5,
                 med + (longest - med) * (u - 0.5) / 0.5)
    x = np.clip(np.rint(x).astype(np.int64), lo, longest)
    x[-1] = longest
    return x


def main_path_nw_batch(shape, seed: int):
    """A seeded batch of one main-path NW launch.  The est windows are
    random bases with a few N; each gen window is its est, with 3% point
    mutations, cut or extended with random bases to its length, as an
    endpoint window of a real exon is.  Returns (est, elen, gen, glen,
    N, M)."""
    _locus, B, N, M, le, lg, me, mg = shape
    rng = np.random.default_rng(seed)
    order = rng.permutation(B)
    elen = _lengths(B, N, le, me)[order]
    glen = _lengths(B, M, lg, mg)[order]
    alpha = np.frombuffer(b"ACGT", dtype=np.int8)
    est = alpha[rng.integers(0, 4, (B, N))]
    est[rng.random((B, N)) < 0.002] = ord("N")
    gen = alpha[rng.integers(0, 4, (B, M))]
    for b in range(B):
        k = int(min(elen[b], glen[b]))
        row = est[b, :k].copy()
        hits = rng.random(k) < 0.03
        row[hits] = alpha[rng.integers(0, 4, int(hits.sum()))]
        gen[b, :k] = row
    return (est, elen.astype(np.int32), gen, glen.astype(np.int32), N, M)


def nw_bound(elen, glen, clock_hz: float):
    """The least time of one launch: (bound ms, "bytes" or "operations",
    chain floor ms).  Bytes: both windows and the lengths read once, the
    ops (at most elen + glen a problem), the score and the step count
    written once.  Operations: OPS_PER_CELL a cell of the elen x glen DP,
    over the INT32 peak.  The chain floor: the longest problem's chain,
    elen rows, each at least ceil(log2(glen + 1)) + 2 dependent integer
    operations (the candidates' minimum, then a prefix-min over the row),
    then elen + glen traceback steps, all of 4 cycles at the card's
    highest SM clock."""
    e = np.asarray(elen, dtype=np.int64)
    g = np.asarray(glen, dtype=np.int64)
    nbytes = 2 * int((e + g).sum()) + 16 * len(e)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_CELL * int((e * g).sum()) / INT32_OPS_PER_S * 1e3
    chain = max(((int(a) * (int(np.ceil(np.log2(max(int(b) + 1, 2)))) + 2)
                  + int(a) + int(b)) * 4 / clock_hz * 1e3
                 for a, b in zip(e, g)), default=0.0)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", chain
    return t_ops, "operations", chain


def build_block_kernel(src: str, label: str, key: str = "nw"):
    """Build a version of ``{key}.cu`` (nw or gap) with the
    block-per-problem kernels' C interface (an int8 (B, N, M) direction
    scratch) and return a launcher of it."""
    lib = build_other(src, f"{key}-{label}")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"pintron_{key}")
    fn.restype = I
    fn.argtypes = [P, I, P, I, P, P, P, P, P, P, I, P]

    def launch(est, elen, gen, glen, *, max_n, max_m):
        B, dev = est.shape[0], est.device
        head = torch.empty(B, dtype=torch.int32, device=dev)
        ops = torch.empty((B, max_n + max_m), dtype=torch.int8, device=dev)
        nsteps = torch.empty(B, dtype=torch.int32, device=dev)
        dirs = torch.empty((B, max_n, max_m), dtype=torch.int8, device=dev)
        err = fn(est.data_ptr(), max_n, gen.data_ptr(), max_m,
                 elen.data_ptr(), glen.data_ptr(), dirs.data_ptr(),
                 head.data_ptr(), ops.data_ptr(), nsteps.data_ptr(), B,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{label} {key}_kernel launch failed: {err}")
        return head, ops, nsteps
    return launch


def build_warp_kernel(src: str, label: str):
    """Build another version of nw.cu with this checkout's C interface
    (2-bit direction words and a row buffer) and return a launcher."""
    from pintron_tpu_torch.ops.traceback import nw_scratch
    lib = build_other(src, f"nw-{label}")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pintron_nw.restype = I
    lib.pintron_nw.argtypes = [P, I, P, I, P, P, P, P, P, P, P, I, P]

    def launch(est, elen, gen, glen, *, max_n, max_m):
        B, dev = est.shape[0], est.device
        score = torch.empty(B, dtype=torch.int32, device=dev)
        ops = torch.empty((B, max_n + max_m), dtype=torch.int8, device=dev)
        nsteps = torch.empty(B, dtype=torch.int32, device=dev)
        words, row = nw_scratch(B, max_n, max_m, dev)
        err = lib.pintron_nw(
            est.data_ptr(), max_n, gen.data_ptr(), max_m, elen.data_ptr(),
            glen.data_ptr(), words.data_ptr(), row.data_ptr(),
            score.data_ptr(), ops.data_ptr(), nsteps.data_ptr(), B,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{label} nw_kernel launch failed: {err}")
        return score, ops, nsteps
    return launch


def ops_equal(got, want, nsteps) -> bool:
    """The op codes of every problem up to its step count."""
    live = (torch.arange(got.shape[1], device=got.device)[None, :]
            < nsteps[:, None].long())
    return bool(torch.equal(got[live], want[live]))


def measure_main(argv, *, key: str, doc: str, shapes, make_batch,
                 bound_fn, kernel, plain, build_alt) -> int:
    """The command line of measure_nw and measure_gap: every launch
    shape of ``shapes`` made by ``make_batch``, held against ``plain``
    on every problem and timed with ``kernel`` (this checkout's) and the
    ``--old`` / ``--alt`` builds in turns; writes the records to
    ``chiprun_out/{key}_measure.json`` unless ``--out`` says where."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--old", action="append", default=[],
                   metavar=f"LABEL={key.upper()}_CU",
                   help=f"a {key}.cu with the block-per-problem kernel's C "
                        "interface, timed beside this checkout's kernel")
    p.add_argument("--alt", action="append", default=[],
                   metavar=f"LABEL={key.upper()}_CU",
                   help=f"a {key}.cu with this checkout's C interface, "
                        "timed beside this checkout's kernel")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 f"{key}_measure.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"measure_{key}: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from pintron_tpu_torch.ops import _build
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
    olds = []
    for specs, build in ((args.old, lambda src, label: build_block_kernel(
            src, label, key)), (args.alt, build_alt)):
        for spec in specs:
            label, src = spec.split("=", 1)
            olds.append((label, build(src, label)))
    rows = []
    sums = {"plain": 0.0, "bound": 0.0, "chain": 0.0}
    for i, shape in enumerate(shapes):
        est, elen, gen, glen, N, M = make_batch(shape, i)
        t = from_numpy_batch(est, elen, gen, glen, device=dev)
        kw = dict(max_n=N, max_m=M)
        want = plain(*t, **kw)
        got = kernel(*t, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{shape}: {key}_kernel != plain")
        rec = {"shape": shape, "gpu": gpu}
        bound, by, chain = bound_fn(elen, glen, clock)
        rec.update(bound_ms=bound, bound_by=by, chain_floor_ms=chain)
        new = lambda: kernel(*t, **kw)  # noqa: E731
        timed = []
        for label, launch in olds:
            h, o, n = launch(*t, **kw)
            torch.cuda.synchronize()
            # the score or start matrix must agree; a build with the walk
            # compiled out gives no ops
            if not torch.equal(h, want[0]):
                raise AssertionError(f"{shape}: {label} != plain")
            rec[f"{label}_ops_equal"] = (torch.equal(n, want[2])
                                         and ops_equal(o, want[1], n))
            timed.append((label, lambda launch=launch: launch(*t, **kw)))
        # each call timed back to back (what the offload's launch costs,
        # the wrapper's dispatch included) and on the card alone
        order = timed + [("new", new), ("new", new)] + timed[::-1]
        for label, fn in order:
            rec.setdefault(f"{label}_ms", []).append(cuda_ms(fn, args.reps))
            rec.setdefault(f"{label}_dev_ms", []).append(
                device_ms(fn, args.reps))
        rec["plain_ms"] = cuda_ms(lambda: plain(*t, **kw), 1)
        for k, v in (("plain", rec["plain_ms"]), ("bound", bound),
                     ("chain", chain)):
            sums[k] += v
        for label in ["new"] + [lbl for lbl, _fn in timed]:
            for k in (f"{label}_ms", f"{label}_dev_ms"):
                sums[k] = sums.get(k, 0.0) + min(rec[k])
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    print(f"sums over the {len(rows)} launches: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items())
          + f"  [{gpu}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": gpu, "max_sm_clock_hz": clock, "sums": sums,
                   "shapes": rows}, f, indent=1)
    print(f"wrote {args.out}")
    return 0


def record_nw_shapes(cases, device="cpu") -> list:
    """The NW launches STEP 2 makes on the golden ``cases``
    (``check_stage2.check_case``: fresh memo, byte-checked), in
    MAIN_PATH_NW_SHAPES' form, in launch order."""
    from pintron_tpu_torch.ops import offload
    from pintron_tpu_torch.tools.check_stage2 import check_case
    real = offload.batch_nw_traceback_cuda
    shapes = []

    for case in cases:
        locus = case.split("-", 1)[-1].split("_", 1)[-1]

        def recorder(est, elen, gen, glen, *, max_n, max_m):
            e, g = elen.cpu().numpy(), glen.cpu().numpy()
            shapes.append((locus, len(e), max_n, max_m, int(e.max()),
                           int(g.max()), int(np.median(e)),
                           int(np.median(g))))
            return real(est, elen, gen, glen, max_n=max_n, max_m=max_m)

        offload.batch_nw_traceback_cuda = recorder
        try:
            res = check_case(case, device)
        finally:
            offload.batch_nw_traceback_cuda = real
        if res["status"] != "OK":
            raise AssertionError(f"{case}: {res['differs']}")
    return shapes


def main(argv=None) -> int:
    from pintron_tpu_torch.ops import align, traceback
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--record"]:
        p = argparse.ArgumentParser(
            prog="measure_nw --record",
            description="print the NW launches STEP 2 makes on golden "
                        "cases, in MAIN_PATH_NW_SHAPES' form")
        p.add_argument("cases", nargs="*", default=OVERSIZED_NW_CASES)
        p.add_argument("--device", default="cpu")
        args = p.parse_args(argv[1:])
        for shape in record_nw_shapes(args.cases, args.device):
            print(f"    {shape!r},")
        return 0
    return measure_main(
        argv, key="nw", doc=__doc__, shapes=MAIN_PATH_NW_SHAPES,
        make_batch=main_path_nw_batch, bound_fn=nw_bound,
        kernel=traceback.batch_nw_traceback_cuda,
        plain=align.batch_nw_traceback, build_alt=build_warp_kernel)


if __name__ == "__main__":
    sys.exit(main())
