#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on
failure (so the script exits non-zero and never prints its last line):

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the hand-written kernels of pintron_tpu_torch/csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card, exact
     equality on every problem: seeded batches with the edge cases
     (kband_kernel at every band width its warp layout instantiates),
     the K-band production shape (B, rows, W) = (32768, 256, 33), the
     12 launch shapes STEP 2 gives kband_kernel on TP53 and issue-13
     (pintron_tpu_torch.measure_kband), budgets of 257 to 512 on
     kband_kernel against the plain version and edit_score_kernel's
     verdicts, both timed on four 9 kb exons (edit_score_kernel at full
     length, against its plain version too), the 21 launch shapes STEP
     2 gives nw_kernel (pintron_tpu_torch.measure_nw), the 8 it gives
     gap_kernel (pintron_tpu_torch.measure_gap) and the 24 it gives
     rowmin_kernel (pintron_tpu_torch.measure_rowmin; rowmin on its
     live rows), the 31 launches STEP 2 gives nw_kernel on 788,
     issue-2, issue-13 and gtf5, whose endpoint problems over the JAX
     package's traceback bound go to the card
     (measure_nw.OVERSIZED_NW_SHAPES; the call and the card-alone time
     beside the problems a launch, the bound and the chain floor, summed
     under "oversized" in nw_kernel's JSON entry), and pwm_kernel bit
     for bit on seeded windows (N bases,
     codes outside 0..3, B = 1 and B not a multiple of 32, the issue-13
     sweep's shape (8425, 12)); times of each (CUDA events) at the
     shapes the main path gives it, edit_score_kernel's at the STEP 4
     shape (256, 16, 16), each beside its bound, and the F.conv1d
     yardstick beside pwm_kernel;
  4. the main path, STEP 2 (est-fact): the port's run_est_fact on the
     TP53 and issue-13 loci with every DP family on the card,
     byte-compared with tests/golden/; the kernel launch counters are
     reset just before these two runs and read just after them.  Then,
     with the counters reset again, the offload entries on problem
     mixes held against the host: eval_kband against the native
     ep_kband verdicts (it reaches the full-matrix route, which no real
     locus reaches), eval_nw against nw_align_run, eval_gap against
     gap_align_run and eval_rb against the rows of edit_matrix;
  5. the main path, STEP 4 (intron agreement): the port's
     run_intron_agreement on TP53 and issue-13 from the goldens' STEP 3
     outputs, its two artifacts byte-compared with tests/golden/, with
     the counters reset just before and read just after;
  6. the full pipeline, python -m pintron_tpu_torch.pipeline --device
     cuda, on AMBN, classified against golden like tools/check_e2e.py,
     with both device-flow log lines' launches;
  7. the device service: python -m pintron_tpu_torch.devservice --device
     cuda, TP53's STEP 2 sharded over 8 fork workers in a client process
     that must never initialise CUDA, byte-compared with golden; then
     python -m pintron_tpu_torch.batch --device cuda on AMBN and TP53
     (AMBN against golden as in phase 6; TP53, whose final outputs
     differ from golden by the reference's stage-5 hash order, against
     the port's own --device host batch on the same input, byte for
     byte).
  8. the entry point, pintron_tpu_torch.graft_entry.entry() on the card:
     the batched scoring step (kband_kernel, pwm_kernel and an int32
     index_add_) on the JAX entry's example batch, with the counters
     reset just before and read just after (kband_kernel and pwm_kernel
     must launch), equal to its plain version on the card and to the
     step on the CPU (distances and support exactly, scores bit for
     bit), and timed whole and part by part beside its bound; then
     parallel.mesh.edge_batch (pairs within their band and over it,
     repeated intron ids, donor codes outside 0..3), whose support
     total must be above 0, held to the plain step and the CPU step
     the same way;
  9. the device fuzz, pintron_tpu_torch.fuzz_device.run_case on the 9
     cells of its grid (seeds 4000-4008: genomic 20, 50 and 100 kb by
     30, 60 and 120 ESTs), STEP 2 on the card in a fresh process
     against the host path in another, byte for byte, each case's
     routes (full-matrix K-band launches, the widest band budget, host
     gap cells, launches) on a line of its own; the launches are the
     device runs' own counts.
 10. the mesh and the multi-process STEP 2:
     parallel.mesh.sharded_alignment_step over 1, 2 and 8 shards, all
     on this card, on entry()'s batch and the edge batch, equal to
     alignment_step and to the plain step (distances and support
     exactly, scores within 1e-6), each timed; the offload's K-band
     route over a mesh, ops.offload._sharded_call over 1, 2, 3 and 8
     shards on band and full-matrix groups of 50 and 146 problems
     (kband_kernel and edit_score_kernel at short shards), equal to
     the unsharded wrapper and the plain op, each timed (comparisons,
     before the counters are reset); then
     graft_entry.dryrun_multichip(8): AMBN's STEP 2 over an 8-shard
     mesh (kband_kernel launched a multiple of 8 times, K-band groups
     counted in offload.STATS["mesh_batches"]) byte for byte,
     the pipeline resumed for STEPs 3-8, its finals byte for byte, and
     STEP 2 over two processes (a gloo group, one device service on
     the card) byte for byte with the ranks' agreement; the counters
     are reset just before the sharded steps and read just after the
     dryrun, the service's launches added.  AMBN's STEP 2 wall with and
     without the mesh beside it; then KmerIndex.lookup_ranges_device
     on the card against the numpy lookup_ranges on TP53, timed beside
     its bound.
 11. the golden sweep on the card: STEP 2 on the 9 golden loci with
     inputs (788, AMBN, CPB2, TP53, issue-2, issue-13, mattia1, mattia3,
     gtf5) through pintron_tpu_torch.tools.check_stage2.check_case,
     each byte-identical to golden with every family's problems on the
     card, every STEP 2 kernel launched and no problem left to the host
     for its size (every offload <family>_too_wide 0), one line a locus
     with its ESTs/s and device share of the DP cells and one with its
     routes (the widest K-band budget,
     full-matrix launches, the NW, gap and refine-borders buckets and
     their passes, the host DP cells beside the device cells); then
     the 9 through one python -m pintron_tpu_torch.batch --device cuda
     on one device service (tools.check_batch_sweep.sweep), each
     locus's finals byte for byte its --device host solo run's and of
     that run's class against golden (tools.check_e2e.classify_case),
     none diff; the counters are reset just before the phase and read
     just after it, the service's launches added, and every STEP 2 and
     STEP 4 kernel must have launched.
 12. the family routes: STEP 2 on TP53 and issue-13 through
     check_stage2.check_case, forced (no switch set), with each
     family's PINTRON_DEVICE_{KBAND,NW,GAP,RB} at 0 in turn (the host DP
     inside the cascade), and with all four at auto (the self-tuner,
     cleared before each locus), each run byte for byte the golden's;
     a family at 0 must launch its kernel no time and every other
     family exactly as often as in the forced run; each run's ESTs/s,
     device share of the DP cells, launches, latches and tuner counters
     on a line, and all of them on one JSON line; the counters are
     reset just before the phase and read just after it.

Nothing of the JAX package is imported: the goldens, the port's host
path and its native C DPs are the references.  Before the last line it
prints the card line and one JSON object: under "kernels" every
kernel, with its launches on the main path (STEPs 2 and 4, the entry
point, the fuzz's device runs, the mesh phase, the golden sweep and
the family routes; each path's count apart under "launches_by_path",
keyed "step2", "step4", "entry", "fuzz", "mesh", "sweep" and
"routes"), its launches on the problem mix,
its largest difference from the plain version, its time, the plain
version's, its bound (the larger of its bytes over the HBM rate and its
operations over the peak rate of their type, from this run's inputs),
what bounds it, and the one PyTorch call that computes the same
function where there is one (F.conv1d for pwm_kernel; null elsewhere;
for pwm_kernel also both times on the card alone, "device_ms" and
"library_device_ms", as its call's time is the host's dispatch).
kband_kernel's, nw_kernel's, gap_kernel's and rowmin_kernel's times
and bounds are the sums over their 12, 21, 8 and 24 main-path shapes
(for the last three also "device_ms", on the card alone).  The floor
of the dependent chain of each row-serial DP (its longest problem's
rows times the least latency of a row) is printed on the kernel's own
lines of phase 3, beside its bound, and kept out of the JSON line,
which holds only measured numbers and the bound.  Every
kernel must have been launched by the main path.  The last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch

from pintron_tpu_torch.measure_kband import (HBM_BYTES_PER_S,
                                             MAIN_PATH_SHAPES,
                                             device_ms, kband_bound,
                                             main_path_batch,
                                             max_sm_clock_hz,
                                             wide_budget_batches)
from pintron_tpu_torch.measure_rowmin import edit_bound, rowmin_live
from pintron_tpu_torch.ops.align import from_numpy_batch
from pintron_tpu_torch.regression import STAGE2_ARTIFACTS
from pintron_tpu_torch.runtime.timing import card_line

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
STAGE4_INPUTS = ("genomic.txt", "processed-ests.txt", "out-agree.txt")
STAGE4_FILES = ("out-after-intron-agree.txt", "predicted-introns.txt")
# the kernels every locus's STEP 2 launches (edit_score_kernel serves
# the full-matrix K-band route there, which no golden locus reaches),
# and those its STEP 4 launches
STEP2_KERNELS = ("kband", "nw", "gap", "rowmin")
FP32_OPS_PER_S = 67e12   # H100 SXM data sheet, float32 outside the MMA
STEP4_KERNELS = ("pwm", "edit_score")
# the golden loci with inputs, phase 11's sweep
SWEEP_CASES = ("test-788", "test-AMBN", "test-CPB2", "test-TP53",
               "test-issue-2", "test-issue-13", "test-mattia1",
               "test-mattia3", "test_gtf5")
KERNELS = {
    "kband": ("pintron_tpu_torch/csrc/kband.cu",
              "pintron_tpu/ops/pallas_align.py:67"),
    "edit_score": ("pintron_tpu_torch/csrc/rowmin.cu",
                   "pintron_tpu/ops/align.py:144"),
    "nw": ("pintron_tpu_torch/csrc/nw.cu", "pintron_tpu/ops/align.py:242"),
    "gap": ("pintron_tpu_torch/csrc/gap.cu", "pintron_tpu/ops/align.py:354"),
    "rowmin": ("pintron_tpu_torch/csrc/rowmin.cu",
               "pintron_tpu/ops/align.py:177"),
    "pwm": ("pintron_tpu_torch/csrc/pwm.cu", "pintron_tpu/ops/pwm.py:48"),
}


def phase(name):
    print(f"== {name}", flush=True)


def bound(nbytes, ops, ops_per_s):
    """(least ms, "bytes" or "operations") of a call that moves nbytes
    and does ops operations of a type with peak rate ops_per_s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_kband_batch(rng, B, n_cols, m_cols, k_max, masked=False):
    """Seeded K-band batch with the edge cases: len1 - len2 == band,
    rows past len2, 2k+1 >= n, masked bytes and bytes >= 128."""
    alpha = np.frombuffer(b"ACGT", dtype=np.int8)
    if masked:
        alpha = np.concatenate([alpha, np.frombuffer(b"N*#n", np.int8),
                                np.array([-56, -1], dtype=np.int8)])
    s1 = alpha[rng.integers(0, len(alpha), (B, n_cols))]
    s2 = np.zeros((B, m_cols), dtype=np.int8)
    len1 = np.zeros(B, dtype=np.int32)
    len2 = np.zeros(B, dtype=np.int32)
    band = rng.integers(1, k_max + 1, B).astype(np.int32)
    for b in range(B):
        m = int(rng.integers(1, m_cols + 1))
        mode = b % 4
        d = int(band[b]) if mode == 0 else int(rng.integers(0, band[b] + 1))
        if mode == 2:  # band covers the matrix
            m = int(rng.integers(1, max(2, 2 * band[b])))
            d = int(rng.integers(0, band[b] + 1))
        n = min(m + d, n_cols)
        m = min(m, n)
        row = s1[b, :m].copy()
        for _ in range(int(rng.integers(0, 1 + m // 8))):
            row[rng.integers(0, m)] = alpha[rng.integers(0, len(alpha))]
        s2[b, :m] = row
        len1[b], len2[b] = n, m
    return s1, len1, s2, len2, band


def cuda_ms(fn, reps):
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


def compare(name, kernel, plain, batch, kw, dev):
    """Run kernel and plain version on the card; exact equality."""
    args = from_numpy_batch(*batch[:4], *batch[4:], device=dev)
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        bad = int((got != want).sum().item())
        raise AssertionError(f"{name}: kernel != plain on {bad} of "
                             f"{got.numel()} problems")
    return err, args


def random_pair_batch(rng, B, N, M):
    """Seeded (est, gen) batch: N/n wildcards, e == g, single
    characters, empty windows, windows shorter than the padding, and gen
    as est with an intron inserted."""
    alpha = np.frombuffer(b"ACGTNn", dtype=np.int8)
    est = alpha[rng.integers(0, 6, (B, N))]
    gen = alpha[rng.integers(0, 4, (B, M))]
    elen = rng.integers(0, N + 1, B).astype(np.int32)
    glen = rng.integers(0, M + 1, B).astype(np.int32)
    for b in range(B):
        n = int(elen[b])
        mode = b % 5
        if mode == 0:                     # gen = est + intron
            cut = int(rng.integers(0, n + 1))
            intron = alpha[rng.integers(0, 4, int(rng.integers(0, M // 2
                                                                  + 1)))]
            seq = np.concatenate([est[b, :cut], intron, est[b, cut:n]])[:M]
        elif mode == 1:                   # e == g
            seq = est[b, :min(n, M)]
        elif mode == 2:                   # single characters
            elen[b] = min(1, N)
            seq = gen[b, :int(rng.integers(1, 3))]
        else:
            continue
        gen[b, :len(seq)] = seq
        glen[b] = len(seq)
    return est, elen, gen, glen


def compare_all(name, got, want, live=None):
    """Exact equality of every output tensor of a kernel with its plain
    version (``live`` masks rows that the contract leaves unspecified);
    returns the largest absolute difference."""
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if live is not None:
            g, w = g[live], w[live]
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max().item()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel != plain on "
                                 f"{int((g != w).sum().item())} entries")
    return err


def phase_traceback_kernels(dev, gpu, clock):
    from pintron_tpu_torch.ops import align, traceback
    rng = np.random.default_rng(20251016)
    tb = {"nw": (traceback.batch_nw_traceback_cuda, align.batch_nw_traceback),
          "gap": (traceback.batch_gap_traceback_cuda,
                  align.batch_gap_traceback)}
    errs = {"nw": 0, "gap": 0, "rowmin": 0}
    times = {}

    def run_tb(name, B, N, M):
        args = from_numpy_batch(*random_pair_batch(rng, B, N, M),
                                device=dev)
        kernel, plain = tb[name]
        kw = dict(max_n=N, max_m=M)
        errs[name] = max(errs[name], compare_all(
            name, kernel(*args, **kw), plain(*args, **kw)))

    def run_rowmin(B, N, M):
        # (text, pattern) = (gen, est) windows, rows past len2 unspecified
        est, elen, gen, glen = from_numpy_batch(
            *random_pair_batch(rng, B, M, N), device=dev)
        args, kw = (gen, glen, est, elen), dict(max_rows=M)
        errs["rowmin"] = max(errs["rowmin"], compare_all(
            "rowmin", traceback.batch_edit_rowmin_cuda(*args, **kw),
            align.batch_edit_rowmin(*args, **kw), rowmin_live(elen, M)))

    # edge cases: odd widths, the widest row a kernel takes; ests and
    # patterns of one pass and of several, the last pass of a few rows;
    # gen windows and texts narrower than a warp
    for B, N, M in ((37, 24, 37), (100, 64, 256), (33, 300, 1000),
                    (5, 2000, 9000), (3, 40, 16384), (9, 530, 700),
                    (40, 30, 16), (10, 100, 20)):
        run_tb("nw", B, N, M)
        run_tb("gap", B, N, M)
    for B, N, M in ((37, 37, 24), (50, 1024, 64), (7, 16384, 40),
                    (33, 300, 700), (146, 64, 64)):
        run_rowmin(B, N, M)
    print("edge-case batches: nw, gap and rowmin kernels == plain on "
          "every problem", flush=True)
    # the shapes the loci give the kernels: the 21 NW, the 8 gap and the
    # 24 rowmin launches of STEP 2 on TP53 and issue-13, and the (64,
    # 256) gap bucket at one random batch of 788
    for key in ("nw", "gap", "rowmin"):
        errs[key] = max(errs[key], main_path_launches(key, dev, gpu, clock,
                                                      times))
    run_tb("gap", 788, 64, 256)
    errs["nw"] = max(errs["nw"], oversized_nw_launches(dev, gpu, clock,
                                                       times))
    return errs, times


def oversized_nw_launches(dev, gpu, clock, times):
    """nw_kernel at the launches STEP 2 gives it on 788, issue-2,
    issue-13 and gtf5 (measure_nw.OVERSIZED_NW_SHAPES: the loci whose
    endpoint problems over the JAX package's bound go to the card), each
    equal to the plain version on every problem (score, ops and steps),
    its call and its time on the card alone beside its problems, bound
    and chain floor on a line; times["nw_oversized"] gets the sums.
    Returns the largest difference from the plain version."""
    from pintron_tpu_torch.measure_nw import (OVERSIZED_NW_SHAPES,
                                              main_path_nw_batch, nw_bound)
    from pintron_tpu_torch.ops import align, traceback
    kernel = traceback.batch_nw_traceback_cuda
    total = dict.fromkeys(("ms", "device_ms", "plain_ms", "bound_ms",
                           "chain_floor_ms"), 0.0)
    err = 0
    for i, shape in enumerate(OVERSIZED_NW_SHAPES):
        est, elen, gen, glen, N, M = main_path_nw_batch(shape, i)
        args = from_numpy_batch(est, elen, gen, glen, device=dev)
        kw = dict(max_n=N, max_m=M)
        err = max(err, compare_all("nw", kernel(*args, **kw),
                                   align.batch_nw_traceback(*args, **kw)))
        row = {"ms": cuda_ms(lambda: kernel(*args, **kw), 5),
               "device_ms": device_ms(lambda: kernel(*args, **kw), 5),
               "plain_ms": cuda_ms(
                   lambda: align.batch_nw_traceback(*args, **kw), 1)}
        row["bound_ms"], by, row["chain_floor_ms"] = nw_bound(elen, glen,
                                                              clock)
        for k, v in row.items():
            total[k] += v
        print(f"nw oversized {shape[0]} ({shape[1]} problems a launch, "
              f"bucket ({N}, {M}), longest {int(elen.max())} x "
              f"{int(glen.max())}): kernel {row['ms']:.4f} ms, on the card "
              f"alone {row['device_ms']:.4f} ms, plain {row['plain_ms']:.3f} "
              f"ms, bound {row['bound_ms']:.5f} ms ({by}), chain floor "
              f"{row['chain_floor_ms']:.5f} ms  [{gpu}]", flush=True)
    times["nw_oversized"] = dict(total, launches=len(OVERSIZED_NW_SHAPES))
    print(f"nw: the {len(OVERSIZED_NW_SHAPES)} launches of 788, issue-2, "
          f"issue-13 and gtf5 == plain on every problem; kernel "
          f"{total['ms']:.4f} ms in all, on the card alone "
          f"{total['device_ms']:.4f} ms, plain {total['plain_ms']:.3f} ms, "
          f"bound {total['bound_ms']:.5f} ms, chain floor "
          f"{total['chain_floor_ms']:.5f} ms  [{gpu}]", flush=True)
    return err


def main_path_launches(key, dev, gpu, clock, times):
    """nw_kernel, gap_kernel or rowmin_kernel at the launches STEP 2
    gives it on TP53 and issue-13 (pintron_tpu_torch.measure_nw's 21,
    measure_gap's 8, measure_rowmin's 24), each equal to the plain
    version on every problem (rowmin: on its live rows) and timed back
    to back and on the card alone; times[key] gets the sums.  Returns
    the largest difference from the plain version."""
    from pintron_tpu_torch.ops import align, traceback
    if key == "nw":
        from pintron_tpu_torch.measure_nw import (
            MAIN_PATH_NW_SHAPES as shapes, main_path_nw_batch as make,
            nw_bound as bound_fn)
    elif key == "gap":
        from pintron_tpu_torch.measure_gap import (
            MAIN_PATH_GAP_SHAPES as shapes, main_path_gap_batch as make,
            gap_bound as bound_fn)
    else:
        from pintron_tpu_torch.measure_rowmin import (
            MAIN_PATH_RB_SHAPES as shapes, main_path_rb_batch as make,
            rb_bound as bound_fn)
    kernel, plain = ((traceback.batch_edit_rowmin_cuda,
                      align.batch_edit_rowmin) if key == "rowmin" else
                     (getattr(traceback, f"batch_{key}_traceback_cuda"),
                      getattr(align, f"batch_{key}_traceback")))
    total = [0.0, 0.0, 0.0, 0.0, 0.0]
    by_main, err = {}, 0
    for i, shape in enumerate(shapes):
        if key == "rowmin":
            # (text, pattern) as (seq1, seq2), compared on rows 0..len2;
            # elen and glen name the text and pattern lengths here
            s1, elen, s2, glen, M = make(shape, i)
            args = from_numpy_batch(s1, elen, s2, glen, device=dev)
            kw, N, live = dict(max_rows=M), s1.shape[1], rowmin_live(
                args[3], M)
        else:
            est, elen, gen, glen, N, M = make(shape, i)
            args = from_numpy_batch(est, elen, gen, glen, device=dev)
            kw, live = dict(max_n=N, max_m=M), None
        err = max(err, compare_all(key, kernel(*args, **kw),
                                   plain(*args, **kw), live))
        ms = cuda_ms(lambda: kernel(*args, **kw), 10)
        dms = device_ms(lambda: kernel(*args, **kw), 10)
        pms = cuda_ms(lambda: plain(*args, **kw), 1)
        b_ms, by, chain = bound_fn(elen, glen, clock)
        by_main[by] = by_main.get(by, 0.0) + b_ms
        for j, v in enumerate((ms, pms, b_ms, chain, dms)):
            total[j] += v
        print(f"{key} main path {shape[0]} (B {shape[1]}, bucket ({N}, "
              f"{M}), longest {int(elen.max())} x {int(glen.max())}): "
              f"kernel {ms:.4f} ms, on the card alone {dms:.4f} ms, plain "
              f"{pms:.3f} ms, bound {b_ms:.5f} ms ({by}), chain floor "
              f"{chain:.5f} ms  [{gpu}]", flush=True)
    times[key] = (total[0], total[1], total[2],
                  max(by_main, key=by_main.get), total[3], None, total[4],
                  None)
    print(f"{key}: the {len(shapes)} main-path launches == plain on every "
          f"problem; kernel {total[0]:.4f} ms in all, on the card alone "
          f"{total[4]:.4f} ms, plain {total[1]:.3f} ms, bound "
          f"{total[2]:.5f} ms, chain floor {total[3]:.5f} ms  [{gpu}]",
          flush=True)
    return err


def phase_kernels(dev, gpu, clock):
    from pintron_tpu_torch.ops import align, kband
    rng = np.random.default_rng(20240917)
    errs = {"kband": 0, "edit_score": 0}
    # edge cases: small, B not a multiple of the 4 warps a block, masked
    # bytes, and every band width the warp layout instantiates (CPL 1,
    # 2, 4, 8, 16, 17 and 33 cells a lane: W = 5, 31, 33, 65, 129, 257,
    # 513, 1025)
    for B, n_cols, m_cols, k_max in ((77, 96, 64, 8), (300, 1024, 256, 16),
                                     (129, 4096, 1024, 64), (33, 64, 40, 2),
                                     (65, 128, 64, 15), (31, 256, 200, 32),
                                     (17, 700, 600, 128), (9, 1400, 1100, 256),
                                     (5, 600, 520, 256),
                                     (5, 1600, 1100, 512)):
        batch = random_kband_batch(rng, B, n_cols, m_cols, k_max,
                                   masked=True)
        e, _ = compare("kband", kband.banded_edit_distance_cuda,
                       align.banded_edit_distance, batch,
                       dict(max_rows=m_cols, k_max=k_max), dev)
        errs["kband"] = max(errs["kband"], e)
        e, _ = compare("edit_score", kband.batch_edit_distance_score_cuda,
                       align.batch_edit_distance_score, batch[:4],
                       dict(max_rows=m_cols), dev)
        errs["edit_score"] = max(errs["edit_score"], e)
    print(f"edge-case batches: kernel == plain on every problem",
          flush=True)

    times = {}
    # production shape of the round-5 stress batch: (B, rows, W) =
    # (32768, 256, 33)
    B, rows, k_max = 32768, 256, 16
    batch = random_kband_batch(rng, B, 1024, rows, k_max)
    kw = dict(max_rows=rows, k_max=k_max)
    e, args = compare("kband", kband.banded_edit_distance_cuda,
                      align.banded_edit_distance, batch, kw, dev)
    errs["kband"] = max(errs["kband"], e)
    ms = cuda_ms(lambda: kband.banded_edit_distance_cuda(*args, **kw), 10)
    pms = cuda_ms(lambda: align.banded_edit_distance(*args, **kw), 3)
    b_ms, by, chain = kband_bound(batch[1], batch[3], batch[4], rows, clock)
    cells = B * rows * (2 * k_max + 1)
    print(f"kband (B, rows, W) = ({B}, {rows}, {2 * k_max + 1}): kernel "
          f"{ms:.3f} ms = {cells / ms / 1e6:.3f} Gcells/s, plain "
          f"{pms:.3f} ms, bound {b_ms:.5f} ms ({by}), chain floor "
          f"{chain:.5f} ms  [{gpu}]", flush=True)

    # the 12 launches STEP 2 gives the kernel on TP53 and issue-13
    total = [0.0, 0.0, 0.0, 0.0]
    by_main = {}
    for i, shape in enumerate(MAIN_PATH_SHAPES):
        s1, l1, s2, l2, band, max_rows, k_max = main_path_batch(shape, i)
        kw = dict(max_rows=max_rows, k_max=k_max)
        e, args = compare("kband", kband.banded_edit_distance_cuda,
                          align.banded_edit_distance,
                          (s1, l1, s2, l2, band), kw, dev)
        errs["kband"] = max(errs["kband"], e)
        ms = cuda_ms(lambda: kband.banded_edit_distance_cuda(*args, **kw),
                     20)
        pms = cuda_ms(lambda: align.banded_edit_distance(*args, **kw), 1)
        b_ms, by, chain = kband_bound(l1, l2, band, max_rows, clock)
        by_main[by] = by_main.get(by, 0.0) + b_ms
        for j, v in enumerate((ms, pms, b_ms, chain)):
            total[j] += v
        print(f"kband main path {shape[0]} (live {shape[1]}, B {shape[2]}, "
              f"N {shape[3]}, rows {int(l2.max())}/{max_rows}, W "
              f"{2 * k_max + 1}): kernel {ms:.4f} ms, plain {pms:.3f} ms, "
              f"bound {b_ms:.5f} ms ({by}), chain floor {chain:.5f} ms  "
              f"[{gpu}]", flush=True)
    # what bounds the sum: the kind that bounds the most of it
    times["kband"] = (total[0], total[1], total[2],
                      max(by_main, key=by_main.get), total[3])
    print(f"kband: the 12 main-path shapes == plain on every problem; "
          f"kernel {total[0]:.4f} ms in all, plain {total[1]:.3f} ms, "
          f"bound {total[2]:.5f} ms, chain floor {total[3]:.5f} ms  "
          f"[{gpu}]", flush=True)

    # the full-matrix batch the offload forms from noisy-exon checks:
    # ub = ceil(0.04 n) >= 1 covers the matrix (2ub+1 >= n) only for
    # n <= 3, so B = 64 (the smallest bucket), N = 1024, rows _p4(m) = 16
    B, N, M = 64, 1024, 16
    batch = random_kband_batch(rng, B, N, M, 1)
    kw = dict(max_rows=M)
    e, args = compare("edit_score", kband.batch_edit_distance_score_cuda,
                      align.batch_edit_distance_score, batch[:4], kw, dev)
    errs["edit_score"] = max(errs["edit_score"], e)
    ms = cuda_ms(lambda: kband.batch_edit_distance_score_cuda(*args, **kw),
                 10)
    pms = cuda_ms(lambda: align.batch_edit_distance_score(*args, **kw), 3)
    print(f"edit_score (B, N, rows) = ({B}, {N}, {M}): kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms  [{gpu}]", flush=True)
    kb_err, edit_err = wide_budgets(dev, gpu)
    errs["kband"] = max(errs["kband"], kb_err)
    errs["edit_score"] = max(errs["edit_score"], edit_err)
    return errs, times


def wide_budgets(dev, gpu):
    """K-band budgets of 257 to 512 (exons of about 8.5 to 17 kb, whose
    budget is 3% of their length): kband_kernel at k_max 512 (33 cells
    a lane) equal to the plain version, and edit_score_kernel, the
    full-matrix route such budgets took before, giving the same
    verdicts; then both timed on four exons of about 9 kb, where
    edit_score_kernel runs at full length, equal to its plain version.
    Returns the largest differences from the plain versions,
    (kband, edit_score)."""
    from pintron_tpu_torch.ops import align, kband
    (s1, l1, s2, l2, band, M), exons = wide_budget_batches()
    kw = dict(max_rows=M, k_max=512)
    err, args = compare("kband", kband.banded_edit_distance_cuda,
                        align.banded_edit_distance,
                        (s1, l1, s2, l2, band), kw, dev)
    dist = kband.banded_edit_distance_cuda(*args, **kw)
    full = kband.batch_edit_distance_score_cuda(*args[:4], max_rows=M)
    ok_band = (dist <= args[4]).cpu().numpy()
    ok_full = (full <= args[4]).cpu().numpy()
    if not np.array_equal(ok_band, ok_full):
        raise AssertionError("kband_kernel and edit_score_kernel verdicts "
                             "differ at budgets 257-512")
    print(f"kband (B, len1, ub) = (8, {int(l1.min())}-{int(l1.max())}, "
          f"{int(band.min())}-{int(band.max())}), k_max 512: kernel == "
          f"plain; edit_score_kernel's verdicts equal "
          f"({int(ok_band.sum())} of 8 pass)", flush=True)

    # the shape of a real 9 kb exon: budget 3%, about 270
    s1, l1, s2, l2, band, M = exons
    args = from_numpy_batch(s1, l1, s2, l2, band, device=dev)
    band_ms = cuda_ms(lambda: kband.banded_edit_distance_cuda(
        *args, max_rows=M, k_max=512), 3)
    dist = kband.banded_edit_distance_cuda(*args, max_rows=M, k_max=512)
    # a guard: time edit_score_kernel at a quarter of the length first,
    # and at the full length only if that would take at most 5 s
    cut = 4
    q = (s1[:, :s1.shape[1] // cut].copy(), l1 // cut,
         s2[:, :M // cut].copy(), l2 // cut)
    qargs = from_numpy_batch(*q, device=dev)
    q_ms = cuda_ms(lambda: kband.batch_edit_distance_score_cuda(
        *qargs, max_rows=M // cut), 1)
    if q_ms * cut * cut > 5000:
        raise AssertionError(f"edit_score_kernel took {q_ms:.3f} ms at a "
                             f"quarter of the 9 kb exons, so about "
                             f"{q_ms * cut * cut:.0f} ms at full length")
    full_ms = cuda_ms(lambda: kband.batch_edit_distance_score_cuda(
        *args[:4], max_rows=M), 3)
    full = kband.batch_edit_distance_score_cuda(*args[:4], max_rows=M)
    want = align.batch_edit_distance_score(*args[:4], max_rows=M)
    edit_err = compare_all("edit_score", (full,), (want,))
    if not torch.equal(full <= args[4], dist <= args[4]):
        raise AssertionError("kband_kernel and edit_score_kernel verdicts "
                             "differ on the 9 kb exons")
    full_txt = (f"edit_score_kernel at full length {full_ms:.3f} ms, == "
                f"plain, verdicts equal")
    print(f"budgets of a 9 kb exon (B, len1, ub) = (4, {int(l1.min())}-"
          f"{int(l1.max())}, {int(band.min())}-{int(band.max())}): "
          f"kband_kernel (k_max 512) {band_ms:.3f} ms, {full_txt}; "
          f"edit_score_kernel at a quarter of the lengths {q_ms:.3f} ms  "
          f"[{gpu}]", flush=True)
    return err, edit_err


def random_windows(rng, B):
    """Seeded BPS windows: codes 0..3 (N is coded 0), runs of one base,
    and a few codes outside 0..3, which add nothing."""
    codes = rng.integers(0, 4, (B, 12)).astype(np.int8)
    codes[::5] = codes[::5, :1]
    odd = rng.random((B, 12)) < 0.01
    codes[odd] = rng.choice(np.array([-1, 4, 9, -128], dtype=np.int8),
                            int(odd.sum()))
    return codes


def phase_stage4_kernels(dev, gpu, clock):
    """pwm_kernel bit for bit against its plain version, timed beside
    F.conv1d over the one-hot codes (the one PyTorch call that computes
    the same scores; the port never calls it), and edit_score_kernel at
    the shape STEP 4 gives it."""
    from pintron_tpu_torch.ops import align, kband, pwm
    rng = np.random.default_rng(20261016)
    err = 0.0
    for name in ("BPS_9", "BPS_10"):
        wpwm, den = pwm.pwm_tables(name)
        w = torch.from_numpy(wpwm).to(dev)
        for B in (1, 31, 33, 1000, 8425):
            c = torch.from_numpy(random_windows(rng, B)).to(dev)
            got = pwm.pwm_scores_cuda(c, w, den)
            want = pwm.pwm_scores(c, w, den)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pwm {name} B={B}: kernel != plain on "
                                     f"{int((got != want).sum())} windows")
            err = max(err, float((got - want).abs().max()))
    # views off a word boundary, and widths under, over and far over the
    # loop's unrolled BPS width
    for B, L, skew in ((8425, 12, 1), (1000, 7, 0), (300, 13, 3),
                       (64, 300, 0)):
        wl = torch.from_numpy(rng.random((4, L)).astype(np.float32)).to(dev)
        flat = torch.from_numpy(rng.integers(-1, 5, B * L + skew)
                                .astype(np.int8)).to(dev)
        c = flat[skew:].view(B, L)
        got = pwm.pwm_scores_cuda(c, wl, 3.25)
        want = pwm.pwm_scores(c, wl, 3.25)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"pwm B={B} L={L} skew {skew}: kernel != "
                                 f"plain on {int((got != want).sum())} "
                                 "windows")
    print("pwm_kernel == plain, bit for bit, on every window", flush=True)
    # the issue-13 sweep's batch per matrix: 8425 windows of 12 bases
    wpwm, den = pwm.pwm_tables("BPS_9")
    w = torch.from_numpy(wpwm).to(dev)
    c = torch.from_numpy(random_windows(rng, 8425)).to(dev)
    # the yardstick: one F.conv1d of the (B, 4, L) one-hot windows with
    # the weights over the denominator, in full float32 (cuDNN's TF32
    # off), made ready outside the timing
    torch.backends.cudnn.allow_tf32 = False
    onehot = torch.nn.functional.one_hot(
        torch.where((c >= 0) & (c < 4), c.long(), 4), 5)[..., :4]
    onehot = onehot.permute(0, 2, 1).to(torch.float32).contiguous()
    weight = (w / torch.tensor(den, dtype=torch.float32, device=dev))[None]
    conv = torch.nn.functional.conv1d(onehot, weight)[:, 0, 0]
    torch.cuda.synchronize()
    conv_err = float((conv - pwm.pwm_scores_cuda(c, w, den)).abs().max())
    lib_ms = cuda_ms(lambda: torch.nn.functional.conv1d(onehot, weight),
                     50)
    ms = cuda_ms(lambda: pwm.pwm_scores_cuda(c, w, den), 50)
    lib_ms2 = cuda_ms(lambda: torch.nn.functional.conv1d(onehot, weight),
                      50)
    ms2 = cuda_ms(lambda: pwm.pwm_scores_cuda(c, w, den), 50)
    pms = cuda_ms(lambda: pwm.pwm_scores(c, w, den), 10)
    # the card's own time of each: the calls queued behind a sleep of the
    # stream, so the host's dispatch is off the clock
    dev_ms = device_ms(lambda: pwm.pwm_scores_cuda(c, w, den), 50)
    lib_dev_ms = device_ms(
        lambda: torch.nn.functional.conv1d(onehot, weight), 50)
    B, L = c.shape
    # bytes: the codes and the weights in, the scores out; one add a
    # base, over the float32 peak
    b_ms, by = bound(B * L + 4 * 4 * L + 4 * B, B * L, FP32_OPS_PER_S)
    print(f"pwm (B, L) = ({B}, {L}): kernel {ms:.4f} / {ms2:.4f} ms, "
          f"F.conv1d {lib_ms:.4f} / {lib_ms2:.4f} ms (largest difference "
          f"{conv_err:.3g}), plain {pms:.4f} ms, bound {b_ms:.6f} ms ({by})"
          f"; on the card alone: kernel {dev_ms:.4f} ms, F.conv1d "
          f"{lib_dev_ms:.4f} ms  [{gpu}]", flush=True)
    times = {"pwm": (min(ms, ms2), pms, b_ms, by, None,
                     min(lib_ms, lib_ms2), dev_ms, lib_dev_ms)}
    # the edit stats' batch: issue-13's 222 unequal window pairs padded
    # to 256, both windows at most 15 nt, so one (16, 16) bucket
    B, N, M = 256, 16, 16
    batch = random_kband_batch(rng, B, N, M, 4, masked=True)
    kw = dict(max_rows=M)
    e, args = compare("edit_score", kband.batch_edit_distance_score_cuda,
                      align.batch_edit_distance_score, batch[:4], kw, dev)
    ms = cuda_ms(lambda: kband.batch_edit_distance_score_cuda(*args, **kw),
                 50)
    pms = cuda_ms(lambda: align.batch_edit_distance_score(*args, **kw), 10)
    b_ms, by, chain = edit_bound(batch[1], batch[3], clock)
    times["edit_score"] = (ms, pms, b_ms, by, chain)
    print(f"edit_score (B, N, rows) = ({B}, {N}, {M}), the STEP 4 shape: "
          f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.6f} ms "
          f"({by}), chain floor {chain:.5f} ms  [{gpu}]", flush=True)
    return {"pwm": err, "edit_score": e}, times


def unpack_golden(case, dest):
    with tarfile.open(os.path.join(GOLDEN, f"{case}.tar.gz")) as tf:
        tf.extractall(dest)


def host_ep_kband_ok(lib, g, e, ub):
    """ep_kband's ok flag (dp.c) from the native scalar kernels."""
    if len(g) == len(e) and g == e:
        return 1
    if ub == 0:
        return 0
    a, b = (g, e) if len(g) >= len(e) else (e, g)
    n, m = len(a), len(b)
    if n - m > ub:
        return 0
    if 2 * ub + 1 >= n:
        return int(int(lib.edit_total(a, n, b, m)) <= ub)
    r = int(lib.kband_core(a, n, b, m, ub))
    return int(0 <= r <= ub)


def offload_problem_mix(rng):
    """K-band problems of every ep_kband route, full-matrix ones
    included (the noisy-exon checks of real loci reach that route only
    for exons of at most 3 nt)."""
    alpha = np.array(list("ACGTN*#n"))
    probs = []
    for i in range(400):
        n = int(rng.integers(1, 300)) if i % 2 else int(rng.integers(1, 12))
        g = "".join(rng.choice(alpha[:4], n))
        el = list(g)
        for _ in range(int(rng.integers(0, 6))):
            el[int(rng.integers(0, n))] = str(rng.choice(alpha))
        e = "".join(el)[: max(1, n - int(rng.integers(0, 4)))]
        probs.append((g.encode(), e.encode(), int(rng.integers(0, 12))))
    return probs


def pair_mix(rng):
    """(est_window, gen_window) problems of every offload route: e == g,
    gen as est with an intron inserted, unrelated pairs, N/n wildcards,
    several buckets, one pair over the JAX package's bound (2^21 cells)
    that the kernels take, and one wider than the kernels' MAX_WIDTH,
    left to the host."""
    alpha = np.array(list("ACGTNn"))
    probs = []
    for i in range(240):
        e = "".join(rng.choice(alpha, int(rng.integers(1, 120))))
        if i % 3 == 0:
            g = e
        elif i % 3 == 1:
            cut = int(rng.integers(0, len(e) + 1))
            g = e[:cut] + "".join(rng.choice(alpha[:4],
                                             int(rng.integers(0, 900)))) \
                + e[cut:]
        else:
            g = "".join(rng.choice(alpha, int(rng.integers(1, 400))))
        probs.append((e, g))
    probs.append(("".join(rng.choice(alpha[:4], 2500)),
                  "".join(rng.choice(alpha[:4], 2500))))
    probs.append(("".join(rng.choice(alpha[:4], 200)),
                  "".join(rng.choice(alpha[:4], 17000))))
    return probs


def check_family_mix(offload, probs):
    """eval_nw, eval_gap and eval_rb on a problem mix against the host
    C DPs (none of them imports JAX)."""
    from pintron_tpu_torch.factorize.alignments import (
        _compute_alignment_uncached, edit_distance_full)
    from pintron_tpu_torch.factorize.gap_align import \
        _compute_gap_alignment_uncached
    from pintron_tpu_torch.ops.align import (gap_traceback_decode,
                                             nw_traceback_decode)
    raw = [(e.encode(), g.encode()) for e, g in probs]
    small = [offload.traceback_fits(e, g) for e, g in raw]
    if all(small):
        raise AssertionError("the mix has no problem over the bound")
    ops, nsteps, ev = offload.eval_nw(raw)
    if ev.tolist() != small:
        raise AssertionError("eval_nw: wrong problems evaluated")
    sm, gops, gsteps, gev = offload.eval_gap(raw)
    if gev.tolist() != small:
        raise AssertionError("eval_gap: wrong problems evaluated")
    for i, (e, g) in enumerate(probs):
        if not small[i]:
            continue
        ref = _compute_alignment_uncached(e, g)
        if nw_traceback_decode(e, g, ops[i], nsteps[i]) != (ref.est,
                                                             ref.gen):
            raise AssertionError(f"eval_nw != nw_align_run on problem {i}")
        ref = _compute_gap_alignment_uncached(e, g)
        if gap_traceback_decode(e, g, sm[i], gops[i], gsteps[i]) != (
                ref.est, ref.gen, ref.factor_cut, ref.intron_start,
                ref.intron_end, ref.intron_start_on_align,
                ref.intron_end_on_align):
            raise AssertionError(f"eval_gap != gap_align_run on problem {i}")
    rb = [(g, e) for e, g in raw[:200]]
    vals, pos, rev = offload.eval_rb(rb)
    if not rev.all():
        raise AssertionError("eval_rb left a small problem unevaluated")
    for i, (t, p) in enumerate(rb):
        M = edit_distance_full(t.decode(), p.decode())
        if (vals[i, :len(p) + 1].tolist() != M.min(axis=1).tolist()
                or pos[i, :len(p) + 1].tolist()
                != M.argmin(axis=1).tolist()):
            raise AssertionError(f"eval_rb != edit_matrix rows on "
                                 f"problem {i}")


def phase_main_path(dev, gpu):
    from pintron_tpu_torch.native import dp_census, dp_census_reset, get_lib
    from pintron_tpu_torch.ops import limits, offload
    from pintron_tpu_torch.stages.est_fact import run_est_fact

    os.environ["PINTRON_FRESH_MEMO"] = "1"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        works = {}
        for case in ("test-TP53", "test-issue-13"):
            gold = os.path.join(tmp, "gold-" + case)
            work = os.path.join(tmp, "work-" + case)
            os.makedirs(work)
            unpack_golden(case, gold)
            for fn in ("genomic.txt", "ests.txt"):
                shutil.copy(os.path.join(gold, fn), work)
            works[case] = (gold, work)
        lib = get_lib()
        mix = offload_problem_mix(np.random.default_rng(11))
        want_mix = [host_ep_kband_ok(lib, g, e, ub) for g, e, ub in mix]

        offload.set_device(dev)
        limits.reset_launches()      # the main path's run starts here
        per_case = {}
        for case, (gold, work) in works.items():
            offload.reset_stats()
            dp_census_reset()
            before = dict(limits.LAUNCHES)
            t0 = time.perf_counter()
            run_est_fact(work, device=dev)
            dt = time.perf_counter() - t0
            per_case[case] = (dt, dict(offload.STATS), dp_census() or {},
                              {k: limits.LAUNCHES[k] - before[k]
                               for k in before})
        launches = dict(limits.LAUNCHES)     # ... and ends here
        limits.reset_launches()
        got_mix = offload.eval_kband(mix)
        check_family_mix(offload, pair_mix(np.random.default_rng(12)))
        mix_launches = dict(limits.LAUNCHES)

        if [int(v) for v in got_mix] != want_mix:
            raise AssertionError("eval_kband verdicts differ from ep_kband")
        if min(mix_launches[k] for k in STEP2_KERNELS + ("edit_score",)) <= 0:
            raise AssertionError(f"the problem mix left a kernel "
                                 f"unlaunched: {mix_launches}")
        print(f"eval_kband on {len(mix)} mixed problems == native "
              f"ep_kband; eval_nw, eval_gap and eval_rb on mixes == "
              f"nw_align_run, gap_align_run and edit_matrix; launches "
              f"{mix_launches}", flush=True)
        for case, (dt, stats, census, lc) in per_case.items():
            gold, work = works[case]
            for name in STAGE2_ARTIFACTS:
                with open(os.path.join(gold, name), "rb") as f:
                    g = f.read()
                with open(os.path.join(work, name), "rb") as f:
                    w = f.read()
                if g != w:
                    raise AssertionError(f"{case}: {name} differs from "
                                         "golden")
            for fam, key in (("nw_problems", "nw"), ("gap_problems", "gap"),
                             ("rb_problems", "rowmin"),
                             ("device_problems", "kband")):
                if stats[fam] <= 0 or lc[key] <= 0:
                    raise AssertionError(f"{case}: {fam} or {key} launches "
                                         f"0 ({stats}, launches {lc})")
            with open(os.path.join(work, "ests.txt")) as f:
                n_ests = sum(1 for ln in f if ln.startswith(">"))
            host = sum(census.values())
            frac = stats["device_cells"] / (stats["device_cells"] + host)
            print(f"{case}: STEP 2 byte-identical to golden; {n_ests} ESTs "
                  f"in {dt:.3f} s = {n_ests / dt:.2f} ESTs/s; "
                  f"device_problems {stats['device_problems']}, "
                  f"device_cells {stats['device_cells']}, host DP cells "
                  f"{host} {census}, device share {frac:.4f}, nw/gap/rb "
                  f"problems {stats['nw_problems']}/{stats['gap_problems']}/"
                  f"{stats['rb_problems']}, launches {lc}  [{gpu}]",
                  flush=True)
        for key in STEP2_KERNELS:
            if launches[key] <= 0:
                raise AssertionError(f"{key}_kernel never launched on the "
                                     "main path")
        print(f"main path launches {launches}", flush=True)
        return launches, mix_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("PINTRON_FRESH_MEMO", None)


def phase_pipeline(dev, gpu):
    tmp = tempfile.mkdtemp(prefix="chip-smoke-e2e-")
    try:
        gold = os.path.join(tmp, "gold")
        work = os.path.join(tmp, "work")
        os.makedirs(work)
        unpack_golden("test-AMBN", gold)
        for fn in ("genomic.txt", "ests.txt"):
            shutil.copy(os.path.join(gold, fn), work)
        env = {k: v for k, v in os.environ.items() if k != "PINTRON_DEVICE"}
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "pintron_tpu_torch.pipeline",
             "--device", str(dev), "--workdir", work, "-g", "genomic.txt",
             "-s", "ests.txt", "-o", "full.json",
             "-t", "pintron-all-isoforms.gtf", "--gene=AMBN",
             "--organism=human", "-k"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if r.returncode:
            raise RuntimeError(f"pipeline rc={r.returncode}:\n"
                               f"{r.stderr[-3000:]}")
        flows = {}
        with open(os.path.join(work, "pintron-log.txt")) as f:
            for ln in f:
                for key in ("est-fact", "intron-agreement"):
                    tag = f"{key} device flow: "
                    if tag in ln:
                        flows[key] = json.loads(ln.split(tag, 1)[1])
        for key, kernels in (("est-fact", STEP2_KERNELS),
                             ("intron-agreement", STEP4_KERNELS)):
            if key not in flows or min(flows[key]["launches"][k]
                                       for k in kernels) <= 0:
                raise AssertionError(f"pipeline {key} did not launch "
                                     f"{kernels}: {flows.get(key)}")
        label = classify_e2e("AMBN", gold, work)
        print(f"AMBN full pipeline (--device cuda): {label} in {dt:.2f} s; "
              f"STEP 2 {flows['est-fact']}; STEP 4 "
              f"{flows['intron-agreement']}  [{gpu}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compare_files(case, gold, work, names, work_names=None):
    for name, wname in zip(names, work_names or names):
        with open(os.path.join(gold, name), "rb") as f:
            g = f.read()
        with open(os.path.join(work, wname), "rb") as f:
            w = f.read()
        if g != w:
            raise AssertionError(f"{case}: {wname} differs from {name}")


def phase_stage4(dev, gpu):
    """STEP 4 through the port on the card, from the goldens' STEP 3
    outputs; returns the path's kernel launches."""
    from pintron_tpu_torch.ops import limits, offload
    from pintron_tpu_torch.stages.intron_agreement import \
        run_intron_agreement
    tmp = tempfile.mkdtemp(prefix="chip-smoke-s4-")
    try:
        works = {}
        for case in ("test-TP53", "test-issue-13"):
            gold = os.path.join(tmp, "gold-" + case)
            work = os.path.join(tmp, "work-" + case)
            os.makedirs(work)
            unpack_golden(case, gold)
            for fn in STAGE4_INPUTS:
                shutil.copy(os.path.join(gold, fn), work)
            works[case] = (gold, work)
        limits.reset_launches()      # the STEP 4 path's run starts here
        per_case = {}
        for case, (gold, work) in works.items():
            offload.reset_stats()
            before = dict(limits.LAUNCHES)
            t0 = time.perf_counter()
            run_intron_agreement(work, device=dev)
            dt = time.perf_counter() - t0
            per_case[case] = (dt, dict(offload.STATS),
                              {k: limits.LAUNCHES[k] - before[k]
                               for k in before})
        launches = dict(limits.LAUNCHES)     # ... and ends here
        for case, (dt, stats, lc) in per_case.items():
            gold, work = works[case]
            compare_files(case, gold, work, STAGE4_FILES)
            if min(stats["pwm_windows"], stats["edit_problems"],
                   lc["pwm"], lc["edit_score"]) <= 0:
                raise AssertionError(f"{case}: STEP 4 left the card idle: "
                                     f"{stats}, launches {lc}")
            print(f"{case}: STEP 4 byte-identical to golden in {dt:.4f} s; "
                  f"pwm_windows {stats['pwm_windows']}, edit_problems "
                  f"{stats['edit_problems']}, launches {lc}  [{gpu}]",
                  flush=True)
        print(f"STEP 4 path launches {launches}", flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# a client of the device service: STEP 2 on one locus, sharded over
# PINTRON_EST_WORKERS fork workers; prints its log line and whether
# this process ever initialised CUDA
SERVICE_CLIENT = """
import json, logging, sys, time
import torch
from pintron_tpu_torch.stages.est_fact import run_est_fact
logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                    format="%(message)s")
t0 = time.perf_counter()
run_est_fact(sys.argv[1], device="cuda")
print(json.dumps({"seconds": time.perf_counter() - t0,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def classify_e2e(case, gold, work):
    from pintron_tpu_torch.regression import compare_outputs
    res = compare_outputs(work, gold)
    if res["json_byte"] and res["gtf_byte"]:
        return "byte-identical"
    if res["json_canonical"] and res["gtf_canonical"]:
        return "canonical"
    raise AssertionError(f"{case} full pipeline differs: {res}")


def phase_service(dev, gpu):
    from pintron_tpu_torch.batch import start_service, stop_service
    from pintron_tpu_torch.ops.offload import SERVICE_ENV
    tmp = tempfile.mkdtemp(prefix="chip-smoke-svc-")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PINTRON_DEVICE", SERVICE_ENV)}
    try:
        golds = {}
        for case in ("test-TP53", "test-AMBN"):
            golds[case] = os.path.join(tmp, "gold-" + case)
            unpack_golden(case, golds[case])
        work = os.path.join(tmp, "step2-TP53")
        os.makedirs(work)
        for fn in ("genomic.txt", "ests.txt"):
            shutil.copy(os.path.join(golds["test-TP53"], fn), work)
        t0 = time.perf_counter()
        proc, sock = start_service(str(dev))
        print(f"device service up in {time.perf_counter() - t0:.2f} s",
              flush=True)
        try:
            r = subprocess.run(
                [sys.executable, "-c", SERVICE_CLIENT, work], cwd=REPO,
                env=dict(env, **{SERVICE_ENV: sock,
                                 "PINTRON_EST_WORKERS": "8",
                                 "PINTRON_FRESH_MEMO": "1"}),
                capture_output=True, text=True, timeout=300)
        finally:
            report = stop_service(proc, sock)
        if r.returncode:
            raise RuntimeError(f"service client rc={r.returncode}:\n"
                               f"{r.stderr[-3000:]}")
        lines = r.stdout.strip().splitlines()
        flow = json.loads(next(ln for ln in lines if ln.startswith(
            "est-fact device flow: ")).split(": ", 1)[1])
        client = json.loads(lines[-1])
        compare_files("test-TP53 (service)", golds["test-TP53"], work,
                      STAGE2_ARTIFACTS)
        if client["cuda_initialized"] or flow["workers"] != 8:
            raise AssertionError(f"service client: {client}, {flow}")
        if report is None or min(report["launches"][k]
                                 for k in STEP2_KERNELS) <= 0:
            raise AssertionError(f"the service left a STEP 2 kernel "
                                 f"unlaunched: {report}")
        print(f"TP53 STEP 2, 8 fork workers through the service: byte-"
              f"identical in {client['seconds']:.3f} s = "
              f"{623 / client['seconds']:.2f} ESTs/s; client CUDA "
              f"initialised: {client['cuda_initialized']}; service "
              f"{report['stats']}, launches {report['launches']}  [{gpu}]",
              flush=True)

        # the batch driver: two loci through one service
        rows, host_rows = [], []
        for case, gene in (("test-AMBN", "AMBN"), ("test-TP53", "TP53")):
            g = golds[case]
            rows.append(f"{tmp}/batch-{case}\t{g}/genomic.txt\t"
                        f"{g}/ests.txt\t{gene}\thuman")
            if case == "test-TP53":
                host_rows.append(f"{tmp}/host-{case}\t{g}/genomic.txt\t"
                                 f"{g}/ests.txt\t{gene}\thuman")
        summaries = {}
        for name, body, extra in (("jobs.tsv", rows, ["--device", str(dev)]),
                                  ("host.tsv", host_rows,
                                   ["--device", "host"])):
            with open(os.path.join(tmp, name), "w") as f:
                f.write("\n".join(body) + "\n")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "pintron_tpu_torch.batch",
                 "--manifest", os.path.join(tmp, name), "--jobs", "2",
                 *extra], cwd=REPO, env=env, capture_output=True,
                text=True, timeout=600)
            if r.returncode:
                raise RuntimeError(f"batch {extra} rc={r.returncode}:\n"
                                   f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
            summaries[name] = json.loads(r.stdout.strip().splitlines()[-1])
            print(f"batch {' '.join(extra)}: {summaries[name]} "
                  f"in {time.perf_counter() - t0:.2f} s  [{gpu}]", flush=True)
        launches = summaries["jobs.tsv"]["service"]["launches"]
        if min(launches[k] for k in STEP2_KERNELS + STEP4_KERNELS) <= 0:
            raise AssertionError(f"the batch's service left a kernel "
                                 f"unlaunched: {launches}")
        work = f"{tmp}/batch-test-AMBN"
        os.replace(os.path.join(work, "pintron-full-output.json"),
                   os.path.join(work, "full.json"))
        label = classify_e2e("test-AMBN", golds["test-AMBN"], work)
        compare_files("test-TP53 (batch)", f"{tmp}/host-test-TP53",
                      f"{tmp}/batch-test-TP53",
                      ("pintron-full-output.json", "pintron-all-isoforms.gtf"))
        print(f"batch --device cuda: AMBN {label} against golden; TP53 "
              f"byte-identical to the --device host batch", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def step_bound(args, kw, clock):
    """The scoring step's bound on this batch: (ms, "bytes" or
    "operations", bytes, band cells, K-band chain floor ms).  Bytes:
    each problem's codes, lengths and band, the donor codes, the weights
    and the intron ids read once, the three outputs written once;
    operations: the band cells at OPS_PER_CELL integer operations and
    one compare and add a problem over the INT32 peak, one float32 add a
    donor base over the float32 peak."""
    from pintron_tpu_torch.measure_kband import (INT32_OPS_PER_S,
                                                 OPS_PER_CELL)
    _est, elen, _gen, glen, bands, donor, _w, _ids = args
    l1, l2 = glen.cpu().numpy(), elen.cpu().numpy()
    band = bands.cpu().numpy()
    B, L = donor.shape
    rows = np.minimum(l2.astype(np.int64), kw["max_rows"])
    cells = int((rows * (2 * band.astype(np.int64) + 1)).sum())
    nbytes = (int(l1.sum()) + int(l2.sum()) + 12 * B + B * L + 16 * L
              + 8 * B + 4 * B + 4 * B + 4 * kw["n_introns"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((OPS_PER_CELL * cells + 2 * B) / INT32_OPS_PER_S
             + B * L / FP32_OPS_PER_S) * 1e3
    b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    _b, _by, chain = kband_bound(l1, l2, band, kw["max_rows"], clock)
    return b_ms, by, nbytes, cells, chain


def phase_entry(dev, gpu, clock):
    """entry() on the card against the plain step on the card and the
    step on the CPU; the step and each part timed.  Returns the entry
    path's launches."""
    from pintron_tpu_torch.graft_entry import entry
    from pintron_tpu_torch.ops import kband, limits, pwm
    from pintron_tpu_torch.parallel import mesh
    fn, args = entry(dev)
    limits.reset_launches()      # the entry path's run starts here
    got = fn(*args)
    torch.cuda.synchronize()
    launches = dict(limits.LAUNCHES)     # ... and ends here
    if launches["kband"] != 1 or launches["pwm"] != 1:
        raise AssertionError(f"entry(): launches {launches}, want one "
                             "kband_kernel and one pwm_kernel")
    kw = fn.keywords
    plain = mesh.plain_alignment_step(*args, **kw)
    cpu = mesh.alignment_step(*(a.cpu() for a in args), **kw)
    torch.cuda.synchronize()
    for name, g, p, c in zip(("dist", "scores", "support"), got, plain, cpu):
        if not torch.equal(g, p):
            raise AssertionError(f"entry(): {name} != the plain step's")
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"entry(): {name} != the CPU step's")
    if not torch.isfinite(got[1]).all():
        raise AssertionError("entry(): scores not finite")
    # entry()'s batch has no pair within its band (support all 0): the
    # edge batch has both verdicts, repeated ids and donor codes outside
    # 0..3, so the scatter of the kernel's verdicts is held to counts
    # above 0
    edge, ekw = mesh.edge_batch()
    eargs = mesh.to_device(edge, dev)
    e_got = mesh.alignment_step(*eargs, **ekw)
    e_plain = mesh.plain_alignment_step(*eargs, **ekw)
    e_cpu = mesh.alignment_step(*mesh.to_device(edge, "cpu"), **ekw)
    torch.cuda.synchronize()
    for name, g, p, c in zip(("dist", "scores", "support"), e_got, e_plain,
                             e_cpu):
        if not (torch.equal(g, p) and torch.equal(g.cpu(), c)):
            raise AssertionError(f"edge batch: {name} != the plain step's "
                                 "on the card or the CPU step's")
    edge_support = int(e_got[2].sum())
    if not 0 < edge_support < len(edge[0]):
        raise AssertionError(f"edge batch: support total {edge_support}, "
                             "want both verdicts")
    est, elen, gen, glen, bands, donor, wpwm, ids = args
    parts = {
        "step": lambda: fn(*args),
        "kband": lambda: kband.banded_edit_distance_cuda(
            gen, glen, est, elen, bands, max_rows=kw["max_rows"],
            k_max=kw["k_max"]),
        "pwm": lambda: pwm.pwm_scores_cuda(donor, wpwm, kw["denominator"]),
        "index_add": lambda: mesh.intron_support(got[0], bands, ids,
                                                 kw["n_introns"])}
    times = {name: {"ms": cuda_ms(f, 50), "device_ms": device_ms(f, 50)}
             for name, f in parts.items()}
    plain_ms = cuda_ms(lambda: mesh.plain_alignment_step(*args, **kw), 3)
    b_ms, by, nbytes, cells, chain = step_bound(args, kw, clock)
    B, L = donor.shape
    rec = {"alignment_step": {
        "replaces": "pintron_tpu/parallel/mesh.py:41", "batch": [B, L],
        "launches": launches, "times": times, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
        "band_cells": cells, "kband_chain_floor_ms": chain,
        "support_total": int(got[2].sum()),
        "edge_support_total": edge_support, "gpu": gpu}}
    print(f"entry() and the edge batch (support total {edge_support}) on "
          f"the card == the plain step on the card and the "
          f"step on the CPU (dist, support exactly; scores bit for bit); "
          f"launches {launches}; step {times['step']['ms']:.4f} ms (card "
          f"alone {times['step']['device_ms']:.4f}), plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({by}), kband chain "
          f"floor {chain:.5f} ms  [{gpu}]", flush=True)
    print(json.dumps(rec), flush=True)
    return launches


def ambn_step2_s(dev, mesh_n):
    """Wall seconds of one fresh STEP 2 on AMBN on ``dev``, with
    PINTRON_TORCH_MESH=mesh_n (1: no mesh); its artifacts against golden."""
    from pintron_tpu_torch.ops.offload import MESH_ENV
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ambn-")
    old = {k: os.environ.get(k) for k in (MESH_ENV, "PINTRON_FRESH_MEMO")}
    try:
        gold = os.path.join(tmp, "gold")
        unpack_golden("test-AMBN", gold)
        work = os.path.join(tmp, "w")
        os.makedirs(work)
        for fn in ("genomic.txt", "ests.txt"):
            shutil.copy(os.path.join(gold, fn), work)
        os.environ.update({MESH_ENV: str(mesh_n), "PINTRON_FRESH_MEMO": "1"})
        t0 = time.perf_counter()
        run_est_fact(work, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        compare_files(f"test-AMBN (mesh {mesh_n})", gold, work,
                      STAGE2_ARTIFACTS)
        return wall
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def kband_group(rng, route, count):
    """A K-band group as the offload's _eval_kband_device builds one:
    ``count`` (a, b, ub) problems of one route (``"band"`` or ``"full"``,
    the band covering the matrix), a the longer, in the 1024-column
    bucket, padded to a power of two rows (at least 64).  Returns (the
    kernel's wrapper, its plain op, the numpy arrays)."""
    import functools
    from pintron_tpu_torch.ops import align, offload
    from pintron_tpu_torch.ops.kband import (banded_edit_distance_cuda,
                                             batch_edit_distance_score_cuda)
    items = []
    for _ in range(count):
        n = int(rng.integers(16, 60 if route == "full" else 400))
        a = rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes()
        b = bytearray(a[:n - int(rng.integers(0, 4))])
        for _ in range(int(rng.integers(0, 12))):
            b[int(rng.integers(0, len(b)))] = int(rng.choice(list(b"ACGT")))
        ub = (n + 1) // 2 if route == "full" else int(rng.integers(3, 12))
        items.append((a, bytes(b), ub))
    M = offload._p4(max(len(b) for _a, b, _u in items))
    Bp = offload._p2(count, lo=64)
    s1, l1 = offload._encode([a for a, _b, _u in items], 1024, rows=Bp)
    s2, l2 = offload._encode([b for _a, b, _u in items], M, rows=Bp)
    if route == "full":
        return (functools.partial(batch_edit_distance_score_cuda,
                                  max_rows=M),
                functools.partial(align.batch_edit_distance_score,
                                  max_rows=M), [s1, l1, s2, l2])
    band = np.zeros(Bp, dtype=np.int32)
    band[:count] = [u for _a, _b, u in items]
    K = offload._p2(int(band.max()), lo=2)
    return (functools.partial(banded_edit_distance_cuda, max_rows=M,
                              k_max=K),
            functools.partial(align.banded_edit_distance, max_rows=M,
                              k_max=K), [s1, l1, s2, l2, band])


def check_sharded_kband(dev, gpu):
    """The offload's K-band route over a mesh on the card
    (offload._sharded_call over 2, 3 and 8 shards on cuda:0): a band
    group and a full-matrix group of 50 problems (64 rows, 8 a shard
    at 8) and of 146 (256 rows, split 86/85/85 at 3), each shard's
    distances from kband_kernel or edit_score_kernel, all equal to the
    unsharded wrapper's and the plain op's on the card.  Comparisons:
    run before the mesh path's counters are reset."""
    from pintron_tpu_torch.ops import offload
    from pintron_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(10)
    times = {}
    for route in ("band", "full"):
        for count in (50, 146):
            fn, plain, arrays = kband_group(rng, route, count)
            args = from_numpy_batch(*arrays, device=dev)
            want, ref = fn(*args), plain(*args)
            if not torch.equal(want, ref):
                raise AssertionError(f"{route} group of {count}: the "
                                     "wrapper != the plain op")
            for n in (1, 2, 3, 8):
                m = make_mesh(n, dev)
                got = offload._sharded_call(m, fn, arrays)
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"{route} group of {count} over {n} shards: "
                        f"{int((got != ref).sum())} distances != the "
                        "unsharded wrapper's and the plain op's")
                times[f"{route}/{count}/{n}"] = cuda_ms(
                    lambda: offload._sharded_call(m, fn, arrays), 10)
    print("offload._sharded_call over 1, 2, 3 and 8 shards on "
          f"{dev}: band and full-matrix K-band groups of 50 and 146 "
          "problems == the unsharded wrapper and the plain op; ms a "
          "call: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"  [{gpu}]", flush=True)
    return times


def phase_mesh(dev, gpu, clock):
    """The scoring step over 1, 2 and 8 shards on the card and the AMBN
    pipeline over an 8-shard mesh and over two processes
    (dryrun_multichip); then the k-mer lookup on the card.  Returns the
    mesh path's launches: this process's and the two-process run's
    service's."""
    from pintron_tpu_torch.graft_entry import dryrun_multichip, entry
    from pintron_tpu_torch.ops import limits
    from pintron_tpu_torch.parallel import mesh
    fn, args = entry(dev)
    edge, ekw = mesh.edge_batch()
    batches = {"entry": (args, fn.keywords),
               "edge": (mesh.to_device(edge, dev), ekw)}
    # the references first: their launches are comparisons
    refs = {name: (mesh.alignment_step(*a, **kw),
                   mesh.plain_alignment_step(*a, **kw))
            for name, (a, kw) in batches.items()}
    steps = {(name, n): mesh.sharded_alignment_step(mesh.make_mesh(n, dev),
                                                    **kw)
             for name, (_a, kw) in batches.items() for n in (1, 2, 8)}
    sharded_ms = check_sharded_kband(dev, gpu)
    torch.cuda.synchronize()
    limits.reset_launches()      # the mesh path's run starts here
    got = {key: step(*batches[key[0]][0]) for key, step in steps.items()}
    torch.cuda.synchronize()
    step_launches = dict(limits.LAUNCHES)
    dry = dryrun_multichip(8, dev)
    launches = dict(limits.LAUNCHES)     # ... and ends here
    service = dry["multiprocess"]["service"]["launches"]
    for k in ("kband", "pwm"):
        if step_launches[k] != 2 * (1 + 2 + 8):
            raise AssertionError(f"sharded steps: {k} launched "
                                 f"{step_launches[k]} times, want 22")
    for (name, n), out in got.items():
        for ref, what in zip(refs[name], ("alignment_step",
                                          "the plain step")):
            if not (torch.equal(out[0], ref[0])
                    and torch.equal(out[2], ref[2])):
                raise AssertionError(f"{name} over {n} shards: dist or "
                                     f"support != {what}'s")
            err = float((out[1] - ref[1]).abs().max())
            if err > 1e-6:
                raise AssertionError(f"{name} over {n} shards: scores "
                                     f"{err} from {what}'s")
    edge_support = int(got[("edge", 8)][2].sum())
    if edge_support <= 0:
        raise AssertionError("edge batch over 8 shards: support total 0")
    times = {f"{name}/{n}": {"ms": cuda_ms(lambda: step(*batches[name][0]),
                                           20),
                             "device_ms": device_ms(
                                 lambda: step(*batches[name][0]), 20)}
             for (name, n), step in steps.items()}
    b_ms, by, _nb, _cells, _chain = step_bound(args, fn.keywords, clock)
    print(f"sharded_alignment_step over 1, 2 and 8 shards on {dev}: entry() "
          f"and the edge batch (support total {edge_support}) == "
          f"alignment_step and the plain step (dist, support exactly; "
          f"scores within 1e-6); launches {step_launches}; ms a call "
          f"(card alone): " + ", ".join(
              f"{k} {v['ms']:.4f} ({v['device_ms']:.4f})"
              for k, v in times.items())
          + f"; entry()'s bound {b_ms:.6f} ms ({by})  [{gpu}]", flush=True)

    mp = dry["multiprocess"]
    walls = {"mesh 8 (dryrun)": dry["step2_s"]}
    for label, n in (("no mesh", 1), ("mesh 8", 8), ("no mesh, again", 1),
                     ("mesh 8, again", 8)):
        walls[label] = ambn_step2_s(dev, n)
    print(f"dryrun_multichip(8) on {dev}: STEP 2, the pipeline's finals "
          f"and the 2-process run byte-identical to golden; STEP 2 "
          f"launches {dry['launches']} ({dry['mesh_batches']} K-band "
          f"groups over the mesh); AMBN STEP 2 wall (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in walls.items())
          + f"; 2 ranks agree on {mp['global_counts']} and "
          f"{mp['merged_candidate_introns']} candidate introns; ranks' "
          f"timing {[r['timing'] for r in mp['ranks']]}; service launches "
          f"{service}  [{gpu}]", flush=True)
    print(json.dumps({"mesh": {"step_ms": times, "step_bound_ms": b_ms,
                               "step_bound_by": by,
                               "ambn_step2_s": walls,
                               "step2_launches": dry["launches"],
                               "step2_mesh_batches": dry["mesh_batches"],
                               "sharded_call_ms": sharded_ms,
                               "ranks": mp["ranks"],
                               "service_launches": service, "gpu": gpu}}),
          flush=True)
    phase_kmer(dev, gpu)
    return {k: launches[k] + service[k] for k in launches}


def phase_kmer(dev, gpu):
    """KmerIndex.lookup_ranges_device on the card against the numpy
    lookup_ranges: TP53's locus, every 12-mer of its ESTs."""
    from pintron_tpu_torch.index.kmer import KmerIndex
    from pintron_tpu_torch.measure_kband import INT32_OPS_PER_S
    tmp = tempfile.mkdtemp(prefix="chip-smoke-kmer-")
    try:
        unpack_golden("test-TP53", tmp)
        with open(os.path.join(tmp, "genomic.txt")) as f:
            gen = "".join(f.read().split("\n")[1:]).encode()
        with open(os.path.join(tmp, "ests.txt")) as f:
            ests = [ln.strip().encode() for ln in f
                    if ln.strip() and not ln.startswith(">")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    idx = KmerIndex(gen, k=12)
    q = np.concatenate([idx.query_hashes(e) for e in ests])
    lo, hi = idx.lookup_ranges_device(q, dev)
    want = idx.lookup_ranges(q)
    for name, d, h in (("start", lo, want[0]), ("end", hi, want[1])):
        if not np.array_equal(d.cpu().numpy(), h):
            raise AssertionError(f"lookup_ranges_device: {name} != numpy")
    ms = cuda_ms(lambda: idx.lookup_ranges_device(q, dev), 20)
    h = torch.from_numpy(idx.hashes).to(dev)
    qd = torch.from_numpy(q).to(dev)

    def search():
        return (torch.searchsorted(h, qd, side="left"),
                torch.searchsorted(h, qd, side="right"))

    dev_ms = device_ms(search, 20)
    t0 = time.perf_counter()
    for _ in range(5):
        idx.lookup_ranges(q)
    plain_ms = (time.perf_counter() - t0) / 5 * 1e3
    # bytes: the sorted hashes and the queries read once, two int64
    # ranges written; operations: two binary searches a query, one
    # compare a level
    n, m = len(idx.hashes), len(q)
    b_ms, by = bound(8 * n + 8 * m + 16 * m,
                     2 * m * int(np.ceil(np.log2(max(n, 2)))),
                     INT32_OPS_PER_S)
    rec = {"lookup_ranges_device": {
        "replaces": "pintron_tpu/index/kmer.py:81", "hashes": n,
        "queries": m, "ms": ms, "searchsorted_device_ms": dev_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
        "gpu": gpu}}
    print(f"lookup_ranges_device on {dev} == numpy lookup_ranges on TP53 "
          f"({n} locus 12-mers, {m} EST 12-mers): {ms:.4f} ms a call with "
          f"its copies, the two searchsorted {dev_ms:.4f} ms on the card "
          f"alone, numpy {plain_ms:.3f} ms, bound {b_ms:.6f} ms ({by})  "
          f"[{gpu}]", flush=True)
    print(json.dumps(rec), flush=True)


def phase_fuzz(gpu, n_cases=9):
    """The device fuzz's first n_cases cases on the card, each byte for
    byte the host path's.  Returns the device runs' launches, summed."""
    from pintron_tpu_torch import fuzz_device
    launches = {}
    for seed, gen_len, n_ests in fuzz_device.grid(n_cases):
        t0 = time.perf_counter()
        res = fuzz_device.run_case(seed, gen_len, n_ests, "cuda")
        dt = time.perf_counter() - t0
        print(f"fuzz seed {seed}, {gen_len} nt x {n_ests} ESTs: "
              f"{res['detail']} in {dt:.1f} s  [{gpu}]", flush=True)
        if res["routes"] is not None:
            print(f"  routes: {fuzz_device.routes_line(res['routes'])}",
                  flush=True)
        if not res["ok"]:
            raise AssertionError(f"fuzz seed {seed}: {res['detail']}")
        for k, v in res["routes"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"fuzz: {n_cases} cases byte-identical to the host path; "
          f"device runs' launches {launches}", flush=True)
    return launches


def phase_sweep(gpu, device="cuda"):
    """The golden sweep on the card: STEP 2 of the 9 golden loci with
    inputs (check_stage2.check_case), each byte for byte the golden's
    with every family's problems on the card and each STEP 2 kernel
    launched, its routes on a line; then the 9 through one batch on a
    device service (check_batch_sweep.sweep), each locus's finals byte
    for byte its --device host solo run's and of that run's class
    against the golden (check_e2e.classify_case), never diff.  Returns
    the sweep path's launches: this process's and the batch's
    service's."""
    from pintron_tpu_torch.ops import limits
    from pintron_tpu_torch.tools import check_batch_sweep, check_stage2
    t0 = time.perf_counter()
    limits.reset_launches()      # the sweep path's run starts here
    loci = {}
    for case in SWEEP_CASES:
        res = check_stage2.check_case(case, device)
        print(f"{check_stage2.case_line(res)}  [{gpu}]", flush=True)
        if res["status"] != "OK":
            raise AssertionError(f"{case}: STEP 2 {res['differs']}")
        print(f"  routes: {check_stage2.routes_line(res)}", flush=True)
        idle = [k for k in STEP2_KERNELS if res["launches"][k] <= 0]
        if idle:
            raise AssertionError(f"{case}: STEP 2 left {idle} unlaunched: "
                                 f"{res['launches']}")
        if any(res["too_wide"].values()):
            raise AssertionError(f"{case}: problems left to the host for "
                                 f"their size: {res['too_wide']}")
        loci[case] = {k: res[k] for k in ("ests", "seconds", "ests_per_s",
                                          "families", "launches", "buckets",
                                          "host_cells", "device_share",
                                          "too_wide")}
        loci[case].update(kband_ub_max=res["stats"]["kband_ub_max"],
                          device_cells=res["stats"]["device_cells"])
    step2_s = time.perf_counter() - t0
    sw = check_batch_sweep.sweep(list(SWEEP_CASES), device)
    launches = dict(limits.LAUNCHES)     # ... and ends here
    summary = sw["summary"]
    service = summary["service"]["launches"]
    print(f"batch sweep --device {device}: {summary['jobs']} loci in "
          f"{sw['seconds']:.2f} s ({summary['ok']} ok); service "
          f"{summary['service']}  [{gpu}]", flush=True)
    for case, c in sw["cases"].items():
        print(check_batch_sweep.case_line(case, c), flush=True)
        loci[case].update(batch_class=c["label"], bucket=c["bucket"],
                          host_bucket=c["solo_bucket"],
                          job_seconds=c["job_seconds"])
    if not sw["ok"] or sorted(sw["cases"]) != sorted(SWEEP_CASES):
        raise AssertionError(f"batch sweep: {sw['cases']}, skipped "
                             f"{sw['skipped']}")
    total = {k: launches[k] + service[k] for k in launches}
    idle = [k for k in STEP2_KERNELS + STEP4_KERNELS if total[k] <= 0]
    if idle:
        raise AssertionError(f"the sweep left {idle} unlaunched: {total}")
    wall = time.perf_counter() - t0
    print(f"golden sweep: 9 loci byte-identical in STEP 2 ({step2_s:.1f} s), "
          f"every batch locus equal to its host run, classes "
          f"{[c['bucket'] for c in sw['cases'].values()]}; launches "
          f"{total}; phase {wall:.1f} s  [{gpu}]", flush=True)
    print(json.dumps({"sweep": {"loci": loci, "step2_s": step2_s,
                                "batch_s": sw["seconds"], "phase_s": wall,
                                "service": summary["service"],
                                "launches": total, "gpu": gpu}}),
          flush=True)
    return total


# the kernel each STEP 2 family launches on the golden loci
FAMILY_KERNELS = {"kband": "kband", "nw": "nw", "gap": "gap", "rb": "rowmin"}


def phase_routes(gpu, device="cuda", cases=("test-TP53", "test-issue-13")):
    """STEP 2 on TP53 and issue-13 (check_stage2.check_case: one
    process, fresh memo, byte for byte the golden's) forced (nothing
    set), with each family's PINTRON_DEVICE_<F> at 0 in turn, and with
    all four at auto (the tuner cleared before each locus).  A family at
    0 must launch its kernel no time and every other family as in the
    forced run.  Each run's ESTs/s, device share of the DP cells, launches
    and latches on a line.  Returns the phase's launches."""
    from pintron_tpu_torch.ops import limits, offload
    from pintron_tpu_torch.tools import check_stage2
    envs = [offload.family_env(f) for f in offload.FAMILIES]
    runs = ([("forced", {})]
            + [(f"{f}=0", {offload.family_env(f): "0"})
               for f in offload.FAMILIES]
            + [("auto", dict.fromkeys(envs, "auto"))])
    t0 = time.perf_counter()
    table = {}
    limits.reset_launches()      # the routes path's run starts here
    try:
        for case in cases:
            offload.reset_tuner()
            forced = None
            for label, env in runs:
                for var in envs:
                    os.environ.pop(var, None)
                os.environ.update(env)
                res = check_stage2.check_case(case, device)
                if res["status"] != "OK":
                    raise AssertionError(f"{case} {label}: STEP 2 "
                                         f"{res['differs']}")
                lc = {k: res["launches"][k] for k in STEP2_KERNELS}
                if forced is None:
                    forced = lc
                    if min(lc.values()) <= 0:
                        raise AssertionError(f"{case} forced: a STEP 2 "
                                             f"kernel never launched: {lc}")
                host = {FAMILY_KERNELS[f] for f, route in
                        offload.family_routes().items() if route == "host"}
                want = {k: 0 if k in host else forced[k]
                        for k in STEP2_KERNELS}
                if label != "auto" and lc != want:
                    raise AssertionError(f"{case} {label}: launches {lc}, "
                                         f"expected {want}")
                stats = res["stats"]
                dev = stats["device_cells"]
                total = dev + sum(res["host_cells"].values())
                row = {"ests_per_s": res["ests_per_s"],
                       "seconds": res["seconds"],
                       "device_cell_share": dev / total if total else 0.0,
                       "launches": lc, "latches": offload.latches(),
                       "tuner": {f: {c: stats[f"{f}_{c}"]
                                     for c in offload.TUNE_COUNTS}
                                 for f in offload.FAMILIES}}
                table[f"{case}|{label}"] = row
                counted = {f: {c: v for c, v in t.items() if v}
                           for f, t in row["tuner"].items()}
                print(f"{case} {label}: STEP 2 byte-identical to golden; "
                      f"{res['ests']} ESTs in {res['seconds']:.3f} s = "
                      f"{res['ests_per_s']:.2f} ESTs/s; device share "
                      f"{row['device_cell_share']:.4f}; launches {lc}; "
                      f"latches {row['latches']}; tuner counts {counted}  "
                      f"[{gpu}]", flush=True)
    finally:
        for var in envs:
            os.environ.pop(var, None)
        offload.reset_tuner()
    launches = dict(limits.LAUNCHES)     # ... and ends here
    print(f"family routes: {len(table)} runs byte-identical, every family "
          f"at 0 "
          f"launched nothing, the others as forced; launches {launches}; "
          f"phase {time.perf_counter() - t0:.1f} s  [{gpu}]", flush=True)
    print(json.dumps({"routes": {"runs": table, "launches": launches,
                                 "gpu": gpu}}), flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import pintron_tpu_torch
    from pintron_tpu_torch.ops import _build
    if not os.path.abspath(pintron_tpu_torch.__file__).startswith(REPO):
        raise RuntimeError("pintron_tpu_torch is not this checkout's")

    phase("1. card")
    gpu = card_line()
    clock = max_sm_clock_hz()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, highest SM clock "
          f"{clock / 1e6:.0f} MHz", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("2. build")
    t0 = time.perf_counter()
    _build.load()
    print(f"built {os.path.relpath(_build.BUILD_INFO['path'], REPO)} in "
          f"{time.perf_counter() - t0:.2f} s (cached: "
          f"{_build.BUILD_INFO['cached']})", flush=True)
    if _build.BUILD_INFO["log"]:
        print(_build.BUILD_INFO["log"].strip(), flush=True)

    phase("3. kernels against their plain versions")
    errs, times = phase_kernels(dev, gpu, clock)
    tb_errs, tb_times = phase_traceback_kernels(dev, gpu, clock)
    errs.update(tb_errs)
    times.update(tb_times)
    s4_errs, s4_times = phase_stage4_kernels(dev, gpu, clock)
    errs["pwm"] = s4_errs["pwm"]
    errs["edit_score"] = max(errs["edit_score"], s4_errs["edit_score"])
    times.update(s4_times)

    phase("4. main path, STEP 2 on TP53 and issue-13")
    step2, mix_launches = phase_main_path(dev, gpu)

    phase("5. main path, STEP 4 on TP53 and issue-13")
    step4 = phase_stage4(dev, gpu)

    phase("6. full pipeline on AMBN")
    phase_pipeline(dev, gpu)

    phase("7. device service: sharded STEP 2 and the batch driver")
    phase_service(dev, gpu)

    phase("8. entry() on the card")
    entry_launches = phase_entry(dev, gpu, clock)

    phase("9. device fuzz of STEP 2 on random spliced loci")
    fuzz_launches = phase_fuzz(gpu)

    phase("10. mesh and multi-process STEP 2 on the card")
    mesh_launches = phase_mesh(dev, gpu, clock)

    phase("11. golden sweep on the card")
    sweep_launches = phase_sweep(gpu)

    phase("12. family routes: each family on the host DP, and the tuner")
    routes_launches = phase_routes(gpu)

    jax_pkg = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "pintron_tpu" or m.startswith("pintron_tpu.")]
    if jax_pkg:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{jax_pkg[:5]}")
    kernels = []
    for key, (src, replaces) in KERNELS.items():
        by_path = {"step2": step2[key], "step4": step4[key],
                   "entry": entry_launches[key], "fuzz": fuzz_launches[key],
                   "mesh": mesh_launches[key], "sweep": sweep_launches[key],
                   "routes": routes_launches[key]}
        launches = sum(by_path.values())
        if launches <= 0:
            raise AssertionError(f"{key}_kernel never launched on the "
                                 "main path")
        ms, pms, b_ms, by, _chain, *lib = times[key]
        extra = ({"device_ms": lib[1], "library_device_ms": lib[2]}
                 if len(lib) > 1 else {})
        if key == "nw":
            extra["oversized"] = times["nw_oversized"]
        kernels.append({
            "name": f"{key}_kernel", "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "offload_mix_launches": mix_launches[key],
            "max_abs_err": errs[key], "ms": ms, "plain_ms": pms,
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib[0] if lib else None, **extra})
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
