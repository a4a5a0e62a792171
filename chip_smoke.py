#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on
failure (so the script exits non-zero and never prints its last line):

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the hand-written kernels of pintron_tpu_torch/csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card, exact
     int32 equality on every problem: seeded batches with the edge cases
     and the production shape (B, rows, W) = (32768, 256, 33); times of
     both at the shapes the main path gives them;
  4. the main path: STEP 2 (est-fact) through the port's run_est_fact on
     the TP53 and issue-13 loci with the K-band checks on the card,
     byte-compared with tests/golden/; the kernel launch counters are
     reset just before these two runs and read just after them.  Then,
     with the counters reset again, the offload entry eval_kband on a
     problem mix held against the native ep_kband verdicts: it reaches
     the full-matrix route, which no real locus reaches;
  5. the full pipeline, python -m pintron_tpu_torch.pipeline --device
     cuda, on AMBN, classified against golden like tools/check_e2e.py.

Before the last line it prints the card line and one JSON object:
under "kernels" every kernel the main path launched, with its launches
there, its launches on the problem mix, its largest difference from
the plain version, and both times; under "not_reached_by_main_path"
the same for a built and checked kernel that the main path did not
launch.  The last line is {"ok": true, "device": {...}}.
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

from pintron_tpu_torch.ops.align import from_numpy_batch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
STAGE2_FILES = ("raw-multifasta-out.txt", "processed-ests.txt", "megs.txt",
                "processed-megs.txt", "meg-edges.txt")


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no GPU")
    return lines[0]


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


def phase_kernels(dev, gpu):
    from pintron_tpu_torch.ops import align, kband
    rng = np.random.default_rng(20240917)
    errs = {"kband": 0, "edit_score": 0}
    # edge cases: small, B not a multiple of 128, masked bytes
    for B, n_cols, m_cols, k_max in ((77, 96, 64, 8), (300, 1024, 256, 16),
                                     (129, 4096, 1024, 64)):
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
    # production shape of the K-band batch: (B, rows, W) = (32768, 256, 33)
    B, rows, k_max = 32768, 256, 16
    batch = random_kband_batch(rng, B, 1024, rows, k_max)
    kw = dict(max_rows=rows, k_max=k_max)
    e, args = compare("kband", kband.banded_edit_distance_cuda,
                      align.banded_edit_distance, batch, kw, dev)
    errs["kband"] = max(errs["kband"], e)
    ms = cuda_ms(lambda: kband.banded_edit_distance_cuda(*args, **kw), 10)
    pms = cuda_ms(lambda: align.banded_edit_distance(*args, **kw), 3)
    cells = B * rows * (2 * k_max + 1)
    times["kband"] = (ms, pms)
    print(f"kband (B, rows, W) = ({B}, {rows}, {2 * k_max + 1}): kernel "
          f"{ms:.3f} ms = {cells / ms / 1e6:.3f} Gcells/s, plain "
          f"{pms:.3f} ms = {cells / pms / 1e6:.3f} Gcells/s  [{gpu}]",
          flush=True)

    # a batch the TP53 locus gives the band kernel: (512, 1024 rows, W 65)
    batch = random_kband_batch(rng, 512, 1024, 1024, 32)
    kw = dict(max_rows=1024, k_max=32)
    e, args = compare("kband", kband.banded_edit_distance_cuda,
                      align.banded_edit_distance, batch, kw, dev)
    errs["kband"] = max(errs["kband"], e)
    ms = cuda_ms(lambda: kband.banded_edit_distance_cuda(*args, **kw), 10)
    pms = cuda_ms(lambda: align.banded_edit_distance(*args, **kw), 2)
    print(f"kband (B, rows, W) = (512, 1024, 65): kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms  [{gpu}]", flush=True)

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
    times["edit_score"] = (ms, pms)
    print(f"edit_score (B, N, rows) = ({B}, {N}, {M}): kernel {ms:.3f} ms, "
          f"plain {pms:.3f} ms  [{gpu}]", flush=True)
    return errs, times


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


def phase_main_path(dev, gpu):
    from pintron_tpu.native import dp_census, dp_census_reset, get_lib
    from pintron_tpu_torch.ops import kband, offload
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
        kband.reset_launches()      # the main path's run starts here
        per_case = {}
        for case, (gold, work) in works.items():
            offload.reset_stats()
            dp_census_reset()
            before = dict(kband.LAUNCHES)
            t0 = time.perf_counter()
            run_est_fact(work, device=dev)
            dt = time.perf_counter() - t0
            per_case[case] = (dt, dict(offload.STATS), dp_census() or {},
                              {k: kband.LAUNCHES[k] - before[k]
                               for k in before})
        launches = dict(kband.LAUNCHES)     # ... and ends here
        kband.reset_launches()
        got_mix = offload.eval_kband(mix)
        mix_launches = dict(kband.LAUNCHES)

        if offload.device_wedged():
            raise AssertionError("device wedge latch set: a kernel failure "
                                 "was hidden by the host fallback")
        if got_mix is None or [int(v) for v in got_mix] != want_mix:
            raise AssertionError("eval_kband verdicts differ from ep_kband")
        if min(mix_launches.values()) <= 0:
            raise AssertionError(f"the problem mix left a kernel "
                                 f"unlaunched: {mix_launches}")
        print(f"eval_kband on {len(mix)} mixed problems == native "
              f"ep_kband; launches {mix_launches}", flush=True)
        for case, (dt, stats, census, lc) in per_case.items():
            gold, work = works[case]
            for name in STAGE2_FILES:
                with open(os.path.join(gold, name), "rb") as f:
                    g = f.read()
                with open(os.path.join(work, name), "rb") as f:
                    w = f.read()
                if g != w:
                    raise AssertionError(f"{case}: {name} differs from "
                                         "golden")
            if stats["device_problems"] <= 0 or lc["kband"] <= 0:
                raise AssertionError(f"{case}: no K-band work reached the "
                                     f"card ({stats}, launches {lc})")
            with open(os.path.join(work, "ests.txt")) as f:
                n_ests = sum(1 for ln in f if ln.startswith(">"))
            host = sum(census.values())
            frac = stats["device_cells"] / (stats["device_cells"] + host)
            print(f"{case}: STEP 2 byte-identical to golden; {n_ests} ESTs "
                  f"in {dt:.3f} s = {n_ests / dt:.2f} ESTs/s; "
                  f"device_problems {stats['device_problems']}, "
                  f"device_cells {stats['device_cells']}, host DP cells "
                  f"{host} {census}, device share {frac:.4f}, launches "
                  f"{lc}  [{gpu}]", flush=True)
        if launches["kband"] <= 0:
            raise AssertionError("kband_kernel never launched on the "
                                 "main path")
        print(f"main path launches {launches}", flush=True)
        return launches, mix_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("PINTRON_FRESH_MEMO", None)


def phase_pipeline(dev, gpu):
    from pintron_tpu.regression import compare_outputs
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
        flow = None
        with open(os.path.join(work, "pintron-log.txt")) as f:
            for ln in f:
                if "est-fact device flow: " in ln:
                    flow = json.loads(ln.split("est-fact device flow: ",
                                               1)[1])
        if (flow is None or flow["stats"]["device_problems"] <= 0
                or flow["launches"]["kband"] <= 0):
            raise AssertionError(f"pipeline STEP 2 did not run the K-band "
                                 f"kernel: {flow}")
        res = compare_outputs(work, gold)
        if res["json_byte"] and res["gtf_byte"]:
            label = "byte-identical"
        elif res["json_canonical"] and res["gtf_canonical"]:
            label = "canonical"
        else:
            raise AssertionError(f"AMBN full pipeline differs: {res}")
        print(f"AMBN full pipeline (--device cuda): {label} in {dt:.2f} s; "
              f"STEP 2 {flow}  [{gpu}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
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
    errs, times = phase_kernels(dev, gpu)

    phase("4. main path: STEP 2 on TP53 and issue-13")
    launches, mix_launches = phase_main_path(dev, gpu)

    phase("5. full pipeline on AMBN")
    phase_pipeline(dev, gpu)

    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    src = "pintron_tpu_torch/csrc/kband.cu"
    replaces = {"kband": "pintron_tpu/ops/pallas_align.py:160",
                "edit_score": "pintron_tpu/ops/align.py:144"}
    kernels, unreached = [], []
    for key in ("kband", "edit_score"):
        entry = {"name": f"{key}_kernel", "route": "cuda", "source": src,
                 "replaces": replaces[key], "launches": launches[key],
                 "offload_mix_launches": mix_launches[key],
                 "max_abs_err": errs[key], "ms": times[key][0],
                 "plain_ms": times[key][1]}
        # the full-matrix route needs a noisy exon of at most 3 nt, which
        # the loci do not have: edit_score_kernel is then listed apart
        (kernels if launches[key] > 0 else unreached).append(entry)
    print(gpu)
    print(json.dumps({"kernels": kernels,
                      "not_reached_by_main_path": unreached}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
