"""STEP 2 (est-fact) and STEP 4 (intron agreement) throughput of the
port against its host path, on the two largest golden loci
whose inputs ship in the repo (TP53, issue-13).

    python -m pintron_tpu_torch.measure_step2 [--reps 4] [--out FILE]

STEP 2 modes, each run on a fresh copy of the locus with a fresh memo
(``PINTRON_FRESH_MEMO=1``) and byte-compared with ``tests/golden/``:

  cuda   the port's device flow, every DP family on the GPU kernels;
  cpu    the same flow with the plain PyTorch versions on the host CPU;
  host1  the host path (``device="host"``) with one worker (one native
         call);
  host8  the host path, 8-worker fork pool;
  svc8   the port's device flow sharded over 8 fork workers, whose
         batches all go to one device service on the GPU
         (``pintron_tpu_torch.devservice``, started once for the run);
  svc4   the same over 4 fork workers;
  svc1   the one-process device flow, its batches through the service.

With ``--routes``, only the family routes instead (one process, on the
GPU; ``PINTRON_DEVICE_<F>``, ``ops.offload.family_routes``):

  cuda        every family on the card (no switch set);
  kband-host, nw-host, gap-host, rb-host
              that family's switch at 0, the host DP inside the cascade;
  auto        all four under the self-tuner, cleared before each locus's
              first run and carried across its runs.

Each route run records the device share of the DP cells, the tuner's
latches after it and its counters (under ``routes`` in the JSON); then
one profiled run of each mode a locus, as above (under ``profile``).

STEP 4 modes, from the goldens' STEP 3 outputs, byte-compared too:

  step4-cuda  the port's stage, BPS sweep and edit stats on the GPU;
  step4-host  the host stage (``device="host"``).

Every mode runs once untimed first (kernel build, CUDA start-up).  Each
repetition runs the modes in turn, forwards on even repetitions and
backwards on odd ones; the summary keeps every time and the median (the
upper of the middle two for an even count).  Then one profiled cuda run
of each step per locus (``torch.profiler``, CPU and CUDA activity,
every thread) gives the device time by kernel, the device's busy share
of the wall time, the host time of STEP 2's device-flow phases (spans
``pintron_step2_*``), the offload counters and kernel launches per
family, the host DP cells by family (``pintron_tpu_torch.native.dp_census``)
and the device share of the DP cells.  Last, per locus, 3 timed runs
(after one untimed) of ``svc1`` and of ``svc8`` with each worker timed
in its own process: its start after the call, wall, CPU time, and the
time it waited on service round trips.  Writes one JSON file (default
``chiprun_out/step2_measure.json``, with the service's report: requests,
merged batches, evaluation seconds per op) and prints a summary.
``--profile-only`` runs only the profiled runs (after one untimed cuda
run of each step per locus).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tarfile
import tempfile
import time
from collections import defaultdict

import torch

from pintron_tpu_torch.regression import STAGE2_ARTIFACTS, differing
from pintron_tpu_torch.runtime.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CASES = ("test-TP53", "test-issue-13")
# mode -> (device, PINTRON_EST_WORKERS, through the service)
MODES = {"cuda": ("cuda", None, False), "cpu": ("cpu", None, False),
         "host1": ("host", "1", False), "host8": ("host", "8", False),
         "svc8": ("cuda", "8", True), "svc4": ("cuda", "4", True),
         "svc1": ("cuda", "1", True)}
# --routes: mode -> the family switches it sets
ROUTES = {"cuda": {}, **{f"{f}-host": {f"PINTRON_DEVICE_{f.upper()}": "0"}
                         for f in ("kband", "nw", "gap", "rb")},
          "auto": {f"PINTRON_DEVICE_{f.upper()}": "auto"
                   for f in ("kband", "nw", "gap", "rb")}}
STEP4_INPUTS = ("genomic.txt", "processed-ests.txt", "out-agree.txt")
STEP4 = ("out-after-intron-agree.txt", "predicted-introns.txt")
STEP4_MODES = {"step4-cuda": "cuda", "step4-host": "host"}


def _fresh_copy(case_dir: str, tmp: str, names) -> str:
    work = tempfile.mkdtemp(dir=tmp)
    for name in names:
        shutil.copy(os.path.join(case_dir, name), work)
    return work


def _check(case_dir: str, work: str, names, mode: str) -> None:
    bad = differing(case_dir, work, names)
    if bad:
        raise AssertionError(f"{mode}: {', '.join(bad)} differ from golden")
    shutil.rmtree(work)


def _run(case_dir: str, tmp: str, mode: str, service: str) -> float:
    """One STEP 2 run of ``mode`` on a fresh copy; returns seconds."""
    from pintron_tpu_torch.ops.offload import SERVICE_ENV
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    device, workers, via_service = MODES[mode]
    work = _fresh_copy(case_dir, tmp, ("genomic.txt", "ests.txt"))
    if workers:
        os.environ["PINTRON_EST_WORKERS"] = workers
    if via_service:
        os.environ[SERVICE_ENV] = service
    try:
        t0 = time.perf_counter()
        run_est_fact(work, device=device)
        dt = time.perf_counter() - t0
    finally:
        os.environ.pop("PINTRON_EST_WORKERS", None)
        os.environ.pop(SERVICE_ENV, None)
    _check(case_dir, work, STAGE2_ARTIFACTS, mode)
    return dt


def _run_route(case_dir: str, tmp: str, mode: str, record: list) -> float:
    """One STEP 2 run of route ``mode`` (``ROUTES``) on the GPU in this
    process; appends its device share, latches and tuner counters to
    ``record`` and returns seconds."""
    from pintron_tpu_torch.native import dp_census, dp_census_reset
    from pintron_tpu_torch.ops import kband, offload
    offload.reset_stats()
    dp_census_reset()
    before = dict(kband.LAUNCHES)
    os.environ.update(ROUTES[mode])
    try:
        dt = _run(case_dir, tmp, "cuda", "")
    finally:
        for var in ROUTES[mode]:
            os.environ.pop(var, None)
    dev = offload.STATS["device_cells"]
    total = dev + sum((dp_census() or {}).values())
    record.append({
        "mode": mode, "s": dt, "device_cell_share": dev / total,
        "launches": {k: kband.LAUNCHES[k] - before[k] for k in before},
        "latches": offload.latches(),
        "tuner": {k: v for k, v in offload.STATS.items()
                  if k.split("_", 1)[-1] in offload.TUNE_COUNTS and v}})
    return dt


def _run4(case_dir: str, tmp: str, mode: str) -> float:
    """One STEP 4 run of ``mode`` on a fresh copy; returns seconds."""
    from pintron_tpu_torch.stages.intron_agreement import \
        run_intron_agreement
    work = _fresh_copy(case_dir, tmp, STEP4_INPUTS)
    t0 = time.perf_counter()
    run_intron_agreement(work, device=STEP4_MODES[mode])
    dt = time.perf_counter() - t0
    _check(case_dir, work, STEP4, mode)
    return dt


def _profile(run) -> dict:
    """Profile one run (``run()`` returns its wall seconds)."""
    from pintron_tpu_torch.native import dp_census, dp_census_reset
    from pintron_tpu_torch.ops import kband, offload
    offload.reset_stats()
    kband.reset_launches()
    dp_census_reset()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True))
    with prof:
        wall = run()
    # device-side events: kernels and copies, and the record_function
    # spans projected onto the GPU timeline, which cover kernels already
    # counted and are kept apart
    by_name = defaultdict(lambda: [0.0, 0])
    spans = defaultdict(lambda: [0.0, 0])
    host = defaultdict(lambda: [0.0, 0])   # the device flow's host phases
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            acc = spans if evt.name.startswith("pintron_") else by_name
        elif evt.name.startswith("pintron_step2_"):
            acc = host
        else:
            continue
        acc[evt.name][0] += evt.time_range.elapsed_us() / 1e3
        acc[evt.name][1] += 1
    device_ms = sum(v[0] for v in by_name.values())
    census = dp_census() or {}
    dev_cells = offload.STATS["device_cells"]
    cells = dev_cells + sum(census.values())
    return {"wall_ms": wall * 1e3,
            "device_ms": device_ms if by_name else "not measured",
            "device_busy_share": (device_ms / (wall * 1e3)
                                  if by_name else "not measured"),
            "by_name_ms": sorted(([k, v[0], v[1]]
                                  for k, v in by_name.items()),
                                 key=lambda x: -x[1]),
            "spans_device_ms": dict(spans),
            "host_phases_ms": dict(host),
            "stats": dict(offload.STATS), "launches": dict(kband.LAUNCHES),
            "host_census": census,
            "device_cell_share": dev_cells / cells if cells else 0.0}


def _trace_workers(case_dir: str, tmp: str, sock: str, workers: int,
                   reps: int = 3) -> list:
    """``reps`` runs (after one untimed) of mode ``svc{workers}``, each
    worker of the flow timed in its own process; returns per run the
    wall and the workers' records."""
    from pintron_tpu_torch.ops import offload
    from pintron_tpu_torch.stages import est_fact
    rec = os.path.join(tmp, "workers.jsonl")
    call = [0.0]
    wait = [0.0, 0]
    run_units, service_eval = est_fact._run_units_device, offload.service_eval

    def timed_eval(*a):
        t = time.perf_counter()
        try:
            return service_eval(*a)
        finally:
            wait[0] += time.perf_counter() - t
            wait[1] += 1

    def timed_units(*a, **k):
        # in a fork worker, or in this process for one worker
        wait[:] = [0.0, 0]
        start, cpu = time.time(), time.process_time()
        try:
            return run_units(*a, **k)
        finally:
            with open(rec, "a") as f:
                f.write(json.dumps({
                    "start_ms": (start - call[0]) * 1e3,
                    "wall_ms": (time.time() - start) * 1e3,
                    "cpu_ms": (time.process_time() - cpu) * 1e3,
                    "wait_ms": wait[0] * 1e3, "requests": wait[1]}) + "\n")

    est_fact._run_units_device = timed_units
    offload.service_eval = timed_eval
    runs = []
    try:
        for _ in range(reps + 1):
            open(rec, "w").close()
            call[0] = time.time()
            wall = _run(case_dir, tmp, f"svc{workers}", sock)
            with open(rec) as f:
                runs.append({"wall_ms": wall * 1e3,
                             "workers": [json.loads(ln) for ln in f]})
    finally:
        est_fact._run_units_device = run_units
        offload.service_eval = service_eval
    return runs[1:]


def _timed(out, case, n_ests, modes, run, reps, gpu) -> None:
    """Warm up every mode once, then ``reps`` timed rounds in turns."""
    for mode in modes:
        run(mode)
    times = {m: [] for m in modes}
    for r in range(reps):
        for mode in (modes if r % 2 == 0 else modes[::-1]):
            times[mode].append(run(mode))
    for mode, s in times.items():
        med = sorted(s)[len(s) // 2]
        out["summary"][f"{case}|{mode}"] = {
            "n_ests": n_ests, "s": s, "median_s": med,
            "ests_per_s_median": n_ests / med}
        print(f"{case} {mode}: {n_ests / med:.2f} ESTs/s (median of "
              f"{len(s)}: {med:.6f} s)  [{gpu}]", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--profile-only", action="store_true",
                   help="only the profiled cuda runs of each step")
    p.add_argument("--routes", action="store_true",
                   help="only the family routes (ROUTES), timed")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "step2_measure.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_step2: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if os.environ.get("PINTRON_DEVICE"):
        raise RuntimeError("unset PINTRON_DEVICE (the JAX package's "
                           "switch; the port refuses it)")
    os.environ["PINTRON_FRESH_MEMO"] = "1"
    gpu = card_line()
    out = {"gpu": gpu, "torch": torch.__version__, "reps": args.reps,
           "summary": {}, "profile": {}, "workers_trace": {}, "routes": {}}
    if args.routes:
        from pintron_tpu_torch.ops import offload
        if any(os.environ.get(offload.family_env(f))
               for f in offload.FAMILIES):
            raise RuntimeError("unset PINTRON_DEVICE_{KBAND,NW,GAP,RB}: "
                               "--routes sets them for each mode")
    from pintron_tpu_torch.batch import start_service, stop_service
    tmp = tempfile.mkdtemp(prefix="measure-step2-")
    proc, sock = start_service("cuda")
    try:
        for case in CASES:
            case_dir = os.path.join(tmp, case)
            with tarfile.open(os.path.join(GOLDEN, f"{case}.tar.gz")) as tf:
                tf.extractall(case_dir, filter="data")
            with open(os.path.join(case_dir, "ests.txt")) as f:
                n_ests = sum(1 for ln in f if ln.startswith(">"))
            if args.routes:
                offload.reset_tuner()
                record = out["routes"][case] = []
                _timed(out, case, n_ests, list(ROUTES),
                       lambda m: _run_route(case_dir, tmp, m, record),
                       args.reps, gpu)
                for mode in ROUTES:
                    last = [r for r in record if r["mode"] == mode][-1]
                    prof = _profile(lambda: _run_route(case_dir, tmp, mode,
                                                       record))
                    out["profile"][f"{case}|{mode}"] = prof
                    print(f"{case} {mode}: device share "
                          f"{last['device_cell_share']:.4f}, launches "
                          f"{last['launches']}, latches {last['latches']}, "
                          f"tuner {last['tuner']} (the last timed run); "
                          f"profiled: wall {prof['wall_ms']:.1f} ms, device "
                          f"{prof['device_ms']} ms, host phases "
                          f"{prof['host_phases_ms']}  [{gpu}]", flush=True)
                continue
            if args.profile_only:
                _run(case_dir, tmp, "cuda", sock)
                _run4(case_dir, tmp, "step4-cuda")
            else:
                _timed(out, case, n_ests, list(MODES),
                       lambda m: _run(case_dir, tmp, m, sock), args.reps,
                       gpu)
                _timed(out, case, n_ests, list(STEP4_MODES),
                       lambda m: _run4(case_dir, tmp, m), args.reps, gpu)
            for key, run in (
                    ("step2", lambda: _run(case_dir, tmp, "cuda", sock)),
                    ("step4", lambda: _run4(case_dir, tmp, "step4-cuda"))):
                prof = _profile(run)
                out["profile"][f"{case}|{key}"] = prof
                print(f"{case} profiled cuda {key}: wall "
                      f"{prof['wall_ms']:.3f} ms, device "
                      f"{prof['device_ms']} ms, busy "
                      f"{prof['device_busy_share']}, by kernel "
                      f"{prof['by_name_ms']}, device share of DP cells "
                      f"{prof['device_cell_share']:.4f}, launches "
                      f"{prof['launches']}, stats {prof['stats']}, host "
                      f"phases {prof['host_phases_ms']}  [{gpu}]",
                      flush=True)
            for workers in (() if args.profile_only else (1, 8)):
                runs = _trace_workers(case_dir, tmp, sock, workers)
                out["workers_trace"][f"{case}|svc{workers}"] = runs
                for r in runs:
                    w = r["workers"]
                    print(f"{case} svc{workers} traced: wall "
                          f"{r['wall_ms']:.1f} ms; worker starts "
                          f"{min(x['start_ms'] for x in w):.1f}-"
                          f"{max(x['start_ms'] for x in w):.1f} ms, walls "
                          f"{min(x['wall_ms'] for x in w):.1f}-"
                          f"{max(x['wall_ms'] for x in w):.1f} ms, waits "
                          f"{min(x['wait_ms'] for x in w):.1f}-"
                          f"{max(x['wait_ms'] for x in w):.1f} ms, CPU in "
                          f"all {sum(x['cpu_ms'] for x in w):.1f} ms  "
                          f"[{gpu}]", flush=True)
    finally:
        out["service"] = stop_service(proc, sock)
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
