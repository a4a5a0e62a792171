"""STEP 2 (est-fact) throughput of the port against pintron_tpu's host
path, on the two largest golden loci whose inputs ship in the repo
(TP53, issue-13).

    python -m pintron_tpu_torch.measure_step2 [--reps 4] [--out FILE]

Modes, each run on a fresh copy of the locus with a fresh memo
(``PINTRON_FRESH_MEMO=1``) and byte-compared with ``tests/golden/``:

  cuda   the port's device flow, every DP family on the GPU kernels;
  cpu    the same flow with the plain PyTorch versions on the host CPU;
  host1  pintron_tpu's host path with one worker (one native call);
  host8  pintron_tpu's host path, 8-worker fork pool.

Every mode runs once untimed first (kernel build, CUDA start-up).  Each
repetition runs the modes in turn, forwards on even repetitions and
backwards on odd ones; the summary keeps every time and the median (the
upper of the middle two for an even count).  Then one profiled cuda run
per locus (``torch.profiler``, CPU and CUDA activity, every thread)
gives the device time by kernel, the device's busy share of the wall
time, the host time of the device flow's phases (spans
``pintron_step2_*``), the offload counters and kernel launches per
family, the host DP cells by family (``pintron_tpu.native.dp_census``)
and the device share of the DP cells.  Writes one JSON file (default
``chiprun_out/step2_measure.json``) and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
from collections import defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
STAGE2 = ("raw-multifasta-out.txt", "processed-ests.txt", "megs.txt",
          "processed-megs.txt", "meg-edges.txt")
CASES = ("test-TP53", "test-issue-13")
MODES = {"cuda": ("cuda", None), "cpu": ("cpu", None),
         "host1": (None, "1"), "host8": (None, "8")}


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _run(case_dir: str, tmp: str, mode: str) -> float:
    """One STEP 2 run of ``mode`` on a fresh copy; returns seconds."""
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    device, workers = MODES[mode]
    work = tempfile.mkdtemp(dir=tmp)
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(os.path.join(case_dir, name), work)
    if workers:
        os.environ["PINTRON_EST_WORKERS"] = workers
    try:
        t0 = time.perf_counter()
        run_est_fact(work, device=device)
        dt = time.perf_counter() - t0
    finally:
        os.environ.pop("PINTRON_EST_WORKERS", None)
    for name in STAGE2:
        with open(os.path.join(case_dir, name), "rb") as g, \
                open(os.path.join(work, name), "rb") as w:
            if g.read() != w.read():
                raise AssertionError(f"{mode}: {name} differs from golden")
    shutil.rmtree(work)
    return dt


def _profile(case_dir: str, tmp: str) -> dict:
    from pintron_tpu.native import dp_census, dp_census_reset
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
        wall = _run(case_dir, tmp, "cuda")
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
            "device_cell_share": dev_cells / (dev_cells
                                              + sum(census.values()))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "step2_measure.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_step2: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if os.environ.get("PINTRON_DEVICE"):
        raise RuntimeError("unset PINTRON_DEVICE (pintron_tpu would run "
                           "its JAX flow)")
    os.environ["PINTRON_FRESH_MEMO"] = "1"
    gpu = _card()
    out = {"gpu": gpu, "torch": torch.__version__, "reps": args.reps,
           "summary": {}, "profile": {}}
    tmp = tempfile.mkdtemp(prefix="measure-step2-")
    try:
        for case in CASES:
            case_dir = os.path.join(tmp, case)
            with tarfile.open(os.path.join(GOLDEN, f"{case}.tar.gz")) as tf:
                tf.extractall(case_dir, filter="data")
            with open(os.path.join(case_dir, "ests.txt")) as f:
                n_ests = sum(1 for ln in f if ln.startswith(">"))
            modes = list(MODES)
            for mode in modes:
                _run(case_dir, tmp, mode)            # untimed warm-up
            times = {m: [] for m in modes}
            for r in range(args.reps):
                order = modes if r % 2 == 0 else modes[::-1]
                for mode in order:
                    times[mode].append(_run(case_dir, tmp, mode))
            for mode, s in times.items():
                med = sorted(s)[len(s) // 2]
                out["summary"][f"{case}|{mode}"] = {
                    "n_ests": n_ests, "s": s, "median_s": med,
                    "ests_per_s_median": n_ests / med}
                print(f"{case} {mode}: {n_ests / med:.2f} ESTs/s "
                      f"(median of {len(s)}: {med:.6f} s)  [{gpu}]",
                      flush=True)
            prof = _profile(case_dir, tmp)
            out["profile"][case] = prof
            print(f"{case} profiled cuda run: wall {prof['wall_ms']:.3f} "
                  f"ms, device {prof['device_ms']} ms, busy "
                  f"{prof['device_busy_share']}, device share of DP "
                  f"cells {prof['device_cell_share']:.4f}, launches "
                  f"{prof['launches']}, stats {prof['stats']}, host phases "
                  f"{prof['host_phases_ms']}  [{gpu}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
