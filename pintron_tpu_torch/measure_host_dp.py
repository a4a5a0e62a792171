"""The self-tuner's constants (``ops/offload.py``), measured on the
card's machine: the host DP's seconds a cell for each STEP 2 family,
the card's call floor, and the small-batch gates of rb and gap.

    python -m pintron_tpu_torch.measure_host_dp [--reps 5] \
        [--floor-calls 200] [--device cuda] [--nw-shapes] [--out FILE]

1. Problems: STEP 2 on TP53 and issue-13 (``tests/golden/``) on
   ``--device`` with every family on it (one process, fresh memo,
   byte-compared with the goldens), every batch that the flow hands
   ``offload.eval_kband``, ``eval_nw``, ``eval_gap`` and ``eval_rb``
   recorded.
2. Host rate: each family's recorded problems through the native DP
   that the cascade itself calls when the family is on the host (dp.c:
   ``kband_core`` or ``edit_total`` as ``ep_kband`` routes a problem,
   ``nw_align_run``, ``gap_align_run``, and ``refine_borders_core`` once
   for the two passes of a refine-borders problem), in this thread, best
   of ``--reps`` sweeps; seconds a cell as ``offload.tune_cells`` counts
   the family's batches.  Each problem pays one ``ctypes`` call that the
   cascade does not.
3. Call floor: each entry (``eval_kband``, ``eval_nw``, ``eval_gap``,
   ``eval_rb``) on a batch of one problem, the family's smallest
   recorded one that reaches its kernel, median of ``--floor-calls``
   calls on the device: the dispatch thread, the copies and the launch.
4. The gates: for rb and gap, the fewest problems whose host estimate at
   the family's mean recorded cells a problem reaches the slowest
   family's call floor.

With ``--nw-shapes`` it does only this instead: each launch of
``measure_nw.OVERSIZED_NW_SHAPES`` (the NW launches of 788, issue-2,
issue-13 and gtf5), the seeded batch that ``chip_smoke.py`` phase 3
gives ``nw_kernel``, through ``nw_align_run`` in this thread, best of
``--reps`` sweeps (default ``chiprun_out/host_dp_nw_shapes.json``).

Prints the CPU model (``/proc/cpuinfo``) and the card's name and power
limit beside the numbers, and writes them as JSON (default
``chiprun_out/host_dp.json``).  A device that is not a CUDA card must be
asked for (``--device cpu``: the plain versions' call floor, no card's).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch

from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.regression import STAGE2_ARTIFACTS, differing
from pintron_tpu_torch.runtime.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CASES = ("test-TP53", "test-issue-13")
ENTRIES = {"kband": "eval_kband", "nw": "eval_nw", "gap": "eval_gap",
           "rb": "eval_rb"}


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo gives it: its model name (or, where
    it names none, vendor, family, model and stepping) and the count."""
    fields, count = {}, 0
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            count += key == "processor"
            fields.setdefault(key, value.strip())
    name = fields.get("model name", "unknown")
    if name == "unknown":   # a virtual machine's cpuinfo may name none
        name = ", ".join(
            f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                         "stepping") if k in fields)
    return f"{name or 'unknown'} ({count} CPUs)"


def record_problems(case_dir: str, tmp: str, device) -> dict:
    """{family: [batch, ...]} that STEP 2 on ``case_dir`` sends to the
    offload entries; the run's artifacts must equal the golden's."""
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    batches = {fam: [] for fam in ENTRIES}
    real = {fam: getattr(offload, name) for fam, name in ENTRIES.items()}

    def recorder(fam):
        def entry(problems):
            batches[fam].append(list(problems))
            return real[fam](problems)
        return entry

    work = tempfile.mkdtemp(dir=tmp)
    for fn in ("genomic.txt", "ests.txt"):
        shutil.copy(os.path.join(case_dir, fn), work)
    for fam, name in ENTRIES.items():
        setattr(offload, name, recorder(fam))
    try:
        run_est_fact(work, device=device)
    finally:
        for fam, name in ENTRIES.items():
            setattr(offload, name, real[fam])
    bad = differing(case_dir, work, STAGE2_ARTIFACTS)
    if bad:
        raise AssertionError(f"{case_dir}: {', '.join(bad)} differ")
    return batches


def _host_kband(lib, problems):
    for g, e, ub in problems:
        if ub == 0 or g == e:
            continue
        a, b = (g, e) if len(g) >= len(e) else (e, g)
        n, m = len(a), len(b)
        if n - m > ub:
            continue
        if 2 * ub + 1 >= n:
            lib.edit_total(a, n, b, m)
        else:
            lib.kband_core(a, n, b, m, ub)


def _host_traceback(run, problems):
    cap = max(len(e) + len(g) for e, g in problems) + 1
    est_al = ctypes.create_string_buffer(cap)
    gen_al = ctypes.create_string_buffer(cap)
    out = np.zeros(8, dtype=np.int64)
    for e, g in problems:
        run(e, len(e), g, len(g), est_al, gen_al, out.ctypes.data)


def _host_rb(lib, problems):
    # the flow sends the forward and the reversed pass of each problem;
    # refine_borders_core runs both passes of one
    out = np.zeros(6, dtype=np.int64)
    for t, p in problems[0::2]:
        lp, lt = len(p), len(t)
        lib.refine_borders_core(p, lp, 0, lp, t, lt, max(lt - lp, 0),
                                out.ctypes.data)


def host_seconds(lib, family: str, problems) -> float:
    """One sweep of the native host DP over a family's problems."""
    t0 = time.perf_counter()
    if family == "kband":
        _host_kband(lib, problems)
    elif family == "nw":
        _host_traceback(lib.nw_align_run, problems)
    elif family == "gap":
        _host_traceback(lib.gap_align_run, problems)
    else:
        _host_rb(lib, problems)
    return time.perf_counter() - t0


def call_floor(family: str, problem, calls: int) -> dict:
    """The entry's wall time on a batch of one problem, on the device
    set with ``offload.use_device``."""
    entry = getattr(offload, ENTRIES[family])
    for _ in range(5):
        entry([problem])
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        entry([problem])
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0],
            "problem_lens": [len(x) for x in problem[:2]]}


def smallest(family: str, problems):
    """The smallest recorded problem of a family that reaches its
    kernel (K-band: one with a DP; NW: one with e != g)."""
    cands = [p for p in problems
             if offload.tune_cells(family, [p]) > 0
             and (family != "nw" or p[0] != p[1])]
    return min(cands, key=lambda p: offload.tune_cells(family, [p]))


def oversized_nw(lib, reps: int, card: str, cpu: str) -> dict:
    """The host's seconds for each OVERSIZED_NW_SHAPES launch's seeded
    batch (``measure_nw.main_path_nw_batch``, as phase 3 makes it),
    best of ``reps`` sweeps of ``nw_align_run``."""
    from pintron_tpu_torch.measure_nw import (OVERSIZED_NW_SHAPES,
                                              main_path_nw_batch)
    rows = []
    for i, shape in enumerate(OVERSIZED_NW_SHAPES):
        est, elen, gen, glen, _N, _M = main_path_nw_batch(shape, i)
        problems = [(est[b, :elen[b]].tobytes(), gen[b, :glen[b]].tobytes())
                    for b in range(len(elen))]
        best = min(host_seconds(lib, "nw", problems) for _ in range(reps))
        cells = offload.tune_cells("nw", problems)
        rows.append({"shape": shape, "host_s": best, "cells": cells})
        print(f"nw oversized {shape[0]} ({shape[1]} problems, bucket "
              f"({shape[2]}, {shape[3]})): host {best * 1e3:.3f} ms for "
              f"{cells} cells  [{card}; {cpu}]", flush=True)
    total = sum(r["host_s"] for r in rows)
    print(f"nw oversized: the {len(rows)} launches' problems on the host "
          f"in {total * 1e3:.3f} ms  [{card}; {cpu}]", flush=True)
    return {"card": card, "cpu": cpu, "reps": reps, "host_s": total,
            "launches": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--floor-calls", type=int, default=200)
    p.add_argument("--device", default="cuda")
    p.add_argument("--nw-shapes", action="store_true",
                   help="time only OVERSIZED_NW_SHAPES' batches on the host")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = offload.use_device(args.device)
    from pintron_tpu_torch.native import get_lib
    lib = get_lib()
    card = card_line() if device.type == "cuda" else "cpu"
    cpu = cpu_model()
    if args.nw_shapes:
        out = oversized_nw(lib, args.reps, card, cpu)
        return _write(out, args.out or os.path.join(
            REPO, "chiprun_out", "host_dp_nw_shapes.json"))
    args.out = args.out or os.path.join(REPO, "chiprun_out", "host_dp.json")
    os.environ["PINTRON_FRESH_MEMO"] = "1"
    for fam in offload.FAMILIES:
        if os.environ.get(offload.family_env(fam)):
            raise RuntimeError(f"unset {offload.family_env(fam)}: every "
                               "family's batches are recorded")
    tmp = tempfile.mkdtemp(prefix="measure-host-dp-")
    out = {"card": card, "cpu": cpu, "torch": torch.__version__,
           "reps": args.reps, "cases": {}, "host": {}, "floor": {}}
    problems = {fam: [] for fam in ENTRIES}
    try:
        for case in CASES:
            case_dir = os.path.join(tmp, case)
            with tarfile.open(os.path.join(GOLDEN, f"{case}.tar.gz")) as tf:
                tf.extractall(case_dir, filter="data")
            record_problems(case_dir, tmp, device)       # build, warm
            batches = record_problems(case_dir, tmp, device)
            out["cases"][case] = {fam: [len(b) for b in bs]
                                  for fam, bs in batches.items()}
            for fam, bs in batches.items():
                for b in bs:
                    problems[fam].append((case, b))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for fam, batches in problems.items():
        flat = [x for _case, b in batches for x in b]
        cells = sum(offload.tune_cells(fam, b) for _case, b in batches)
        by_case = {}
        for case in CASES:
            mine = [x for c, b in batches if c == case for x in b]
            by_case[case] = {
                "problems": len(mine),
                "cells": sum(offload.tune_cells(fam, b)
                             for c, b in batches if c == case)}
        best = min(host_seconds(lib, fam, flat) for _ in range(args.reps))
        out["host"][fam] = {
            "problems": len(flat), "cells": cells, "best_s": best,
            "s_per_cell": best / cells, "by_case": by_case,
            "mean_cells_per_problem": cells / len(flat)}
        out["floor"][fam] = call_floor(fam, smallest(fam, flat),
                                       args.floor_calls)
        print(f"{fam}: {len(flat)} problems, {cells} cells, host "
              f"{best:.6f} s = {best / cells:.4e} s/cell; call floor "
              f"median {out['floor'][fam]['median_s'] * 1e3:.4f} ms, min "
              f"{out['floor'][fam]['min_s'] * 1e3:.4f} ms  [{card}; {cpu}]",
              flush=True)
    floor = max(f["median_s"] for f in out["floor"].values())
    out["call_floor_s"] = floor
    out["min_batch"] = {
        fam: math.ceil(floor / (out["host"][fam]["s_per_cell"]
                                * out["host"][fam]["mean_cells_per_problem"]))
        for fam in ("rb", "gap")}
    print(f"call floor {floor * 1e3:.4f} ms (the slowest family's median); "
          f"small-batch gates {out['min_batch']}  [{card}; {cpu}]",
          flush=True)
    return _write(out, args.out)


def _write(out: dict, path: str) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
