"""STEP 2 (est-fact) of the port on every golden locus with inputs,
byte for byte against the goldens.

    python -m pintron_tpu_torch.tools.check_stage2 \
        [--device cuda|cuda:N|cpu|host] [case ...]

The counterpart of the JAX package's ``tools/check_stage2.py``.  The
cases are the ``tests/golden/test*.tar.gz``; a tarball without
``genomic.txt`` and ``ests.txt`` prints ``SKIP <case> (no inputs)``.
Unlike the JAX tool, it never looks for inputs outside the tarballs:
the reference's regression tree is not part of the repository.

Each case runs ``stages.est_fact.run_est_fact(work, device=...)`` in
this process with a fresh memo (``PINTRON_FRESH_MEMO=1``) and compares
the five STEP 2 artifacts (``regression.STAGE2_ARTIFACTS``) with the
golden's.  ``--device`` is ``cuda`` by default, as every entry point of
the port, and raises without a card; ``cpu`` runs the plain PyTorch
ops, ``host`` the native host path.  A ``cuda`` or ``cpu`` run in which
no problem of some family (K-band, NW, gap, refine-borders) routed to
the card reached the device fails with "no problem reached the device":
the JAX tool's guard against a run that fell back to the CPU.  Every
family is routed to the card unless its ``PINTRON_DEVICE_<F>`` is ``0``
or ``auto`` (``ops.offload.family_routes``).

Each locus prints one line: ESTs, seconds, ESTs/s, the offload's
counters per family, the device's share of the DP cells, each
traceback family's problems left to the host for their size
(``<family>_too_wide``) and the kernel launches (``ops.limits.LAUNCHES``;
a ``cpu`` run launches none).  ``check_case`` does the work of one
locus and returns it as a dict, for ``chip_smoke.py`` and the tests.
The exit code is 1 when a case fails.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tarfile
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "tests", "golden")
INPUTS = ("genomic.txt", "ests.txt")
# the offload's counter of each DP family's device problems (the K-band
# family's is what device_problems holds beyond the other three)
FAMILIES = ("nw_problems", "gap_problems", "rb_problems")
NO_DEVICE = "no problem reached the device"


def golden_cases():
    """Every golden case, by name."""
    return sorted(fn[:-len(".tar.gz")] for fn in os.listdir(GOLDEN)
                  if fn.startswith("test") and fn.endswith(".tar.gz"))


def unpack(case: str, dest: str) -> bool:
    """Unpack the case's golden tarball into ``dest``; True when it
    carries the inputs."""
    with tarfile.open(os.path.join(GOLDEN, f"{case}.tar.gz")) as tf:
        tf.extractall(dest, filter="data")
    return all(os.path.exists(os.path.join(dest, fn)) for fn in INPUTS)


def count_ests(path: str) -> int:
    with open(path) as f:
        return sum(1 for ln in f if ln.startswith(">"))


def family_problems(stats: dict) -> dict:
    """Device problems by family: kband, nw, gap, rb."""
    rest = {k.split("_")[0]: stats[k] for k in FAMILIES}
    return {"kband": stats["device_problems"] - sum(rest.values()), **rest}


def check_case(case: str, device="cuda") -> dict:
    """STEP 2 of one golden case on ``device``.  Returns {"case",
    "status" (OK, FAIL or SKIP), "device", "ests", "seconds",
    "ests_per_s", "families" (device problems by family), "stats"
    (offload.STATS), "buckets" (offload.BUCKETS), "launches" (this
    run's kernel launches), "host_cells" (native.dp_census),
    "device_share" (the device's share of the DP cells), "too_wide"
    (each traceback family's problems left to the host for their
    size), "differs" (what failed)}.  A failed case keeps its golden and work
    directories ("gold", "work")."""
    from pintron_tpu_torch.native import dp_census, dp_census_reset
    from pintron_tpu_torch.ops import limits, offload
    from pintron_tpu_torch.regression import STAGE2_ARTIFACTS, differing
    from pintron_tpu_torch.stages.est_fact import run_est_fact

    res = {"case": case, "device": str(device)}
    gold = tempfile.mkdtemp(prefix=f"s2-gold-{case}-")
    if not unpack(case, gold):
        shutil.rmtree(gold, ignore_errors=True)
        return dict(res, status="SKIP", differs=["no inputs"])
    work = tempfile.mkdtemp(prefix=f"s2-work-{case}-")
    for fn in INPUTS:
        shutil.copy(os.path.join(gold, fn), work)
    old = os.environ.get("PINTRON_FRESH_MEMO")
    os.environ["PINTRON_FRESH_MEMO"] = "1"
    try:
        offload.reset_stats()
        dp_census_reset()
        before = dict(limits.LAUNCHES)
        t0 = time.perf_counter()
        run_est_fact(work, device=device)
        dt = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("PINTRON_FRESH_MEMO", None)
        else:
            os.environ["PINTRON_FRESH_MEMO"] = old
    stats = dict(offload.STATS)
    n_ests = count_ests(os.path.join(work, "ests.txt"))
    res.update(ests=n_ests, seconds=dt, ests_per_s=n_ests / dt,
               families=family_problems(stats), stats=stats,
               buckets={fam: {f"{n}x{m}": k for (n, m), k in
                              sorted(launched.items())}
                        for fam, launched in offload.BUCKETS.items()},
               launches={k: limits.LAUNCHES[k] - before[k] for k in before},
               host_cells=dp_census() or {})
    total = stats["device_cells"] + sum(res["host_cells"].values())
    res.update(device_share=stats["device_cells"] / total if total else 0.0,
               too_wide={fam: stats[f"{fam}_too_wide"]
                         for fam in ("nw", "gap", "rb")})
    bad = differing(gold, work, [n for n in STAGE2_ARTIFACTS
                                 if os.path.exists(os.path.join(gold, n))])
    # a family routed to the card (offload.family_routes: forced) must
    # have sent problems; one at 0 or under the tuner need not
    forced = [fam for fam, route in offload.family_routes().items()
              if route == offload.CARD]
    if not offload.is_host(device) and (
            stats["device_runs"] == 0
            or min((res["families"][f] for f in forced), default=1) <= 0):
        bad.append(NO_DEVICE)
    res.update(status="FAIL" if bad else "OK", differs=bad)
    if bad:
        res.update(gold=gold, work=work)
    else:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(gold, ignore_errors=True)
    return res


def case_line(res: dict) -> str:
    """One line of a case's result."""
    if res["status"] == "SKIP":
        return f"SKIP {res['case']} (no inputs)"
    fam = res["families"]
    line = (f"{res['status']:4s} {res['case']:14s} {res['device']}: "
            f"{res['ests']} ESTs in {res['seconds']:.3f} s = "
            f"{res['ests_per_s']:.2f} ESTs/s; device problems kband/nw/"
            f"gap/rb {fam['kband']}/{fam['nw']}/{fam['gap']}/{fam['rb']}; "
            f"device share of DP cells {res['device_share']:.2%}; too "
            f"wide {res['too_wide']}; launches {res['launches']}")
    if res["differs"]:
        line += (f"  differs: {', '.join(res['differs'])} (kept "
                 f"{res['work']} against {res['gold']})")
    return line


def routes_line(res: dict) -> str:
    """The routes a device run reached, in ``fuzz_device.routes_line``'s
    form, with the NW, gap and refine-borders buckets it launched (and
    the passes of each kernel's rows through its row buffer) and its
    device cells beside the host's."""
    from pintron_tpu_torch.fuzz_device import routes_line as fuzz_routes
    from pintron_tpu_torch.ops.kband import edit_layout
    from pintron_tpu_torch.ops.traceback import NW_ROWS, gap_rows

    def rows_a_pass(fam, n, m):
        if fam == "nw":
            return n, 32 * NW_ROWS
        if fam == "gap":
            return n, 32 * gap_rows(n)
        r, g = edit_layout(m)
        return m, r * g

    parts = []
    for fam, launched in res["buckets"].items():
        shown = []
        for bucket, k in launched.items():
            n, m = (int(x) for x in bucket.split("x"))
            rows, per_pass = rows_a_pass(fam, n, m)
            shown.append(f"{bucket} x{k} ({-(-rows // per_pass)} pass"
                         f"{'es' if rows > per_pass else ''})")
        parts.append(f"{fam} buckets {', '.join(shown) or 'none'}")
    host = sum(res["host_cells"].values())
    return (fuzz_routes({"launches": res["launches"], "stats": res["stats"],
                         "host_cells": res["host_cells"]})
            + f"; {'; '.join(parts)}; device cells "
              f"{res['stats']['device_cells']} beside host DP cells {host}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cases", nargs="*",
                   help="golden cases (default: every test*.tar.gz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default), cuda:N, cpu (the plain "
                        "PyTorch ops) or host (the native host path)")
    args = p.parse_args(argv)
    from pintron_tpu_torch.ops import offload
    if not offload.is_host(args.device):
        offload.check_card(args.device)
    fails = 0
    for case in args.cases or golden_cases():
        res = check_case(case, args.device)
        print(case_line(res), flush=True)
        fails += res["status"] == "FAIL"
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
