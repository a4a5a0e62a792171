"""Device fuzz of STEP 2 (est-fact) on random spliced loci.

    python -m pintron_tpu_torch.fuzz_device [n_seeds] [seed_base] \
        [--device cuda|cuda:N|cpu]

Counterpart of the JAX package's ``tools/fuzz_device.py``.  Each case
is a synthetic locus (``tools.scale_stress.make_case``) on which STEP 2
runs twice, each time in a fresh process with a fresh memo
(``PINTRON_FRESH_MEMO=1``): once on ``device`` (every DP family of the
device flow on the card, or on the plain PyTorch versions with
``cpu``) and once with ``device="host"`` (the native host path).  The
five STEP 2 artifacts of the two runs must be equal byte for byte.

Off the golden loci's distribution, small factors make refine-intron
changes shift later pairs' windows, so the cases reach routes no golden
locus reaches.  The device run reports which ones: the offload's
counters (``offload.STATS``; its ``kband_ub_max``, the widest budget
the band kernel took, over 256 is ``kband_kernel``'s
33-cells-a-lane instance), the kernel launches by kernel
(``kband.LAUNCHES``; an ``edit_score`` launch in STEP 2 is the
full-matrix K-band route; a ``cpu`` run launches nothing), and the
host DP cells by family (``native.dp_census``; host ``gap_align``
cells are gap lookaside misses).

The grid is the reference tool's: seeds from ``seed_base`` (4000),
genomic 20, 50 and 100 kb in turn, 30, 60 and 120 ESTs every three
seeds; 15 seeds by default.  ``main`` exits 1 when a case differs or a
run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

from pintron_tpu_torch.ops.offload import check_card
from pintron_tpu_torch.regression import STAGE2_ARTIFACTS, differing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_LENS = (20_000, 50_000, 100_000)
N_ESTS = (30, 60, 120)

# one STEP 2 run in a fresh process; it prints, as its last line, the
# offload counters, the kernel launches and the host DP cells by family
_CHILD = """
import json, sys
from pintron_tpu_torch.native import dp_census
from pintron_tpu_torch.ops import kband, offload
from pintron_tpu_torch.stages.est_fact import run_est_fact
workdir, device = sys.argv[1:]
run_est_fact(workdir, device=device)
print(json.dumps(dict(stats=offload.STATS, launches=kband.LAUNCHES,
                      host_cells=dp_census() or {})))
"""


def grid(n_seeds: int = 15, seed_base: int = 4000):
    """(seed, gen_len, n_ests) of the reference tool's cases."""
    return [(seed_base + k, GEN_LENS[k % 3], N_ESTS[(k // 3) % 3])
            for k in range(n_seeds)]


def _env() -> dict:
    # the device run runs in its own process, never on a service
    env = {k: v for k, v in os.environ.items()
           if k != "PINTRON_TORCH_SERVICE"}
    env["PINTRON_FRESH_MEMO"] = "1"
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = REPO + (os.pathsep + path if path else "")
    return env


def routes_line(routes: dict) -> str:
    """One line of the routes a device run reached."""
    hc, stats = routes["host_cells"], routes["stats"]
    ub = stats["kband_ub_max"]
    return (f"full-matrix K-band launches {routes['launches']['edit_score']}"
            f", band budgets up to {ub}{' (over 256)' if ub > 256 else ''}, "
            f"host gap cells {hc.get('gap_align', 0)} (lookaside misses); "
            f"launches {routes['launches']}, stats {stats}, host cells {hc}")


def run_case(seed: int, gen_len: int, n_ests: int, device="cuda") -> dict:
    """One case: STEP 2 on ``device`` and on ``"host"``, each in a fresh
    process.  Returns {"ok": bytes equal and both runs clean, "detail":
    what differed or failed, "routes": the device run's report}."""
    from pintron_tpu_torch.tools.scale_stress import make_case
    base = tempfile.mkdtemp(prefix=f"fuzzdev-{seed}-")
    try:
        make_case(base, gen_len, n_ests, seed)
        works, routes = {}, None
        for mode in (str(device), "host"):
            work = os.path.join(base, mode.replace(":", "-"))
            os.makedirs(work)
            for fn in ("genomic.txt", "ests.txt"):
                shutil.copy(os.path.join(base, fn), work)
            r = subprocess.run([sys.executable, "-c", _CHILD, work, mode],
                               env=_env(), capture_output=True, text=True,
                               cwd=REPO)
            if r.returncode:
                tail = (r.stderr.strip().splitlines() or ["(no stderr)"])[-1]
                return {"ok": False, "routes": routes,
                        "detail": f"{mode} run failed (rc {r.returncode}): "
                                  f"{tail}"}
            if mode != "host":
                routes = json.loads(r.stdout.strip().splitlines()[-1])
            works[mode] = work
        bad = differing(works["host"], works[str(device)], STAGE2_ARTIFACTS)
        return {"ok": not bad, "routes": routes,
                "detail": f"bytes differ: {', '.join(bad)}" if bad else "ok"}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_seeds", nargs="?", type=int, default=15)
    p.add_argument("seed_base", nargs="?", type=int, default=4000)
    p.add_argument("--device", default="cuda",
                   help="the device run's device: cuda (the default), "
                        "cuda:N or cpu")
    args = p.parse_args(argv)
    if os.environ.get("PINTRON_DEVICE"):
        raise RuntimeError("unset PINTRON_DEVICE (the JAX package's "
                           "switch; the port refuses it)")
    device = check_card(args.device)
    fails = 0
    cases = grid(args.n_seeds, args.seed_base)
    for seed, gen_len, n_ests in cases:
        res = run_case(seed, gen_len, n_ests, device)
        print(f"{'OK ' if res['ok'] else 'FAIL'} seed={seed} gen={gen_len} "
              f"ests={n_ests}  {res['detail']}", flush=True)
        if res["routes"] is not None:
            print(f"     routes: {routes_line(res['routes'])}", flush=True)
        fails += not res["ok"]
    print(f"{len(cases) - fails}/{len(cases)} clean")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
