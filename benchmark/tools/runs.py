"""Runs of one cell, one process each, as the benchmark's check makes
them, with the spread of each metric.

    python3 benchmark/tools/runs.py --workload CELL --seeds A,B,... \
        --seconds S [--trace 0|1] [--out FILE.jsonl]

Each seed runs ``python3 benchmark/run.py`` once, in turn; every
result line (with the run's exit code, wall time and the last lines of
its standard error) goes to ``--out``, and a summary to standard
output: per metric the values, the median, the spread (the distance
between the quartiles of ``statistics.quantiles(values, n=4)`` as a
share of the median) and the spread with the run farthest from the
median left out, and the card's name and power limit.  Beside each run
it notes the CPU seconds the run's processes used (``cpu_s``): where a
slow run used more of them, the host's cores ran slower; where it used
as many, the run waited.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "run.py")
ROOT = os.path.dirname(os.path.dirname(RUN))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def spread(values: list):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def trimmed_spread(values: list):
    """The spread with the value farthest from the median left out."""
    if len(values) < 3:
        return None
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def cpu_seconds() -> float:
    """User and system seconds of this tool's waited-for children: a
    run's process, its fork workers and its device service."""
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="")
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    print(f"card: {card()}", flush=True)
    lines, values = [], {}
    for seed in seeds:
        t0 = time.monotonic()
        cpu0 = cpu_seconds()
        r = subprocess.run([sys.executable, RUN, "--workload", args.workload,
                            "--seed", str(seed), "--seconds",
                            str(args.seconds), "--trace", str(args.trace)],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=args.timeout)
        wall = time.monotonic() - t0
        host = {"cpu_s": cpu_seconds() - cpu0}
        out = r.stdout.strip().splitlines()
        try:
            res = json.loads(out[-1]) if out else None
        except json.JSONDecodeError:
            res = None
        line = {"workload": args.workload, "seed": seed, "rc": r.returncode,
                "wall_s": wall, "host": host, "result": res,
                "stderr_tail": r.stderr[-3000:]}
        lines.append(line)
        brief = ({k: v["value"] for k, v in res["metrics"].items()}
                 if res else None)
        print(json.dumps({"seed": seed, "rc": r.returncode, "wall_s": wall,
                          "host": host,
                          "correct": res and res["correct"],
                          "metrics": brief,
                          "checks": res and res.get("checks"),
                          "device": res and res["device"]}), flush=True)
        if res is None:
            print(r.stderr[-3000:], flush=True)
        for k, v in (brief or {}).items():
            values.setdefault(k, []).append(v)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    for k, vs in values.items():
        print(json.dumps({"metric": k, "values": vs,
                          "median": statistics.median(vs),
                          "spread": spread(vs),
                          "spread_less_farthest": trimmed_spread(vs)}),
              flush=True)
    return 0 if all(x["rc"] == 0 and x["result"] and x["result"]["correct"]
                    for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
