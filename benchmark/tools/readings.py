"""The readings the check's limits are set from: in one process (one
set-up), a short window of a cell on each of a dozen seeds or more,
judged as a run judges it, then, where asked, a fault of the process
that runs the pipeline (``harness/faults.py``'s ``worker``: one fork
worker's results lost in STEP 2's merge; in each job, with ``clients``
> 1) on a few more, and last the control (the reference's bfloat16 PWM
scores in the program's place), judged alike.

    python3 benchmark/tools/readings.py --workload CELL \
        --seeds A,B,... --control-seeds C,D,E \
        [--fault worker --fault-seeds F,G,H] [--seconds S] \
        [--device cuda] [--out FILE.json]

Prints one JSON line a window (the seed, sound, fault or control, each
compared number, the problems compared by family) and, last, per number
the largest sound reading and the smallest fault and control readings.  The
benchmark's runs never plant a fault or the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path[0] = ROOT
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    from benchmark.harness import runner

    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faulty = [int(s) for s in args.fault_seeds.split(",") if s]
    run = runner.Run(args.workload, device=args.device)
    lines = []
    try:
        run.setup(seeds[0])
        undo = None
        for kind, batch in (("sound", seeds), ("fault", faulty),
                            ("control", controls)):
            if undo:
                undo()
                undo = None
            if kind == "fault" and batch:
                undo = run.plant_client(args.fault)
            if kind == "control" and batch:
                run.control()
            for seed in batch:
                win = run.window(seed, args.seconds)
                v = run.judge(win)
                line = {"kind": kind, "seed": seed,
                        "loci": len(win["runs"]), "correct": v["correct"],
                        "numbers": {k: x for k, (x, _lim)
                                    in v["checks"].items()},
                        "compared": v["compared"],
                        "differing": v["differing"]}
                lines.append(line)
                print(json.dumps(line), flush=True)
    finally:
        run.close()
    summary = {}
    for name in lines[0]["numbers"]:
        sound = [x["numbers"][name] for x in lines if x["kind"] == "sound"]
        ctrl = [x["numbers"].get(name) for x in lines
                if x["kind"] == "control"]
        hit = [x["numbers"].get(name) for x in lines
               if x["kind"] == "fault"]
        summary[name] = {"lower": max(sound),
                         "upper": min(ctrl) if ctrl else None,
                         "fault": min(hit) if hit else None}
    print(json.dumps({"workload": args.workload, "readings": summary}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"lines": lines, "readings": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
