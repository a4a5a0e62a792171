"""The command line of ``benchmark/run.py``: one run of one cell, its
result as the last line of standard output, and the numbers its check
compared, each beside its limit, as the last lines of standard
error."""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from benchmark.harness import breakdown, runner, trace

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def card_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def context(win: dict, setup_s: float) -> dict:
    """What the metric readers read (``benchmark/metrics/*.py``):
    ``spans`` holds the program's own spans (``runtime/timing.py``'s
    ``Span``, on the monotonic clock of ``runs`` and ``window``) by
    process, ``harness``, ``service`` and ``job-<pid>`` of each job, in
    traced windows; in untraced ones it is empty."""
    return {"runs": win["runs"], "window": win["window"],
            "timeline": win["timeline"], "evals": win["report"]["evals"],
            "spans": win["spans"], "setup_s": setup_s}


def measure(run: "runner.Run", seed: int, seconds: float, traced: bool,
            t_start: float, age: float):
    """Set up, run the window and judge it; returns the result line's
    object, with the check's numbers under ``checks``, and the
    forbidden modules that the process owning the card (the device
    service, where there is one) held once the window had closed."""
    run.setup(seed)
    win = run.window(seed, seconds, trace=traced)
    w0, w1 = win["window"]
    setup_s = age + (w0 - t_start)
    verdict = run.judge(win)
    ctx = context(win, setup_s)
    metrics = {}
    for entry in runner.cell_metrics(run.bench, run.cell["name"], traced):
        value = runner.metric_module(entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    rep = win["report"]
    device = {"platform": "gpu" if run.device.startswith("cuda") else "cpu",
              "kind": rep["kind"], "count": run.cell["chips"],
              "memory_peak_bytes": rep["memory_peak_bytes"]}
    out = {"correct": verdict["correct"], "attempted": len(win["runs"]),
           "failed": sum(1 for r in win["runs"] if r["error"]),
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = trace.busy_seconds(win["timeline"]["device"],
                                              w0, w1)
        device["window_s"] = w1 - w0
        out["breakdown"] = {
            "device_ops": breakdown.device_ops(win["timeline"], w0, w1),
            "idle_gaps": breakdown.idle_gaps(win["timeline"], win["runs"],
                                             w0, w1)}
    out["info"] = {"compared": verdict["compared"],
                   "differing": verdict["differing"],
                   "unchecked": verdict["unchecked"],
                   "pwm_windows": verdict["pwm_windows"],
                   "loci": _loci_summary(win["runs"]),
                   "steps_s": _steps(win["runs"]),
                   "cpu_s": win["cpu_s"],
                   "errors": [r["error"] for r in win["runs"]
                              if r["error"]][:3]}
    if run.clients > 1:
        out["info"]["jobs"] = _jobs_summary(win["runs"], run.clients,
                                            w0, w1)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in verdict["checks"].items()}
    return out, rep["forbidden"]


def _steps(runs: list) -> dict:
    """Seconds in each STEP (traced runs), summed over the loci;
    ``other`` is the rest of each locus's wall (STEP 1, the GTF)."""
    out = {}
    for r in runs:
        for step, s, e in r["steps"]:
            out[step] = out.get(step, 0.0) + e - s
        if r["steps"]:
            out["other"] = out.get("other", 0.0) + r["wall"] - sum(
                e - s for _st, s, e in r["steps"])
    return out


def _jobs_summary(runs: list, clients: int, lo: float, hi: float) -> dict:
    """Where the jobs' time went besides their loci: ``spawn_s``, from
    each job's dispatch to its target's entry (the interpreter's start,
    the call unpickled); ``import_s``, from there to its locus's start
    (the harness's and the port's imports: torch); ``exit_s``, from its
    locus's end to its process's end as this process saw it;
    ``drain_s``, the window's seconds in which fewer than ``clients``
    jobs ran."""
    edges = sorted([(r["dispatched"], 1) for r in runs]
                   + [(r["ended"], -1) for r in runs])
    drain, n, t = 0.0, 0, lo
    for x, step in edges:
        if n < clients:
            drain += min(max(x, lo), hi) - t
        n += step
        t = min(max(x, lo), hi)
    drain += hi - t
    entered = [r.get("entered", r["start"]) for r in runs]
    return {"spawn_s": [e - r["dispatched"] for e, r in zip(entered, runs)],
            "import_s": [r["start"] - e for e, r in zip(entered, runs)],
            "exit_s": [r["ended"] - r["end"] for r in runs],
            "drain_s": drain}


def _loci_summary(runs: list) -> dict:
    walls = sorted(r["wall"] for r in runs)
    p90 = (walls[-1] if len(walls) < 2
           else statistics.quantiles(walls, n=10)[-1])
    return {"count": len(runs), "beyond_p90": sum(1 for w in walls if w > p90),
            "ests": sum(r["n_ests"] for r in runs),
            "walls": [[r["locus"]["name"], r["wall"], r["cpu"]]
                      for r in runs]}


def main(argv, t_start: float, age: float, device: str = "cuda",
         cards=card_count, overrides: dict = None) -> int:
    """The command line; ``device``, ``cards`` and ``overrides`` let the
    benchmark's tests rehearse a run on the CPU at a size it holds."""
    p = argparse.ArgumentParser(prog="benchmark/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    run = runner.Run(args.workload, device=device, overrides=overrides)
    have = cards()
    if have < run.cell["chips"]:
        print(f"benchmark: the cell needs {run.cell['chips']} CUDA "
              f"device(s); torch sees {have}", file=sys.stderr)
        return EXIT_NO_CARD
    try:
        out, served = measure(run, args.seed, args.seconds,
                              bool(args.trace), t_start, age)
    finally:
        run.close()
    bad = runner.forbidden_modules(sys.modules)
    jobs = sorted(run.job_forbidden)
    if bad or served or jobs:
        print(f"benchmark: modules loaded that the port must not load: "
              f"{bad} in this process, {served} in the device service, "
              f"{jobs} in the loci's jobs", file=sys.stderr)
        return EXIT_FORBIDDEN
    info = out["info"]["loci"]
    print(f"loci {info['count']}, beyond the 90th percentile "
          f"{info['beyond_p90']}, ESTs {info['ests']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
