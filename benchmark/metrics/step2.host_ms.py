"""The host phases of STEP 2's device flow, in ms a locus: the time the
``pintron_step2_*`` host spans of ``stages/est_fact.py`` (MEG and
enumeration, the noisy collect, the cascade, the NW, refine-borders and
gap phases) cover, thread by thread, from ``torch.profiler``'s host
events in the window.  Only where the spans are recorded in the
profiled process: not in STEP 2's fork workers."""

from benchmark.harness import trace


def read(ctx):
    tl = ctx["timeline"]
    if not tl or not ctx["runs"]:
        return None
    lo, hi = ctx["window"]
    threads = {}
    for s, e, name, th in tl["host"]:
        if name.startswith("pintron_step2_"):
            threads.setdefault(th, []).append((s, e))
    if not threads:
        return None
    covered = sum(trace.busy_seconds(iv, lo, hi) for iv in threads.values())
    return 1000.0 * covered / len(ctx["runs"])
