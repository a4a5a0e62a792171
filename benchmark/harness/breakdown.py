"""The traced run's breakdown: the device operations that took the most
time in the window, and the longest gaps in which the card ran nothing,
each named by where the host was: the locus, the pipeline's STEP (the
benchmark's spans) and, where this process recorded one, the innermost
``pintron_*`` host span open at the gap's middle."""

from __future__ import annotations

from benchmark.harness import trace

TOP = 10


def device_ops(timeline: dict, lo: float, hi: float) -> list:
    by_name = {}
    for s, e, name in timeline["device"]:
        if e > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + min(e, hi) - max(s, lo)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], secs] for name, secs in top]


def _where(t: float, runs: list, host: list) -> str:
    for r in runs:
        if r["start"] <= t <= r["end"]:
            where = r["locus"]["name"]
            steps = [st for st, s, e in r["steps"] if s <= t <= e]
            where += " " + (steps[0] if steps else "other")
            spans = [(e - s, name) for s, e, name, _th in host
                     if s <= t <= e and name.startswith("pintron_")]
            if spans:
                where += " " + min(spans)[1]
            return where
    return "between loci"


def idle_gaps(timeline: dict, runs: list, lo: float, hi: float) -> list:
    busy = trace.union(timeline["device"], lo, hi)
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)), reverse=True)[:TOP]
    return [[_where(start + secs / 2, runs, timeline["host"]), secs]
            for secs, start in gaps if secs > 0]
