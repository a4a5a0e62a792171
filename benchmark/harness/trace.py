"""The traced run's timeline: ``torch.profiler`` (CUPTI) in the process
that owns the card, reduced to plain intervals on this machine's
monotonic clock, so that the harness can lay them beside the loci it
timed (in this process or in the device service's launcher).

``start()`` starts the profiler and enters a marker span whose start
it notes on the monotonic clock; ``stop(handle)`` stops it and returns
{"device": [(start, end, name)] of every kernel, copy and memset (not
the host spans' ranges that the trace also lays on the GPU timeline),
"host": [(start, end, name, thread)] of the host spans named
``pintron_*`` or ``bench.*``}, both in monotonic seconds.
"""

from __future__ import annotations

import time

HOST_PREFIXES = ("pintron_", "bench.")
MARKER = "bench.align"


def start():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        # the device batches run on dispatch threads, which the CPU
        # trace follows only when asked to
        prof = torch.profiler.profile(
            activities=acts,
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True))
    except (AttributeError, TypeError):
        prof = torch.profiler.profile(activities=acts)
    prof.start()
    with torch.profiler.record_function(MARKER):
        t_marker = time.monotonic()
    return prof, t_marker


def _on_card(ev) -> bool:
    return "CUDA" in str(getattr(ev, "device_type", ""))


def _is_span(ev) -> bool:
    """A ``record_function`` range; on the card's timeline it covers the
    gaps between its kernels, so it is no device work."""
    return (getattr(ev, "is_user_annotation", False)
            or ev.name.startswith(HOST_PREFIXES))


def stop(handle) -> dict:
    prof, t_marker = handle
    prof.stop()
    events = list(prof.events())
    base = None
    for ev in events:
        if ev.name == MARKER and not _on_card(ev):
            base = t_marker - ev.time_range.start / 1e6
            break
    if base is None:
        raise RuntimeError("the profiler's trace lost its marker span")
    device, host = [], []
    for ev in events:
        s = base + ev.time_range.start / 1e6
        e = base + ev.time_range.end / 1e6
        if _on_card(ev):
            if not _is_span(ev):
                device.append((s, e, ev.name))
        elif ev.name.startswith(HOST_PREFIXES) and ev.name != MARKER:
            host.append((s, e, ev.name, getattr(ev, "thread", 0)))
    return {"device": device, "host": host}


def union(intervals, lo: float, hi: float):
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    sorted disjoint (start, end) pairs."""
    cut = sorted((max(s, lo), min(e, hi)) for s, e, *_ in intervals
                 if e > lo and s < hi)
    out = []
    for s, e in cut:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_seconds(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(intervals, lo, hi))
