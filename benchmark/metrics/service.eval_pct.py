"""The device service's evaluation time over the window, in %: the
batches the service evaluated (its ``eval_s``, by interval, from the
benchmark's launcher), clipped to the window and merged, over the
window."""

from benchmark.harness import trace


def read(ctx):
    evals = ctx["evals"]
    if not evals:
        return None
    lo, hi = ctx["window"]
    busy = trace.busy_seconds([(s, e) for _op, s, e in evals], lo, hi)
    return 100.0 * busy / (hi - lo)
