"""The 90th percentile of a locus's wall time through STEPs 1-8, over
every locus of the window (``statistics.quantiles``, exclusive
method); a locus that failed counts as the slowest."""

import statistics


def read(ctx):
    walls = sorted(float("inf") if r["error"] else r["wall"]
                   for r in ctx["runs"])
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10)[-1]
