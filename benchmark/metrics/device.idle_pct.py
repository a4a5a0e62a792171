"""The share of the window in which the card ran no kernel, copy or
memset, in %, from the CUPTI timeline of the process that owns it."""

from benchmark.harness import trace


def read(ctx):
    tl = ctx["timeline"]
    if not tl or not tl["device"]:
        return None
    lo, hi = ctx["window"]
    return 100.0 * (1.0 - trace.busy_seconds(tl["device"], lo, hi)
                    / (hi - lo))
