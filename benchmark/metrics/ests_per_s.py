"""ESTs per second: the ESTs of every locus the window ran through
STEPs 1-8, over the window's whole time (first locus's start to the
last one's end).  A locus that failed counts no ESTs."""


def read(ctx):
    w0, w1 = ctx["window"]
    ests = sum(r["n_ests"] for r in ctx["runs"] if not r["error"])
    return ests / (w1 - w0) if w1 > w0 else None
