"""STEP 2's share of locus wall, in %: the benchmark's own span around
``stages.est_fact.run_est_fact`` as the pipeline calls it, summed over
the window's loci, over their summed walls."""


def read(ctx):
    wall = sum(r["wall"] for r in ctx["runs"])
    step2 = sum(e - s for r in ctx["runs"] for st, s, e in r["steps"]
                if st == "step2")
    return 100.0 * step2 / wall if wall > 0 and step2 > 0 else None
