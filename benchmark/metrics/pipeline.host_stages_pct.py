"""The host stages' share of locus wall, in %: the pipeline's own
``pintron_step3`` (STEP 3's watchdog fork, its child and the join),
``pintron_step5`` ... ``pintron_step8`` and ``pintron_gtf`` spans, from
``torch.profiler``'s host events of the process that runs the pipeline
and owns the card, summed over the window's loci, over their summed
walls.  Where the profiled process runs no pipeline (the device
service's cells) or the program opens no such span, it reads
nothing."""

HOST_STAGES = ("pintron_step3", "pintron_step5", "pintron_step6",
               "pintron_step7", "pintron_step8", "pintron_gtf")


def read(ctx):
    tl = ctx["timeline"]
    wall = sum(r["wall"] for r in ctx["runs"])
    if not tl or wall <= 0:
        return None
    inside = 0.0
    for s, e, name, _th in tl["host"]:
        if name in HOST_STAGES:
            inside += sum(max(0.0, min(e, r["end"]) - max(s, r["start"]))
                          for r in ctx["runs"])
    return 100.0 * inside / wall if inside > 0 else None
