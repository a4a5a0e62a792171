"""STEP 3's cost beside its own work, in ms a locus: each
``pintron_step3`` span less the ``pintron_step3_child`` under it (the
guard server's child, whose times the pipeline records from the
server's reply), averaged over the window's loci that ran STEP 3 in a
child: the request and the reply, the wait and the join.  From the
program's spans of every process that ran a pipeline (this one, or
each job)."""


def read(ctx):
    lo, hi = ctx["window"]
    spent = []
    for spans in ctx["spans"].values():
        by_id = {s.id: s for s in spans}
        children = {}
        for s in spans:
            if s.name != "pintron_step3_child":
                continue
            up = by_id.get(s.parent)
            while up is not None and up.name != "pintron_step3":
                up = by_id.get(up.parent)
            if up is not None:
                children[up.id] = children.get(up.id, 0.0) + s.end - s.start
        spent += [s.end - s.start - children[s.id] for s in spans
                  if s.id in children and lo <= s.start <= hi]
    return 1000.0 * sum(spent) / len(spent) if spent else None
