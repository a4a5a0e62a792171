"""A locus's process start-up, in ms a locus: the program's
``pintron_startup`` spans (``runtime/timing.py``: from a process's start
to its first locus's start; the spawn, the interpreter, the imports of
the port and its torch) whose end falls in the window, summed over every
process's spans, over the loci that started in the window.  With a
spawned job a locus, every locus has one.  None where the program
records no such span.

In a harness job (``harness/jobs.py``) the interval also holds what the
job does before its locus that a job of ``pintron_tpu_torch.batch``
does not: the import of ``benchmark.harness``'s modules, the faults and
the control where planted, the recorder of the device's answers and,
traced, the benchmark's STEP wrappers and the recorder turned on.  Once
the port is imported these take milliseconds on a CPU, against seconds
of torch's import, so the reading stands for ``batch.py``'s
``startup_s`` to within them."""


def read(ctx):
    lo, hi = ctx["window"]
    spent = [s.end - s.start for spans in ctx["spans"].values()
             for s in spans
             if s.name == "pintron_startup" and lo <= s.end <= hi]
    started = sum(1 for r in ctx["runs"] if lo <= r["start"] <= hi)
    return 1000.0 * sum(spent) / started if spent and started else None
