"""The manifest cell, ``batch-manifest-loci.all9-j8``, rehearsed on the
CPU (``python -m pytest benchmark/tests -q``) at a size the CPU holds:
two small upstream loci, two jobs at once, one traced window through
the command line.  It is correct and reports its per-layer metric,
``job.startup_ms``, a positive number; the reader reads nothing where
the program records no ``pintron_startup`` span."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

from benchmark.harness import cli, runner
from pintron_tpu_torch.runtime.timing import Span

CELL = "batch-manifest-loci.all9-j8"
SEED = 2**31 + 4244
SMALL = {"traffic": {"loci": ["test-AMBN", "test-mattia1"], "clients": 2}}


def test_a_traced_rehearsal_reads_each_job_start_up():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", "0", "--trace", "1"], 0.0, 0.0,
                      device="cpu", cards=lambda: 1, overrides=SMALL)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 2 and res["failed"] == 0
    listed = {m["name"] for m in runner.cell_metrics(runner.spec(), CELL,
                                                     True)}
    assert listed == {"job.startup_ms"}
    startup = res["metrics"]["job.startup_ms"]
    assert startup["value"] > 0 and startup["unit"] == "ms/locus"


def test_the_reader_reads_nothing_without_the_span():
    """The program before ``pintron_startup``: its jobs' spans hold a
    locus and no start-up."""
    locus = Span("pintron_locus", 1.0, 2.0, 1, None, 7, 7, {})
    ctx = {"window": (0.0, 3.0), "runs": [{"start": 1.0}],
           "spans": {"job-7": [locus]}}
    assert runner.metric_module("job.startup_ms").read(ctx) is None
    startup = Span("pintron_startup", 0.5, 1.0, 2, None, 7, 7, {})
    ctx["spans"]["job-7"].append(startup)
    assert runner.metric_module("job.startup_ms").read(ctx) == 500.0
