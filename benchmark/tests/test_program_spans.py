"""The per-layer metrics that read the program's own spans, rehearsed on
the CPU (``python -m pytest benchmark/tests -q``): a traced run of the
in-process cell on two small upstream loci reports
``pipeline.host_stages_pct`` and ``step3.fork_ms`` beside every
per-layer metric it reported before, and names its idle gaps by the
program's spans below the STEP."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

from benchmark.harness import cli, runner

CELL = "cli-upstream-loci.all9"
SEED = 2**31 + 4243
SMALL_LOCI = {"traffic": {"loci": ["test-AMBN", "test-mattia1"]}}


def test_a_traced_run_reads_the_program_spans():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", "0", "--trace", "1"], 0.0, 0.0,
                      device="cpu", cards=lambda: 1, overrides=SMALL_LOCI)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] is True
    metrics = res["metrics"]
    assert 0 < metrics["pipeline.host_stages_pct"]["value"] < 100
    assert metrics["pipeline.host_stages_pct"]["unit"] == "%"
    # the per-layer metrics the cell reported before (the CPU has no
    # device timeline: those of the card read nothing here)
    assert {"pipeline.step2_pct", "step2.host_ms",
            "dp.device_cell_pct"} <= set(metrics)
    # STEP 3 beside its guard server's child, from the recorder's spans
    assert metrics["step3.fork_ms"]["value"] > 0
    listed = {m["name"] for m in runner.cell_metrics(runner.spec(), CELL,
                                                     True)}
    assert "pipeline.host_stages_pct" in listed
    # with no kernel the whole window is one gap, named by the program's
    # innermost span at its middle
    (where, _secs), = res["breakdown"]["idle_gaps"]
    assert where.split()[-1].startswith("pintron_"), where
