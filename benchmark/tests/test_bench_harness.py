"""The benchmark's own tests (not collected by the repository's
``tests/`` run):

    python -m pytest benchmark/tests -q            # on the CPU, ~22 min
    python -m pytest benchmark/tests -q -m cuda    # on a card

On the CPU every cell is rehearsed with the port's plain versions
(``device="cpu"``), the service's cell on TP53 alone with 2 EST
workers, and again with two loci at once (``clients`` 2), each in a
spawned job, on three small upstream loci; the result's last line and
the checks' lines are held to the contract.
Every cell, configuration and metric must be found by name, no module
of the benchmark may import ``jax``, ``jaxlib``, ``flax`` or
``pintron_tpu`` (top-level names compared whole), neither in the
process that prints the result nor in the device service, and the
reference nothing of ``pintron_tpu_torch`` either.  The faults (an
answer altered where it is produced, half of each batch left out, one
fork worker's results lost in STEP 2's merge) and the control (the
reference's bfloat16 PWM scores in the program's place) must each turn
``correct`` false, in one process, through the device service and in
the spawned jobs; a job that dies counts as a failed locus, and one
that loaded ``jax`` keeps the result from being printed.
"""

from __future__ import annotations

import ast
import io
import json
import multiprocessing
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark.harness import cli, runner

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SEED = 2**31 + 4242
SERVICE_CELL = "batch-upstream-loci.sharded3"
# sizes a CPU holds: the smallest locus that shards (623 records; 128
# or more take the fork workers), two small upstream loci
SHARDED = {"traffic": {"loci": ["test-TP53"], "est_workers": 2}}
SMALL_LOCI = {"traffic": {"loci": ["test-AMBN", "test-mattia1"]}}
CELL_SIZES = {"cli-upstream-loci.all9": None, SERVICE_CELL: SHARDED}
UPSTREAM = json.loads((BENCH / "configs"
                       / "cli-upstream-loci.json").read_text())["loci"]


def _batch(loci, clients, est_workers):
    """The service's cell over other upstream loci, ``clients`` at once,
    each with ``est_workers`` EST workers."""
    return {"config": {"loci": {k: UPSTREAM[k] for k in loci}},
            "traffic": {"loci": loci, "clients": clients,
                        "est_workers": est_workers}}


SMALL3 = ["test-AMBN", "test-mattia1", "test-mattia3"]
CONCURRENT = _batch(SMALL3, 2, 1)
# a locus that shards (2 EST workers) in a job beside a small one
CONCURRENT_SHARDED = _batch(["test-TP53", "test-AMBN"], 2, 2)


def _rehearse(cell, overrides=None, trace=0):
    """A run of ``cell`` through the command line on the CPU; returns
    (exit code, stdout lines, stderr lines)."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(["--workload", cell, "--seed", str(SEED),
                       "--seconds", "0", "--trace", str(trace)],
                      0.0, 0.0, device="cpu", cards=lambda: 1,
                      overrides=overrides)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def _judged(cell, overrides, fault=None, control=False):
    """One window of ``cell`` on the CPU, judged."""
    return _window(cell, overrides, fault, control)[1]


def _window(cell, overrides, fault=None, control=False, trace=False):
    """One window of ``cell`` on the CPU: (the window, its verdict, the
    metric readers' context, the recorder's files)."""
    run = runner.Run(cell, device="cpu", fault=fault, overrides=overrides)
    try:
        run.setup(SEED)
        if control:
            run.control()
        win = run.window(SEED, 0.0, trace=trace)
        files = sorted(os.listdir(run.recorder.dir))
        return win, run.judge(win), cli.context(win, 0.0), files
    finally:
        run.close()


# ---- the contract -----------------------------------------------------------

def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
        names.add(c["name"])
    metrics = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert "setup_s" in metrics
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert set(m["workloads"]) <= set(CELLS)
        # each of its cells reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                             CELLS))
    for m in metrics.values():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for name in [c["name"] for c in SPEC["configs"]] + CELLS:
        assert NAME.match(name)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_config_and_metrics_are_found_by_name(cell):
    run = runner.Run(cell, device="cpu")
    assert (BENCH / "workloads" / f"{cell}.json").is_file()
    assert (BENCH / "deployments"
            / f"{run.config['deployment']}.py").is_file()
    assert run.traffic["generator"] == "golden"
    for traced in (False, True):
        for entry in runner.cell_metrics(SPEC, cell, traced):
            assert callable(runner.metric_module(entry["name"]).read)
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = {m["name"] for m in runner.cell_metrics(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert runner.cell_metrics(SPEC, cell, True)


def _py_files(*dirs):
    for d in dirs:
        yield from sorted((BENCH / d).rglob("*.py"))


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in list(_py_files(".")):
        tops = {m.split(".")[0] for m in _imported(path)}
        assert not tops & set(runner.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in _py_files("reference"):
        tops = {m.split(".")[0] for m in _imported(path)}
        assert "pintron_tpu_torch" not in tops, path
        assert not tops & set(runner.FORBIDDEN), path
    code = ("import sys; import benchmark.reference.check, "
            "benchmark.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, check=True)
    tops = set(json.loads(r.stdout.replace("'", '"')))
    assert not tops & {"pintron_tpu_torch", *runner.FORBIDDEN}


def test_forbidden_modules_compare_top_level_names_whole():
    assert runner.forbidden_modules(["pintron_tpu_torch.ops"]) == []
    assert runner.forbidden_modules(["pintron_tpu.ops", "jax.numpy",
                                     "flax"]) == ["flax", "jax",
                                                  "pintron_tpu"]


# ---- rehearsals -------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_rehearses_on_the_cpu(cell):
    rc, out, err = _rehearse(cell, CELL_SIZES[cell])
    assert rc == 0, err[-20:]
    res = json.loads(out[-1])
    assert res["correct"] is True, res["checks"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in runner.cell_metrics(SPEC, cell, False)}
    assert set(res["metrics"]) == want
    assert res["attempted"] >= 1 and res["failed"] == 0
    # the numbers compared, each beside its limit, end standard error
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in res["checks"].items()]
    assert err[-len(lines):] == lines
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_a_traced_rehearsal_reads_the_per_layer_metrics():
    rc, out, err = _rehearse(SERVICE_CELL, SHARDED, trace=1)
    assert rc == 0, err[-20:]
    res = json.loads(out[-1])
    assert res["correct"] is True
    # the CPU has no device timeline: its readers return nothing
    assert {"pipeline.step2_pct", "dp.device_cell_pct",
            "service.eval_pct", "service.merge_ratio",
            "step3.fork_ms"} <= set(res["metrics"])
    assert res["metrics"]["service.merge_ratio"]["value"] >= 1
    assert "kernel.busy_ms" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,overrides", [
    ("cli-upstream-loci.all9", SMALL_LOCI),
    (SERVICE_CELL, SHARDED)],
    ids=["in_process", "service"])
@pytest.mark.parametrize("fault", ["answer", "half"])
def test_a_fault_turns_correct_false(cell, overrides, fault):
    verdict = _judged(cell, overrides, fault=fault)
    assert verdict["correct"] is False
    assert verdict["checks"]["device_answers_differ"][0] > 0


@pytest.mark.parametrize("cell,overrides", [
    ("cli-upstream-loci.all9", SMALL_LOCI),
    (SERVICE_CELL, SHARDED)],
    ids=["in_process", "service"])
def test_the_control_turns_correct_false(cell, overrides):
    verdict = _judged(cell, overrides, control=True)
    assert verdict["correct"] is False
    gap, limit = verdict["checks"]["pwm_gap"]
    assert gap > 10 * limit


def test_a_lost_worker_turns_correct_false():
    """One fork worker's results dropped in STEP 2's merge: the device
    answers all agree, the artifacts and finals do not."""
    verdict = _judged(SERVICE_CELL, SHARDED, fault="worker")
    assert verdict["correct"] is False
    assert verdict["checks"]["device_answers_differ"][0] == 0
    assert verdict["checks"]["artifacts_differ"][0] > 0


def test_a_service_that_loaded_jax_prints_no_result(tmp_path, monkeypatch):
    """A stand-in ``jax`` that the device service's interpreter imports
    at start-up (``sitecustomize``): the run exits with EXIT_FORBIDDEN
    and prints no result line."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import jax\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    rc, out, err = _rehearse(SERVICE_CELL, SHARDED)
    assert rc == cli.EXIT_FORBIDDEN
    assert out == []
    assert "['jax'] in the device service" in err[-1]
    assert "jax" not in sys.modules


# ---- loci several at once, each in a spawned job ---------------------------

def _most_at_once(runs):
    edges = sorted([(r["dispatched"], 1) for r in runs]
                   + [(r["ended"], -1) for r in runs])
    most = n = 0
    for _t, step in edges:
        n += step
        most = max(most, n)
    return most


def test_concurrent_jobs_rehearse_correct_in_whole_sweeps():
    rc, out, err = _rehearse(SERVICE_CELL, CONCURRENT)
    assert rc == 0, err[-20:]
    res = json.loads(out[-1])
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == len(SMALL3) and res["failed"] == 0
    want = {m["name"] for m in runner.cell_metrics(SPEC, SERVICE_CELL,
                                                   False)}
    assert set(res["metrics"]) == want
    jobs = res["info"]["jobs"]
    assert len(jobs["spawn_s"]) == len(SMALL3)
    assert all(x > 0 for x in jobs["spawn_s"] + jobs["import_s"]
               + jobs["exit_s"])
    assert jobs["drain_s"] > 0
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in res["checks"].items()]
    assert err[-len(lines):] == lines and list(res)[-1] == "checks"


def test_concurrent_jobs_record_and_compare_what_one_client_does():
    """Two at once compare the same device answers as one at a time on
    the same loci, each job recording in a file of its own pid; no
    spans are kept untraced."""
    win, verdict, ctx, files = _window(SERVICE_CELL, CONCURRENT)
    _w1, one, _c1, _f1 = _window(SERVICE_CELL, _batch(SMALL3, 1, 1))
    assert verdict["correct"] is True and one["correct"] is True
    assert verdict["compared"] == one["compared"]
    assert {r["locus"]["name"] for r in win["runs"]} == set(SMALL3)
    pids = {r["pid"] for r in win["runs"]}
    assert len(pids) == len(SMALL3) and os.getpid() not in pids
    assert files == sorted(f"{pid}.pkl" for pid in pids)
    assert _most_at_once(win["runs"]) == 2
    starts = [r["start"] for r in win["runs"]]
    assert starts == sorted(starts)
    assert ctx["spans"] == {}
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("fault,overrides", [
    ("answer", CONCURRENT), ("half", CONCURRENT),
    ("worker", CONCURRENT_SHARDED), ("control", CONCURRENT)])
def test_a_fault_turns_correct_false_in_concurrent_jobs(fault, overrides):
    """Every fault of ``faults.py`` that fails one client, and the
    control, fail two at once: the client's reach each job."""
    control = fault == "control"
    verdict = _judged(SERVICE_CELL, overrides, fault=None if control
                      else fault, control=control)
    assert verdict["correct"] is False
    numbers = {k: v for k, (v, _lim) in verdict["checks"].items()}
    if control:
        assert numbers["pwm_gap"] > 10 * verdict["checks"]["pwm_gap"][1]
    elif fault == "worker":
        assert numbers["artifacts_differ"] > 0
    else:
        assert numbers["device_answers_differ"] > 0


def test_a_killed_job_counts_as_failed():
    """Each job of the window killed as its STEP 4 starts: every locus
    fails, and the window ends without waiting on a dead process."""
    box = {}

    def judge():
        box["verdict"] = _judged(SERVICE_CELL, CONCURRENT, fault="die")
    t0 = time.monotonic()
    th = threading.Thread(target=judge, daemon=True)
    th.start()
    th.join(300)
    assert not th.is_alive(), "the window waited on a dead job"
    verdict = box["verdict"]
    assert verdict["correct"] is False
    assert verdict["checks"]["loci_failed"][0] == len(SMALL3)
    assert time.monotonic() - t0 < 300
    assert multiprocessing.active_children() == []


def test_one_process_deployments_refuse_concurrent_clients():
    with pytest.raises(ValueError):
        runner.Run("cli-upstream-loci.all9", device="cpu",
                   overrides={"traffic": {"clients": 2}})
    with pytest.raises(ValueError):
        runner.Run(SERVICE_CELL, device="cpu", fault="die",
                   overrides=SHARDED)


def test_a_job_that_loaded_jax_prints_no_result(tmp_path, monkeypatch):
    """A stand-in ``jax`` that only the spawned jobs import at start-up
    (``sitecustomize``): the run prints no result line."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text(
        "with open('/proc/self/cmdline', 'rb') as f:\n"
        "    if b'--multiprocessing-fork' in f.read().split(b'\\0'):\n"
        "        import jax\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    rc, out, err = _rehearse(SERVICE_CELL, _batch(SMALL3[1:], 2, 1))
    assert rc == cli.EXIT_FORBIDDEN
    assert out == []
    assert "[] in the device service, ['jax'] in the loci's jobs" in err[-1]
    assert "jax" not in sys.modules


def test_a_traced_concurrent_window_has_every_process_spans():
    """The program's spans of the harness, the service and each job,
    each job one ``pintron_locus`` for its run, read by the per-layer
    metrics."""
    loci = SMALL3[1:]
    win, verdict, ctx, _files = _window(SERVICE_CELL, _batch(loci, 2, 1),
                                        trace=True)
    assert verdict["correct"] is True
    jobs = {f"job-{r['pid']}" for r in win["runs"]}
    assert set(ctx["spans"]) == {"harness", "service"} | jobs
    lo, hi = ctx["window"]
    for key in jobs:
        names = [s.name for s in ctx["spans"][key]]
        assert names.count("pintron_locus") == 1
        assert "pintron_step3_child" in names
        assert all(lo <= s.start <= s.end <= hi for s in ctx["spans"][key])
    service = {s.name for s in ctx["spans"]["service"]}
    assert {"pintron_service_eval", "pintron_service_request"} <= service
    for r in win["runs"]:
        assert {"step2", "step4", "step8"} <= {st for st, _s, _e
                                               in r["steps"]}
    for name in ("service.merge_ratio", "step3.fork_ms",
                 "pipeline.step2_pct", "dp.device_cell_pct"):
        value = runner.metric_module(name).read(ctx)
        assert value is not None and value > 0, name


def test_without_a_card_the_command_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if r.returncode == 0:
        pytest.skip("this machine has a card")
    assert r.stdout.strip() == ""


def test_alone_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cli-upstream-loci.all9", "--seed", str(SEED),
                        "--seconds", "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
