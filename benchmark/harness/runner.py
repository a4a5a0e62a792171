"""One run of one cell: set-up, the measured window, the check, the
metrics and the result line.

Everything a cell is made of is found by name, from ``BENCHMARK.json``
at the root of the checkout: its configuration
(``benchmark/configs/<config>.json``, whose ``deployment`` names a
module of ``benchmark/deployments/``), its traffic
(``benchmark/workloads/<cell>.json``, read by
``benchmark/traffic/generate.py``) and each metric it reports
(``benchmark/metrics/<metric>.py``, whose ``read(ctx)`` returns the
number or None).  The limits of the check are in
``benchmark/reference/limits.json``.

A run (``Run``):

  1. ``setup``: the environment (a fresh memo for every locus, every
     DP family forced onto the card: no ``PINTRON_DEVICE_*``), the
     cell's loci from the seed, the deployment, the recorder of the
     device's answers, and one warm-up pass over the cell's distinct
     loci;
  2. ``window``: loci started one after another, each in a fresh work
     directory under the run's, until ``seconds`` have passed and a
     whole sweep of the traffic has run; the window runs from the first
     locus's start to the last one's end.  With the traffic's
     ``clients`` = 1 each locus runs in this process; with more, that
     many run at once, each in a process of its own spawned as
     ``pintron_tpu_torch.batch`` spawns a job (``harness/jobs.py``),
     set-up's warm-up too.  With ``trace``, the profiler in the process
     that owns the card, the benchmark's spans around the pipeline's
     STEPs, and the program's own spans (``runtime/timing.py``) of every
     process: this one, the device service and each job;
  3. ``judge``: each locus's STEP 2-4 artifacts and finals against the
     upstream's, the recorded device answers worked out again by the
     reference, each number beside its limit; every work directory
     deleted.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import logging
import os
import shutil
import tempfile
import time

from benchmark.harness import jobs
from benchmark.harness.record import Recorder
from benchmark.traffic import generate

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "pintron_tpu")
ROUTE_VARS = ("PINTRON_DEVICE_KBAND", "PINTRON_DEVICE_NW", "PINTRON_DEVICE_GAP",
              "PINTRON_DEVICE_RB", "PINTRON_TORCH_MESH", "PINTRON_TORCH_PROFILE")
# the pipeline's STEPs 2-8, as it calls them (module, function)
STEPS = (("step2", "pintron_tpu_torch.stages.est_fact", "run_est_fact"),
         ("step3", "pintron_tpu_torch.stages.min_factorization",
          "run_min_factorization"),
         ("step4", "pintron_tpu_torch.stages.intron_agreement",
          "run_intron_agreement"),
         ("step5", "pintron_tpu_torch.stages.compact",
          "run_compact_compositions"),
         ("step6", "pintron_tpu_torch.stages.transcripts",
          "run_maximal_transcripts"),
         ("step7", "pintron_tpu_torch.stages.ccds", "run_cds_annotation"),
         ("step8", "pintron_tpu_torch.stages.emit", "compute_json"))
FLOW_PREFIX = "est-fact device flow: "


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def metric_module(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The entries of the metrics the cell reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def cpu_seconds() -> float:
    """CPU seconds of this process and its waited-for children (STEP 3's
    forked child, STEP 2's fork workers): a run that did the same work
    in more of them ran on slower cores, one that used as many waited."""
    t = os.times()
    return t.user + t.system + t.children_user + t.children_system


def forbidden_modules(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class _FlowLines(logging.Handler):
    """Keeps the ``est-fact device flow:`` lines STEP 2 logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(FLOW_PREFIX):
            self.lines.append(json.loads(msg[len(FLOW_PREFIX):]))


def run_locus(workdir: str, locus: dict, device: str) -> None:
    """STEPs 1-8 on one locus, as the CLI runs a gene (with -k)."""
    from pintron_tpu_torch.pipeline import pintron_pipeline
    pintron_pipeline(workdir=workdir, output_filename="full.json",
                     gtf_filename="pintron-all-isoforms.gtf",
                     gene=locus["gene"], organism=locus["organism"],
                     keep_intermediate=True, device=device)


def wrap_steps(offload, current: dict):
    """The benchmark's own spans around the pipeline's STEPs (traced
    runs): each STEP's interval on the monotonic clock, and STEP 2's
    device DP cells (the offload's counter, which adds the fork
    workers' own).  Returns (module, name, original) of each."""
    import torch
    saved = []
    for step, modname, fn in STEPS:
        mod = importlib.import_module(modname)
        orig = getattr(mod, fn)

        def wrapper(*a, _orig=orig, _step=step, **kw):
            cells0 = offload.STATS["device_cells"]
            t0 = time.monotonic()
            try:
                with torch.profiler.record_function(f"bench.{_step}"):
                    return _orig(*a, **kw)
            finally:
                current["steps"].append((_step, t0, time.monotonic()))
                if _step == "step2":
                    current["step2_device_cells"] = (
                        offload.STATS["device_cells"] - cells0)
        setattr(mod, fn, wrapper)
        saved.append((mod, fn, orig))
    return saved


@contextlib.contextmanager
def step_spans(offload, current: dict):
    """A traced window's spans around the STEPs (``wrap_steps``) and its
    handler of the flow lines, which it yields."""
    flows, log = _FlowLines(), logging.getLogger("pintron")
    level = log.level
    log.addHandler(flows)
    log.setLevel(logging.INFO)
    saved = wrap_steps(offload, current)
    try:
        yield flows
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)
        log.removeHandler(flows)
        log.setLevel(level)


def run_one(locus: dict, workdir: str, device: str, current: dict,
            flows) -> dict:
    """One locus of the window, timed; returns its run's record."""
    current.clear()
    current["steps"] = []
    n_flows = len(flows.lines) if flows else 0
    c0 = cpu_seconds()
    t0 = time.monotonic()
    error = None
    try:
        run_locus(workdir, locus, device)
    except Exception as e:  # noqa: BLE001 - counted as failed
        error = f"{type(e).__name__}: {e}"
    t1 = time.monotonic()
    return {"locus": locus, "workdir": workdir, "start": t0, "end": t1,
            "wall": t1 - t0, "error": error, "cpu": cpu_seconds() - c0,
            "n_ests": locus["n_ests"], "steps": list(current["steps"]),
            "step2_device_cells": current.get("step2_device_cells"),
            "flow": (flows.lines[-1] if flows and len(flows.lines) > n_flows
                     else None)}


class Run:
    def __init__(self, cell: str, device: str = "cuda", fault: str = None,
                 overrides: dict = None):
        from benchmark.harness import faults
        self.bench = spec()
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
        self.cell = cells[cell]
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[self.cell["config"]]
        self.config = load_json(os.path.join(ROOT, entry["file"]))
        self.traffic = load_json(os.path.join(BENCH, "workloads",
                                              f"{cell}.json"))
        # the benchmark's tests run a cell at a size a CPU can hold
        overrides = overrides or {}
        self.config.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.clients = self.traffic["clients"]
        self.deployment = importlib.import_module(
            f"benchmark.deployments.{self.config['deployment']}")
        if self.clients > 1 and not getattr(self.deployment, "CONCURRENT",
                                            False):
            raise ValueError(f"{cell}: {self.config['deployment']} runs "
                             f"one client; {self.clients} asked")
        if fault in faults.JOB_FAULTS and self.clients == 1:
            raise ValueError(f"{fault!r} kills a job: it needs clients > 1")
        self.limits = load_json(os.path.join(BENCH, "reference",
                                             "limits.json"))
        self.device = device
        self.fault = fault
        # what each spawned job plants (clients > 1)
        self.job_fault = (fault if fault in faults.CLIENT_FAULTS
                          + faults.JOB_FAULTS else None)
        self.controlled = False
        self._uncontrol = None
        self.job_forbidden = set()
        self.work = None
        self.dep = None
        self.recorder = None
        self.seed = None
        self.loci = None
        self.offload = None

    # ---- set-up ---------------------------------------------------------
    def setup(self, seed: int) -> None:
        from benchmark.harness import faults
        for var in ROUTE_VARS:
            os.environ.pop(var, None)
        os.environ["PINTRON_FRESH_MEMO"] = "1"
        self.work = tempfile.mkdtemp(prefix="pintron-bench-")
        self.seed = seed
        self.loci = generate.loci(self.config, self.traffic, seed, self.work)
        self.dep = self.deployment.make(
            self.config, self.traffic, self.device, self.work,
            None if self.fault in faults.JOB_FAULTS else self.fault)
        self.dep.start()
        self.recorder = Recorder(os.path.join(self.work, "records"), seed)
        if self.clients > 1:
            runs = jobs.run(self, iter(self.loci),
                            lambda n: n < len(self.loci), False, False)
            for r in runs:
                shutil.rmtree(r["workdir"], ignore_errors=True)
            failed = [r["error"] for r in runs if r["error"]]
            if failed:
                raise RuntimeError(f"warm-up: {failed[0]}")
            return
        from pintron_tpu_torch.ops import offload
        self.offload = offload
        self.recorder.install(offload)
        for locus in self.loci:
            wd = self._workdir(locus)
            run_locus(wd, locus, self.device)
            shutil.rmtree(wd, ignore_errors=True)

    def control(self) -> None:
        """Put the reference's bfloat16 PWM scores in the program's place
        (the readings' control; the recorder keeps recording them): in
        this process, or in every job spawned from now on."""
        from benchmark.harness import faults
        if self.clients > 1:
            self.controlled = True
            return
        self.recorder.uninstall(self.offload)
        self._uncontrol = faults.control(self.offload)
        self.recorder.install(self.offload)

    def plant_client(self, fault: str):
        """One of ``faults.CLIENT_FAULTS`` where the pipeline runs: in this
        process, or in every job spawned from now on; returns the
        function that takes it out again."""
        from benchmark.harness import faults
        if self.clients == 1:
            return faults.plant_client(fault)
        if fault not in faults.CLIENT_FAULTS:
            raise ValueError(f"unknown client fault {fault!r}")
        self.job_fault = fault

        def undo():
            self.job_fault = None
        return undo

    def _workdir(self, locus: dict) -> str:
        wd = tempfile.mkdtemp(prefix="locus-", dir=self.work)
        with open(os.path.join(wd, "genomic.txt"), "wb") as f:
            f.write(locus["genomic"])
        with open(os.path.join(wd, "ests.txt"), "wb") as f:
            f.write(locus["ests"])
        return wd

    # ---- the window -----------------------------------------------------
    def window(self, seed: int, seconds: float, trace: bool = False) -> dict:
        if seed != self.seed:
            self.loci = generate.loci(self.config, self.traffic, seed,
                                      self.work)
        order = generate.schedule(self.traffic, self.loci, seed)
        unit = generate.sweep_length(self.traffic, self.loci)
        self.recorder.clear()
        self.recorder.seed = seed
        from pintron_tpu_torch.runtime import timing
        with contextlib.ExitStack() as stack:
            flows = None
            current = {"steps": []}
            if trace:
                if self.clients == 1:
                    flows = stack.enter_context(
                        step_spans(self.offload, current))
                self.dep.trace_start()
                timing.trace_on()
            runs = []
            self.recorder.armed = True
            cpu_w0 = cpu_seconds()
            t_w0 = time.monotonic()

            def more(n: int) -> bool:
                return not (n and n % unit == 0
                            and time.monotonic() - t_w0 >= seconds)
            try:
                if self.clients > 1:
                    runs = jobs.run(self, order, more, True, trace)
                else:
                    while more(len(runs)):
                        locus = next(order)
                        runs.append(run_one(locus, self._workdir(locus),
                                            self.device, current, flows))
            finally:
                self.recorder.armed = False
                t_w1 = time.monotonic()
                cpu_w1 = cpu_seconds()
                spans = {}
                if trace:
                    timing.trace_off()
                    spans["harness"] = timing.trace_take()
                timeline = self.dep.trace_stop() if trace else None
        if timeline and "spans" in timeline:
            spans["service"] = timeline.pop("spans")
        for r in runs:
            if r.get("spans") is not None:
                spans[f"job-{r['pid']}"] = r.pop("spans")
        report = self.dep.report()
        return {"runs": runs, "window": (t_w0, t_w1), "timeline": timeline,
                "report": report, "seed": seed, "spans": spans,
                "cpu_s": cpu_w1 - cpu_w0}

    # ---- the check ------------------------------------------------------
    def judge(self, win: dict) -> dict:
        """Every number the check compares, as {name: (value, limit)},
        with the counts the reference compared, by family."""
        from benchmark.reference import check, compare
        runs = win["runs"]
        failed = sum(1 for r in runs if r["error"])
        artifacts = finals = 0
        for r in runs:
            if r["error"]:
                continue
            loc = r["locus"]
            res = compare.check_locus(r["workdir"], loc["gold"],
                                      loc["finals"], loc["gene"])
            artifacts += len(res["artifacts"])
            finals += not (res["finals_ok"] and res["gene_ok"])
        for r in runs:
            shutil.rmtree(r["workdir"], ignore_errors=True)
        ans = check.check(self.recorder.load(), win["seed"])
        unchecked = [f for f in self.traffic["families"]
                     if not ans["compared"].get(f)]
        numbers = {"loci_failed": failed,
                   "families_unchecked": len(unchecked),
                   "device_answers_differ": sum(ans["differing"].values()),
                   "artifacts_differ": artifacts,
                   "finals_differ": finals}
        if ans["pwm_gap"] is not None:
            numbers["pwm_gap"] = ans["pwm_gap"]
        checks = {k: (v, self.limits[k]) for k, v in numbers.items()}
        return {"checks": checks,
                "correct": all(v <= lim for v, lim in checks.values()),
                "compared": ans["compared"], "differing": ans["differing"],
                "unchecked": unchecked, "pwm_windows": ans["pwm_windows"]}

    def close(self) -> None:
        if self.recorder is not None and self.offload is not None:
            self.recorder.uninstall(self.offload)
        if self._uncontrol:
            # the program's PWM entry back, for a later run in this
            # process (the benchmark's tests)
            self._uncontrol()
            self._uncontrol = None
        if self.dep is not None:
            self.dep.stop()
            self.dep = None
        if self.work:
            shutil.rmtree(self.work, ignore_errors=True)
            self.work = None
