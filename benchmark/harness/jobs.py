"""Loci several at once, each in a process of its own, as
``pintron_tpu_torch.batch`` runs a manifest: the ``spawn`` context, one
non-daemonic process a locus (each pipeline forks STEP 2's workers,
which a daemonic process may not), the device service's socket and
``PINTRON_EST_WORKERS`` in the environment every job inherits.

``run`` keeps the traffic's ``clients`` jobs running while its caller
wants more, and waits on each job's pipe and on its process, so that a
job that dies without reporting is counted at once as a failed locus
(``batch.py`` counts it so) and never waited for.  ``job``, the target
of each process, does inside it what the window does around a locus in
one process: the recorder of the device's answers, armed in the
window; with ``traced``, the benchmark's spans around the STEPs, the
flow lines and the program's own spans; the locus; and back over the
pipe, its run's record with the job's pid, its spans and the modules
of ``runner.FORBIDDEN`` it loaded.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import shutil
import sys
import time
from multiprocessing import connection

# how long a job that reported may take to exit before it is killed
EXIT_S = 60.0


def job(conn, task: dict) -> None:
    """The target of a job's process: one locus; its run's record goes
    back over ``conn``, with ``entered``, the monotonic time at which
    the process had started and unpickled this call."""
    entered = time.monotonic()
    from benchmark.harness import faults, runner
    from benchmark.harness.record import Recorder
    from pintron_tpu_torch.ops import offload
    from pintron_tpu_torch.runtime import timing

    fault = task["fault"]
    if fault in faults.JOB_FAULTS:
        faults.plant_job(fault)
    elif fault:
        faults.plant_client(fault)
    if task["control"]:
        faults.control(offload)
    recorder = Recorder(task["records"], task["seed"])
    recorder.install(offload)
    recorder.armed = task["armed"]
    current = {"steps": []}
    with contextlib.ExitStack() as stack:
        flows = None
        if task["traced"]:
            flows = stack.enter_context(runner.step_spans(offload, current))
            timing.trace_on()
        rec = runner.run_one(task["locus"], task["workdir"], task["device"],
                             current, flows)
    timing.trace_off()
    rec["spans"] = timing.trace_take() if task["traced"] else None
    rec["entered"] = entered
    rec["forbidden"] = runner.forbidden_modules(sys.modules)
    conn.send(rec)
    conn.close()


def _dead(locus: dict, workdir: str, proc, t0: float) -> dict:
    t1 = time.monotonic()
    return {"locus": locus, "workdir": workdir, "start": t0, "end": t1,
            "wall": t1 - t0, "error": f"job died (exit {proc.exitcode})",
            "cpu": 0.0, "n_ests": locus["n_ests"], "steps": [],
            "step2_device_cells": None, "flow": None, "spans": None,
            "forbidden": []}


def _collect(conn, proc, locus: dict, workdir: str, t0: float) -> dict:
    """The record a job sent, or a failed one where it sent none; the
    job's process waited for (killed past ``EXIT_S``)."""
    rec = None
    try:
        if conn.poll():
            rec = conn.recv()
    except (EOFError, OSError):
        pass
    conn.close()
    proc.join(EXIT_S)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if rec is None:
        rec = _dead(locus, workdir, proc, t0)
    rec.update(locus=locus, workdir=workdir, pid=proc.pid, dispatched=t0,
               ended=time.monotonic())
    return rec


def run(the_run, order, more, armed: bool, traced: bool) -> list:
    """Loci from ``order`` as jobs of ``the_run`` (a ``runner.Run``),
    ``clients`` at once, while ``more(loci dispatched)``; returns the
    runs' records in start order once every job has ended, each with
    ``pid`` and, on the monotonic clock, ``dispatched`` and ``ended``:
    the job's process as this process saw it start and end."""
    from benchmark.harness import faults
    ctx = multiprocessing.get_context("spawn")
    fault = the_run.job_fault
    if fault in faults.JOB_FAULTS and not armed:
        fault = None   # set-up's warm-up has to finish
    running, runs = {}, []
    try:
        while True:
            while len(running) < the_run.clients and more(
                    len(runs) + len(running)):
                locus = next(order)
                wd = the_run._workdir(locus)
                task = {"locus": {k: locus[k] for k in
                                  ("name", "gene", "organism", "n_ests")},
                        "workdir": wd, "device": the_run.device,
                        "records": the_run.recorder.dir,
                        "seed": the_run.recorder.seed, "armed": armed,
                        "traced": traced, "control": the_run.controlled,
                        "fault": fault}
                recv, send = ctx.Pipe(duplex=False)
                proc = ctx.Process(target=job, args=(send, task))
                t0 = time.monotonic()
                proc.start()
                send.close()
                running[recv] = (proc, locus, wd, t0)
            if not running:
                break
            ready = connection.wait(
                [*running, *(p.sentinel for p, *_ in running.values())])
            for conn, (proc, locus, wd, t0) in list(running.items()):
                if conn in ready or proc.sentinel in ready:
                    del running[conn]
                    rec = _collect(conn, proc, locus, wd, t0)
                    the_run.job_forbidden.update(rec.pop("forbidden"))
                    runs.append(rec)
    finally:
        for conn, (proc, _locus, wd, _t0) in running.items():
            proc.kill()
            proc.join()
            conn.close()
            shutil.rmtree(wd, ignore_errors=True)
    runs.sort(key=lambda r: r["start"])
    return runs
