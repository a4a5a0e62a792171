"""Faults and the control, for the benchmark's own tests and readings:
never planted by a run of ``benchmark/run.py``.

  * ``answer``: an answer altered where it is produced: the largest
    problem of every K-band batch gets the other verdict, and the
    largest of every NW batch another first op code;
  * ``half``: half of each batch left out: the answers of the second
    half of every K-band, NW and refine-borders batch come back as
    zeros, as if never computed;
  * ``worker``: one fork worker's results lost in the merge: STEP 2's
    sharded flow drops what its last worker returns (the worker runs
    its units and sends its counters, as a sound one does);
  * ``die``: a job killed in the middle of its locus: the spawned
    process of a locus (traffic with ``clients`` > 1) kills itself with
    SIGKILL as STEP 4 starts, after STEPs 1-3;
  * ``control``: the benchmark's reference, one step of precision
    below the program's, in the program's place: STEP 4's PWM scores in
    bfloat16 (``reference/pwm.scores_bf16``).

``answer`` and ``half`` are planted in the program's ``_eval_*_device``
functions, in the process that runs them (the device service's, when
there is one); ``worker`` in the process that forks STEP 2's workers,
the pipeline's (each job's, with ``clients`` > 1); ``die`` in each job
of the window.
"""

from __future__ import annotations

import os
import signal

import numpy as np

DEVICE_FAULTS = ("answer", "half")
CLIENT_FAULTS = ("worker",)
JOB_FAULTS = ("die",)


def _wrap(offload, name, alter):
    orig = getattr(offload, name)

    def faulty(problems, device):
        return alter(problems, orig(problems, device))
    setattr(offload, name, faulty)
    return lambda: setattr(offload, name, orig)


def _largest(problems) -> int:
    return max(range(len(problems)),
               key=lambda i: len(problems[i][0]) * len(problems[i][1]))


def plant(offload, fault: str):
    """One of ``DEVICE_FAULTS`` in ``offload`` (the port's
    ``ops.offload`` module of the process that evaluates the batches);
    returns the function that takes it out again."""
    if fault not in DEVICE_FAULTS:
        raise ValueError(f"unknown device fault {fault!r}")

    def kband(problems, ok):
        ok = np.array(ok)
        if fault == "answer" and len(ok):
            i = _largest(problems)
            ok[i] = 1 - ok[i]
        elif fault == "half":
            ok[len(ok) // 2:] = 0
        return ok

    def nw(problems, res):
        ops, n, evaluated = (np.array(a) for a in res)
        i = _largest(problems) if len(n) else 0
        if fault == "answer" and len(n) and n[i] > 0:
            ops[i, 0] = (ops[i, 0] + 1) % 3
        elif fault == "half":
            ops[len(n) // 2:] = 0
            n[len(n) // 2:] = 0
        return ops, n, evaluated

    def rb(problems, res):
        vals, pos, evaluated = (np.array(a) for a in res)
        if fault == "half":
            vals[len(vals) // 2:] = 0
            pos[len(pos) // 2:] = 0
        return vals, pos, evaluated

    undo = [_wrap(offload, "_eval_kband_device", kband),
            _wrap(offload, "_eval_nw_device", nw),
            _wrap(offload, "_eval_rb_device", rb)]
    return lambda: [u() for u in reversed(undo)]


def plant_client(fault: str):
    """One of ``CLIENT_FAULTS`` in this process's STEP 2; returns the
    function that takes it out again."""
    if fault not in CLIENT_FAULTS:
        raise ValueError(f"unknown client fault {fault!r}")
    from pintron_tpu_torch.stages import est_fact
    orig = est_fact._run_units_device

    def lost(*args, shard=(0, 1), **kw):
        res = orig(*args, shard=shard, **kw)
        w, n = shard
        return [] if n > 1 and w == n - 1 else res
    est_fact._run_units_device = lost

    def undo():
        est_fact._run_units_device = orig
    return undo


def plant_job(fault: str) -> None:
    """One of ``JOB_FAULTS`` in this process, a job's."""
    if fault not in JOB_FAULTS:
        raise ValueError(f"unknown job fault {fault!r}")
    from pintron_tpu_torch.stages import intron_agreement

    def die(*args, **kw):
        os.kill(os.getpid(), signal.SIGKILL)
    intron_agreement.run_intron_agreement = die


def control(offload):
    """STEP 4's PWM scores from the reference in bfloat16; returns the
    function that puts the program's back."""
    from benchmark.reference import pwm

    def pwm_bf16(rows, wpwm, den):
        name = pwm.identify(np.asarray(wpwm, dtype=np.float32), den)
        if name is None:
            raise ValueError("control: a PWM batch of no known matrix")
        return pwm.scores_bf16(np.asarray(rows), name)
    orig = offload.pwm_scores_batched
    offload.pwm_scores_batched = pwm_bf16
    return lambda: setattr(offload, "pwm_scores_batched", orig)
