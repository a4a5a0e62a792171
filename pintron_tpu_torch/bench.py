"""Benchmark of the port: STEP 2 (est-fact) ESTs/s on the AMBN locus,
and the device channels.

    python -m pintron_tpu_torch.bench [--device cuda|cuda:N|cpu] \
        [--blocks 7] [--runs 4] ...

Counterpart of the JAX package's ``bench.py``.  Prints exactly one JSON
line at the end.

Headline: STEP 2 on AMBN (``tests/golden/test-AMBN.tar.gz``, 25 ESTs)
with a fresh memo each run (``PINTRON_FRESH_MEMO=1``), best of
``blocks`` x ``runs``.  ``value`` is the port's default path,
``run_est_fact(work, device)`` in this process (AMBN is under
``FORK_MIN_RECORDS``, so one process in any case); ``host_ests_per_s``
is the native host path (``device="host"``, the JAX package's default
mode), timed in the same blocks, the two modes in turns.  The first
fresh run of each mode is held against AMBN's golden STEP 2 artifacts:
a wrong run raises, and no rate is printed.  ``vs_baseline`` divides by
the stored rate of the reference's single-core C est-fact, 175.0 ESTs/s
(``baseline_source: "stored"``; the repository holds no reference
binary to time beside the port).  ``warm_repeat_ests_per_s`` is the
default path again with the memo kept across runs.

The device channels run in a child process bounded by ``--timeout``,
which prints its cumulative JSON after each channel:

  kernel  ``kband_kernel`` and its plain PyTorch version on the device,
          (B, rows, W) = (32768, 256, 33) over 8 distinct input sets,
          chains of 8 calls, best of ``kernel_reps``: cells/s of each,
          their ratio, the kernel's time over its bound (the larger of
          its bytes over the HBM rate and its integer operations over
          the INT32 peak, ``measure_kband.kband_bound``), and the card;
  mode    the device service (``batch.start_service``) and STEP 2 on
          AMBN through it, forced (no ``PINTRON_DEVICE_<F>`` set: every
          family on the card) and under the self-tuner (all four
          ``auto``; the tuner cleared once, before the warm runs), in
          turns, best of ``mode_runs``, the JAX bench's keys: the auto
          run's ESTs/s (``device_mode_ests_per_s``), problems offloaded,
          the device's share of the DP cells against the host census,
          the host cells by family and the latches it ends with; the
          forced run's under ``device_mode_forced_ests_per_s``,
          ``device_cell_fraction_forced`` and the other ``_forced``
          keys; the service's launches of both;
  stress  the synthetic 1 Mb x 5000 EST locus (``tools.scale_stress.
          make_case``, seed 7), STEP 2 through the service against the
          host path's fork pool, fresh memo, in turns, best of
          ``stress_runs``: ESTs/s and walls of both, their ratio, the
          device problems, the device's share of the DP cells and the
          host cells by family (host ``gap_align`` cells are gap
          lookaside misses); beside them in turns the K-band-only flow
          (NW, gap and refine-borders at 0, the JAX bench's run):
          ESTs/s, wall and device share; the first runs of the three
          must be equal byte for byte.

A channel that fails, or a child that times out, puts
``device_channels_error`` (the channel and the last line of the child's
stderr) into the JSON line, and the bench exits 1.  With
``--device cuda`` and no card the bench raises; ``cpu`` runs the plain
PyTorch versions everywhere (the tests use it, at one repetition).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch

from pintron_tpu_torch.ops.offload import check_card
from pintron_tpu_torch.regression import STAGE2_ARTIFACTS, differing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "test-AMBN.tar.gz")

# The reference's single-core C est-fact on AMBN, 25 ESTs in 0.143 s,
# measured on a CPU box of an earlier round (BASELINE.md): a CPU number.
BASELINE_ESTS_PER_S = 175.0

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy_inputs(src: str, tmp: str) -> str:
    work = tempfile.mkdtemp(dir=tmp)
    for fn in ("genomic.txt", "ests.txt"):
        shutil.copy(os.path.join(src, fn), work)
    return work


def _same_files(a: str, b: str, what: str) -> None:
    bad = differing(a, b, STAGE2_ARTIFACTS)
    if bad:
        raise AssertionError(f"{what}: {', '.join(bad)} differ")


class _env:
    """Set (value str) or unset (None) environment variables for a
    block, restoring them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _FlowLog(logging.Handler):
    """Keeps the last ``est-fact device flow:`` line of the device flow
    (its counters, host DP cells and device share), which covers the
    sharded flow's workers too."""

    PREFIX = "est-fact device flow: "

    def __init__(self):
        super().__init__(logging.INFO)
        self.last = None

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(self.PREFIX):
            self.last = json.loads(msg[len(self.PREFIX):])

    def __enter__(self):
        log = logging.getLogger("pintron")
        self.level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger("pintron")
        log.removeHandler(self)
        log.setLevel(self.level)


def _timed_step2(work: str, device) -> float:
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    t0 = time.perf_counter()
    run_est_fact(work, device=device)
    return time.perf_counter() - t0


def headline(gold: str, tmp: str, n_ests: int, device, *, blocks: int,
             runs: int, warm_runs: int) -> dict:
    """The headline: STEP 2 on AMBN, ``device`` and ``"host"`` in turns
    in ``blocks`` blocks of ``runs`` fresh runs each, then
    ``warm_runs`` runs of ``device`` with the memo kept.  The first
    fresh run of each mode is held against the goldens."""
    # the host path first: its fork pool starts before CUDA does
    modes = ("host", str(device))
    works = {m: _copy_inputs(gold, tmp) for m in modes}
    best = {m: float("inf") for m in modes}
    with _env(PINTRON_FRESH_MEMO="1", PINTRON_TORCH_SERVICE=None):
        for m in modes:
            _timed_step2(works[m], m)      # builds, CUDA start, pool
            _same_files(gold, works[m], f"headline {m}, first fresh run")
        for _block in range(blocks):
            for m in modes:
                for _ in range(runs):
                    best[m] = min(best[m], _timed_step2(works[m], m))
    best_warm = float("inf")
    with _env(PINTRON_FRESH_MEMO=None, PINTRON_TORCH_SERVICE=None):
        for _ in range(warm_runs):
            best_warm = min(best_warm, _timed_step2(works[str(device)],
                                                    device))
    # vs_baseline is the printed value's ratio (rounding the unrounded
    # rate's could differ from it in the last digit)
    value = round(n_ests / best[str(device)], 2)
    return {
        "metric": "est-fact throughput (AMBN locus, fresh-locus work)",
        "value": value, "unit": "ESTs/s", "device": str(device),
        "vs_baseline": round(value / BASELINE_ESTS_PER_S, 3),
        "baseline_ests_per_s": BASELINE_ESTS_PER_S,
        "baseline_source": "stored",
        "host_ests_per_s": round(n_ests / best["host"], 2),
        "warm_repeat_ests_per_s": round(n_ests / best_warm, 2),
        "headline_runs": blocks * runs}


# ---- the device channels (run in the child process) -------------------------

def kband_sets(B: int, M: int, K: int, n_sets: int, seed: int = 0):
    """The kernel channel's input sets, as the JAX bench makes them:
    seq1 random codes of N = M + K, seq2 its first M codes with 8 point
    changes in every 64th problem, full lengths, band K."""
    N = M + K
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(n_sets):
        s1 = rng.integers(0, 4, (B, N), dtype=np.int8)
        s2 = np.take_along_axis(
            s1, np.broadcast_to(np.arange(M), (B, M)), axis=1).copy()
        mut = rng.integers(0, M, (B, 8))
        for b in range(0, B, 64):
            s2[b, mut[b]] = (s2[b, mut[b]] + 1) % 4
        sets.append((s1, np.full(B, N, dtype=np.int32), s2,
                     np.full(B, M, dtype=np.int32),
                     np.full(B, K, dtype=np.int32)))
    return sets


def channel_kernel(o: dict) -> dict:
    """``kband_kernel`` against its plain version on the device."""
    from pintron_tpu_torch.measure_kband import kband_bound
    from pintron_tpu_torch.ops import align
    from pintron_tpu_torch.ops.align import from_numpy_batch
    from pintron_tpu_torch.ops.kband import banded_edit_distance_cuda
    from pintron_tpu_torch.runtime.timing import card_line
    device = torch.device(o["device"])
    B, M, K = o["kernel_batch"], 256, 16
    W = 2 * K + 1
    host_sets = kband_sets(B, M, K, o["kernel_sets"])
    sets = [from_numpy_batch(*s[:4], s[4], device=device)
            for s in host_sets]
    cells = B * M * W
    out = {"device_kernel_batch": [B, M, W],
           "device_card": card_line() if device.type == "cuda" else "cpu"}
    kw = dict(max_rows=M, k_max=K)
    got = banded_edit_distance_cuda(*sets[0], **kw)
    want = align.banded_edit_distance(*sets[0], **kw)
    _sync(device)
    out["device_kband_max_abs_err"] = int(
        (got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError("kband_kernel != its plain version on "
                             f"{int((got != want).sum())} of {B} problems")
    chain = o["chain"]
    for name, fn in (("kernel", banded_edit_distance_cuda),
                     ("plain", align.banded_edit_distance)):
        best = float("inf")
        for _ in range(o["kernel_reps"]):
            _sync(device)
            t0 = time.perf_counter()
            for i in range(chain):
                fn(*sets[i % len(sets)], **kw)
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / chain)
        out[f"device_kband_{name}_ms"] = best * 1e3
        out[f"device_kband_{name}_cells_per_s"] = round(cells / best)
    out["device_kband_kernel_vs_plain"] = round(
        out["device_kband_plain_ms"] / out["device_kband_kernel_ms"], 2)
    _s1, l1, _s2, l2, band = host_sets[0]
    # the clock sets only the chain floor, which is not reported here
    b_ms, by, _chain = kband_bound(l1, l2, band, M, clock_hz=1.98e9)
    out.update(device_kband_bound_ms=b_ms, device_kband_bound_by=by,
               device_kband_bound_share=b_ms / out["device_kband_kernel_ms"])
    return out


def _service_runs(work: str, device: str, sock: str, n: int):
    """``n`` fresh STEP 2 runs of ``work`` through the service; returns
    (best seconds, the last run's device-flow log line)."""
    from pintron_tpu_torch.ops import offload
    best = float("inf")
    with _env(PINTRON_FRESH_MEMO="1", PINTRON_TORCH_SERVICE=sock), \
            _FlowLog() as flow:
        for _ in range(n):
            offload.reset_stats()
            best = min(best, _timed_step2(work, device))
    return best, flow.last


def _routes_env(value=None, families=None) -> dict:
    """The four family switches (``offload.family_env``): ``families``
    (all by default) set to ``value``, the others unset."""
    from pintron_tpu_torch.ops import offload
    families = offload.FAMILIES if families is None else families
    return {offload.family_env(f): value if f in families else None
            for f in offload.FAMILIES}


def channel_mode(o: dict) -> dict:
    """STEP 2 on AMBN through the device service, forced (no switch set)
    and with every family under the self-tuner, in turns."""
    from pintron_tpu_torch.batch import start_service, stop_service
    from pintron_tpu_torch.ops import offload
    modes = {"forced": _routes_env(), "auto": _routes_env("auto")}
    best = dict.fromkeys(modes, float("inf"))
    flow = {}
    tmp = tempfile.mkdtemp(prefix="pintron-bench-mode-")
    try:
        work = _copy_inputs(o["gold"], tmp)
        proc, sock = start_service(o["device"])
        try:
            offload.reset_tuner()
            for mode, env in modes.items():
                with _env(**env):
                    _service_runs(work, o["device"], sock, 1)       # warm
                _same_files(o["gold"], work,
                            f"device mode {mode}, first fresh run")
            for _ in range(o["mode_runs"]):
                for mode, env in modes.items():
                    with _env(**env):
                        dt, flow[mode] = _service_runs(work, o["device"],
                                                       sock, 1)
                    best[mode] = min(best[mode], dt)
        finally:
            report = stop_service(proc, sock)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if report is None:
        raise RuntimeError("the device service did not report")
    auto, forced = flow["auto"], flow["forced"]
    return {"device_mode_ests_per_s": round(o["n_ests"] / best["auto"], 2),
            "device_mode_problems_offloaded":
                auto["stats"]["device_problems"],
            "device_cell_fraction": round(auto["device_cell_share"], 4),
            "host_cells_by_family": auto["host_dp_cells"],
            "device_cells_per_run": auto["stats"]["device_cells"],
            "device_mode_latches": auto["latches"],
            "device_mode_forced_ests_per_s":
                round(o["n_ests"] / best["forced"], 2),
            "device_mode_forced_problems_offloaded":
                forced["stats"]["device_problems"],
            "device_cell_fraction_forced":
                round(forced["device_cell_share"], 4),
            "host_cells_by_family_forced": forced["host_dp_cells"],
            "device_cells_per_run_forced": forced["stats"]["device_cells"],
            "device_mode_service_launches": report["launches"],
            "device_mode_runs": o["mode_runs"]}


def channel_stress(o: dict) -> dict:
    """The synthetic stress locus: the device flow through the service
    against the host path's fork pool, and the K-band-only flow (NW,
    gap and refine-borders at 0) beside them."""
    from pintron_tpu_torch.batch import start_service, stop_service
    from pintron_tpu_torch.tools.scale_stress import make_case
    glen, n_ests, seed = o["stress_case"]
    tmp = tempfile.mkdtemp(prefix="pintron-bench-stress-")
    try:
        src = tempfile.mkdtemp(dir=tmp)
        made = make_case(src, glen, n_ests, seed)
        dev_work, host_work = _copy_inputs(src, tmp), _copy_inputs(src, tmp)
        kb_work = _copy_inputs(src, tmp)
        kb_env = _routes_env("0", ("nw", "gap", "rb"))
        proc, sock = start_service(o["device"])
        try:
            _service_runs(dev_work, o["device"], sock, 1)       # warm
            with _env(**kb_env):
                _service_runs(kb_work, o["device"], sock, 1)
            with _env(PINTRON_FRESH_MEMO="1", PINTRON_TORCH_SERVICE=None):
                _timed_step2(host_work, "host")
            _same_files(host_work, dev_work, "stress, device against host")
            _same_files(host_work, kb_work, "stress, K-band only against "
                        "host")
            best_dev = best_kb = best_host = float("inf")
            problems = None
            for _ in range(o["stress_runs"]):
                dt, flow = _service_runs(dev_work, o["device"], sock, 1)
                best_dev = min(best_dev, dt)
                problems = flow["stats"]["device_problems"]
                with _env(**kb_env):
                    dt, kb_flow = _service_runs(kb_work, o["device"], sock,
                                                1)
                best_kb = min(best_kb, dt)
                with _env(PINTRON_FRESH_MEMO="1",
                          PINTRON_TORCH_SERVICE=None):
                    best_host = min(best_host,
                                    _timed_step2(host_work, "host"))
        finally:
            report = stop_service(proc, sock)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if report is None:
        raise RuntimeError("the device service did not report")
    return {"stress_case": [glen, made, seed],
            "stress_device_ests_per_s": round(made / best_dev, 1),
            "stress_cpu_ests_per_s": round(made / best_host, 1),
            "stress_device_vs_cpu": round(best_host / best_dev, 3),
            "stress_device_s": best_dev, "stress_cpu_s": best_host,
            "stress_device_problems": problems,
            "stress_device_workers": flow["workers"],
            "stress_device_cell_fraction": round(
                flow["device_cell_share"], 4),
            "stress_host_cells_by_family": flow["host_dp_cells"],
            "stress_device_kband_only_ests_per_s": round(made / best_kb, 1),
            "stress_device_kband_only_s": best_kb,
            "stress_kband_only_cell_fraction": round(
                kb_flow["device_cell_share"], 4),
            "stress_service_launches": report["launches"],
            "stress_runs": o["stress_runs"]}


CHANNELS = {"kernel": channel_kernel, "mode": channel_mode,
            "stress": channel_stress}


def channels_main(argv) -> int:
    """The child: run the channels named in the options (one JSON
    argument) in order, printing the cumulative JSON after each; a
    channel that raises ends the child with its traceback."""
    o = json.loads(argv[0])
    res = {"device_channels_done": []}
    for name in o["channels"]:
        res.update(CHANNELS[name](o))
        res["device_channels_done"].append(name)
        print(json.dumps(res), flush=True)
    return 0


def run_device_channels(o: dict, timeout: float) -> dict:
    """Run the channels in a child process bounded by ``timeout``
    seconds; returns their results, with ``device_channels_error`` when
    a channel failed or the child timed out."""
    cmd = [sys.executable, "-c",
           "import sys; from pintron_tpu_torch import bench; "
           "sys.exit(bench.channels_main(sys.argv[1:]))", json.dumps(o)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=REPO)
        out, err, rc = r.stdout, r.stderr, r.returncode
    except subprocess.TimeoutExpired as e:
        out, err, rc = e.stdout or "", e.stderr or "", None
        if isinstance(out, bytes):
            out = out.decode("utf-8", "replace")
        if isinstance(err, bytes):
            err = err.decode("utf-8", "replace")
    res = {"device_channels_done": []}
    for line in reversed(out.strip().splitlines()):
        try:
            res = json.loads(line)
            break
        except ValueError:
            continue
    done = res.pop("device_channels_done")
    if rc != 0 or done != list(o["channels"]):
        # every channel done and the child failed after: its exit
        failed = next((c for c in o["channels"] if c not in done), "exit")
        tail = (err.strip().splitlines() or ["(no stderr)"])[-1]
        res["device_channels_error"] = {
            "channel": failed,
            "stderr": tail if rc is not None
            else f"timed out after {timeout:g} s; {tail}"}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default), cuda:N or cpu")
    p.add_argument("--blocks", type=int, default=7)
    p.add_argument("--runs", type=int, default=4,
                   help="fresh runs of each mode a block")
    p.add_argument("--warm-runs", type=int, default=9)
    p.add_argument("--kernel-batch", type=int, default=32768)
    p.add_argument("--kernel-sets", type=int, default=8)
    p.add_argument("--chain", type=int, default=8)
    p.add_argument("--kernel-reps", type=int, default=4)
    p.add_argument("--mode-runs", type=int, default=3)
    p.add_argument("--stress-case", type=int, nargs=3,
                   default=[1_000_000, 5000, 7],
                   metavar=("GLEN", "N_ESTS", "SEED"))
    p.add_argument("--stress-runs", type=int, default=3)
    p.add_argument("--timeout", type=float, default=1500,
                   help="seconds the device channels' child may take")
    args = p.parse_args(argv)
    device = check_card(args.device)
    preset = [var for var in _routes_env() if os.environ.get(var)]
    if preset:
        raise RuntimeError(f"unset {', '.join(preset)}: the bench sets the "
                           "family switches of each run itself")
    tmp = tempfile.mkdtemp(prefix="pintron-torch-bench-")
    try:
        gold = os.path.join(tmp, "gold")
        with tarfile.open(GOLDEN) as tf:
            tf.extractall(gold, filter="data")
        with open(os.path.join(gold, "ests.txt")) as f:
            n_ests = sum(1 for line in f if line.startswith(">"))
        out = headline(gold, tmp, n_ests, device, blocks=args.blocks,
                       runs=args.runs, warm_runs=args.warm_runs)
        out.update(run_device_channels({
            "device": str(device), "channels": list(CHANNELS), "gold": gold,
            "n_ests": n_ests, "kernel_batch": args.kernel_batch,
            "kernel_sets": args.kernel_sets, "chain": args.chain,
            "kernel_reps": args.kernel_reps, "mode_runs": args.mode_runs,
            "stress_case": args.stress_case,
            "stress_runs": args.stress_runs}, args.timeout))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 1 if "device_channels_error" in out else 0


if __name__ == "__main__":
    sys.exit(main())
