"""Multi-locus batch driver of the port (``python -m pintron_tpu_torch.batch``).

    python -m pintron_tpu_torch.batch --manifest M [--jobs N] \
        [--summary S] [--device cuda|cuda:N|cpu|host] [-k]

The counterpart of ``pintron_tpu.batch``, with the same manifest (a TSV
of ``workdir, genomic, ests, gene[, organism]``, relative paths against
the manifest's directory) and the same summary (one JSON line per job,
then the totals).  Each job, one spawned process per locus, runs the
port's ``pintron_pipeline``.  With a torch device (``--device cuda``,
the default, ``cuda:N`` or ``cpu``), the driver starts one device
service on that device (``pintron_tpu_torch.devservice``) and points
every worker at it (``PINTRON_TORCH_SERVICE``): the batches of STEPs 2
and 4 of every locus go to the one process that owns the device, and
no worker creates a CUDA context.  With ``--device host`` no service
starts and every locus runs the native host path, the JAX package's
default mode.  By default as many loci run at once as there are cores,
and each locus's STEP 2 shards over the cores left to it
(``PINTRON_EST_WORKERS`` = cores // loci at once): with at least as
many loci as cores that is one worker, so STEP 2 is not sharded.
``-k`` keeps each locus's intermediate files, as the pipeline's ``-k``
does, so that its STEP 2 and STEP 4 artifacts can be checked.  Each
job's line carries ``startup_s``, its process's start-up: from the
process's start to its locus's, the interval of the pipeline's
``pintron_startup`` span on the same clock (``runtime/timing.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time

from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.runtime import timing


def _run_job(job, device, keep_intermediate):
    """Worker entry: run one locus; never raise (report instead)."""
    workdir, genomic, ests, gene, organism = job
    t0 = time.time()
    try:
        os.makedirs(workdir, exist_ok=True)
        shutil.copyfile(genomic, os.path.join(workdir, "genomic.txt"))
        shutil.copyfile(ests, os.path.join(workdir, "ests.txt"))
        from pintron_tpu_torch.pipeline import pintron_pipeline
        pintron_pipeline(workdir=workdir, gene=gene, organism=organism,
                         keep_intermediate=keep_intermediate, device=device)
        with open(os.path.join(workdir, "pintron-full-output.json")) as f:
            d = json.load(f)
        return {"workdir": workdir, "gene": gene, "ok": True,
                "seconds": round(time.time() - t0, 2),
                "startup_s": _startup_s(),
                "isoforms": len(d.get("isoforms", {})),
                "introns": len(d.get("introns", {}))}
    except Exception as e:  # noqa: BLE001 - a job must not kill its peers
        return {"workdir": workdir, "gene": gene, "ok": False,
                "seconds": round(time.time() - t0, 2),
                "startup_s": _startup_s(),
                "error": f"{type(e).__name__}: {e}"}


def _startup_s():
    """This job's start-up in seconds, None before its locus opened."""
    s = timing.startup_seconds()
    return None if s is None else round(s, 3)


def _job_worker(q, job, device, keep_intermediate):
    """Module-level so that the spawn context can pickle it."""
    q.put(_run_job(job, device, keep_intermediate))


def read_manifest(path: str):
    """The manifest's jobs as (workdir, genomic, ests, gene, organism),
    relative paths resolved against the manifest's directory."""
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        return p if os.path.isabs(p) else os.path.join(base, p)

    jobs = []
    with open(path) as f:
        for ln, raw in enumerate(f, start=1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 4:
                raise ValueError(f"{path}:{ln}: need workdir, genomic, "
                                 f"ests, gene[, organism]")
            workdir = resolve(parts[0])
            genomic = resolve(parts[1])
            ests = resolve(parts[2])
            gene = parts[3]
            organism = parts[4] if len(parts) > 4 else "unknown"
            jobs.append((workdir, genomic, ests, gene, organism))
    return jobs


def start_service(device: str, timeout_s: float = 120.0):
    """Start the device service on ``device`` and wait for its socket.
    Returns (process, socket path); raises when it does not come up."""
    sock = os.path.join(tempfile.mkdtemp(prefix="pintron-torch-svc-"),
                        "dev.sock")
    ready = sock + ".ready"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pintron_tpu_torch.devservice",
         "--socket", sock, "--device", str(device), "--ready-file", ready])
    t0 = time.monotonic()
    while not (os.path.exists(ready) and os.path.exists(sock)):
        if proc.poll() is not None:
            raise RuntimeError(f"device service exited with {proc.returncode}")
        if time.monotonic() - t0 > timeout_s:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"device service not ready in {timeout_s} s")
        time.sleep(0.05)
    return proc, sock


def stop_service(proc, sock: str):
    """Ask the service to shut down and wait for it; returns its report
    (counters and kernel launches), or None when it had to be killed
    (a service stuck in a hung batch never reads the request)."""
    from multiprocessing.connection import Client
    report = None
    try:
        conn = Client(sock, family="AF_UNIX", authkey=offload.AUTHKEY)
        try:
            conn.send(("shutdown", None))
            if conn.poll(15):
                report = conn.recv()[1]
        finally:
            conn.close()
        proc.wait(timeout=15)
    except (OSError, EOFError, subprocess.TimeoutExpired):
        proc.kill()
        proc.wait()
    shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    return report


def run_jobs(jobs, n_jobs: int, device, keep_intermediate: bool):
    """Run the jobs, at most ``n_jobs`` at a time, each in a spawned
    worker; returns their reports in the order they finish."""
    import multiprocessing

    # hand-managed non-daemonic workers: each pipeline forks its own
    # guard children and EST workers, which daemonic workers may not
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    pending, running, results = list(jobs), {}, []
    while pending or running:
        while pending and len(running) < n_jobs:
            job = pending.pop(0)
            proc = ctx.Process(target=_job_worker,
                               args=(q, job, device, keep_intermediate))
            proc.start()
            running[job[0]] = (job, proc)
        try:
            res = q.get(timeout=10)
        except queue.Empty:
            # a worker that died without reporting (killed, crashed)
            for wd, (job, proc) in list(running.items()):
                if proc.exitcode is not None:
                    res = {"workdir": wd, "gene": job[3], "ok": False,
                           "error": f"worker died (exit {proc.exitcode})"}
                    results.append(res)
                    print(json.dumps(res), flush=True)
                    del running[wd]
            continue
        results.append(res)
        print(json.dumps(res), flush=True)
        _job, proc = running.pop(res["workdir"])
        proc.join()
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pintron-tpu-torch-batch",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--manifest", required=True,
                   help="TSV: workdir, genomic, ests, gene[, organism]")
    p.add_argument("--jobs", type=int, default=0,
                   help="concurrent loci (default: the CPU count)")
    p.add_argument("--summary", default="",
                   help="write one JSON line per job to this file")
    p.add_argument("--device", default="cuda",
                   help="where the batches of STEPs 2 and 4 run: the "
                        "torch device of the service (cuda, the default, "
                        "cuda:N or cpu), or host (no service, the native "
                        "host path)")
    p.add_argument("-k", "--keep-intermediate-files", dest="keep",
                   action="store_true",
                   help="keep each locus's intermediate files")
    args = p.parse_args(argv)
    if not offload.is_host(args.device):
        # cuda without a card raises here, before a service starts (the
        # service, which owns the card, would fail later and less plainly)
        offload.check_card(args.device)

    jobs = read_manifest(args.manifest)
    cpus = os.cpu_count() or 1
    n_jobs = min(args.jobs or cpus, max(1, len(jobs)))
    # each locus's STEP 2 shards over fork workers too: share the cores
    os.environ.setdefault("PINTRON_EST_WORKERS",
                          str(max(1, cpus // n_jobs)))
    t0 = time.time()
    report = None
    if offload.is_host(args.device):
        results = run_jobs(jobs, n_jobs, args.device, args.keep)
    else:
        proc, sock = start_service(args.device)
        os.environ[offload.SERVICE_ENV] = sock
        try:
            results = run_jobs(jobs, n_jobs, args.device, args.keep)
        finally:
            os.environ.pop(offload.SERVICE_ENV, None)
            report = stop_service(proc, sock)
    ok = sum(1 for r in results if r["ok"])
    summary = {"jobs": len(jobs), "ok": ok, "failed": len(jobs) - ok,
               "seconds": round(time.time() - t0, 2), "device": args.device,
               "service": report}
    print(json.dumps(summary), flush=True)
    if args.summary:
        with open(args.summary, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps(summary) + "\n")
    return 0 if ok == len(jobs) else 1


if __name__ == "__main__":
    sys.exit(main())
