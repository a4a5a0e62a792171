"""Loci as ``pintron_tpu_torch.batch`` runs them: one device service
owns the card (started by the benchmark's launcher,
``benchmark/harness/service.py``), and ``pintron_pipeline`` runs as the
service's client, with STEP 2 sharded over the traffic's
``est_workers`` fork workers that send their batches to the service (a
locus of at least 128 records; smaller ones run in one process).  With
the traffic's ``clients`` = 1 a lone locus runs in this process at a
time; with more (``CONCURRENT``), each locus in a spawned job of its
own (``harness/jobs.py``), every job a client of the one service, and
``est_workers`` stands for ``batch.py``'s cores // loci at once.  This
process never touches CUDA."""

from __future__ import annotations

import os
import subprocess
import sys
import time

LAUNCHER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "harness", "service.py")
READY_S = 300.0
CONCURRENT = True


class Deployment:
    def __init__(self, traffic: dict, device: str, root: str,
                 fault: str = None):
        self.workers = traffic["est_workers"]
        self.device = device
        self.sock = os.path.join(root, "svc.sock")
        self.ready = os.path.join(root, "svc.ready")
        self.fault = fault
        self.proc = None
        self.conn = None
        self._undo = None

    def start(self) -> None:
        from benchmark.harness import faults
        cmd = [sys.executable, LAUNCHER, "--socket", self.sock,
               "--device", self.device, "--ready-file", self.ready]
        if self.fault in faults.CLIENT_FAULTS:
            self._undo = faults.plant_client(self.fault)
        elif self.fault:
            cmd += ["--fault", self.fault]
        self.proc = subprocess.Popen(cmd)
        t0 = time.monotonic()
        while not (os.path.exists(self.ready) and os.path.exists(self.sock)):
            if self.proc.poll() is not None:
                raise RuntimeError("device service exited with "
                                   f"{self.proc.returncode}")
            if time.monotonic() - t0 > READY_S:
                self.stop()
                raise RuntimeError(f"device service not ready in {READY_S} s")
            time.sleep(0.02)
        os.environ["PINTRON_TORCH_SERVICE"] = self.sock
        os.environ["PINTRON_EST_WORKERS"] = str(self.workers)
        from multiprocessing.connection import Client
        from pintron_tpu_torch.ops.offload import AUTHKEY
        self.conn = Client(self.sock, family="AF_UNIX", authkey=AUTHKEY)

    def _ctl(self, what: str):
        self.conn.send(("bench_ctl", {"what": what}))
        status, res = self.conn.recv()
        if status != "ok":
            raise RuntimeError(f"device service: {res}")
        return res

    def trace_start(self):
        self._ctl("trace_start")

    def trace_stop(self) -> dict:
        return self._ctl("trace_stop")

    def report(self) -> dict:
        """The service's report (``harness/service.py``): the card's
        name and memory peak, the batches it evaluated, and
        ``forbidden``, the modules of ``runner.FORBIDDEN`` the service
        process holds."""
        return self._ctl("report")

    def stop(self) -> None:
        """Shut the service down and wait for it; kill it if it does not
        answer."""
        if self._undo:
            self._undo()
            self._undo = None
        if self.proc is None:
            return
        try:
            if self.conn is not None:
                self.conn.send(("shutdown", None))
                self.conn.poll(30)
        except OSError:
            pass
        finally:
            if self.conn is not None:
                self.conn.close()
            self.conn = None
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.proc = None
            os.environ.pop("PINTRON_TORCH_SERVICE", None)
            os.environ.pop("PINTRON_EST_WORKERS", None)


def make(config, traffic, device, root, fault=None):
    return Deployment(traffic, device, root, fault)
