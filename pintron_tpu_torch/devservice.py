"""The GPU-owning device service of the port: one process owns the
device and evaluates the DP batches of many client processes.

    python -m pintron_tpu_torch.devservice --socket S --device cuda|cpu \
        [--ready-file F]

The counterpart of ``pintron_tpu.devservice``.  A client is any process
of the port with ``PINTRON_TORCH_SERVICE=S`` in its environment: its
offload entries (``pintron_tpu_torch.ops.offload``) send each batch
here instead of running it, so the client never creates a CUDA
context and may fork (STEP 2's sharded flow, the batch driver's
workers).  The service serves six ops, ``kband``, ``edit``, ``pwm``,
``nw``, ``gap`` and ``rb``: the requests waiting when the service
takes one are merged per op into one batch (it waits for no more),
evaluated with the port's ``_eval_*_device`` on the service's device
(the CUDA kernels on a GPU, their plain versions on the CPU), and each
client gets its own slice back, the ``evaluated`` mask of the ``nw``,
``gap`` and ``rb`` entries included.  Every op is elementwise over
problems, so the results do not depend on how requests were merged.

``("hello", None)`` is answered with the service's device, which a
client checks against its own before it sends a batch.  An evaluation
that fails is answered with an error to every client of the merged
batch, and the client raises it: there is no host fallback (the JAX
package's clients fall back).  ``("shutdown", None)`` ends the service;
the reply carries its counters (``eval_s``: seconds spent evaluating,
per op) and the kernel launches.

Each merged evaluation is a ``pintron_service_eval`` span (attrs: op,
requests, problems) and each request of it a ``pintron_service_request``
span from its arrival to its reply (attrs: op, wait, the seconds from
its arrival to the evaluation's start, and eval, the evaluation's span
id), kept while the span recorder records (``runtime/timing.py``).
Started with ``PINTRON_TORCH_PROFILE=<dir>`` in its environment, the
service records from its start and writes its spans there at shutdown
(``spans-<pid>.jsonl``).
"""

from __future__ import annotations

import argparse
import os
import queue
import socket
import sys
import threading
import time
from multiprocessing.connection import Listener

import numpy as np
import torch

from pintron_tpu_torch.ops import limits, offload
from pintron_tpu_torch.runtime import timing

STATS = {"requests": 0, "merged_batches": 0, "errors": 0,
         "kband_problems": 0, "edit_problems": 0, "nw_problems": 0,
         "gap_problems": 0, "rb_problems": 0, "pwm_windows": 0,
         "eval_s": {}}


def _rows(r, i: int, c: int, width: int = None):
    """Rows i..i+c of every array of an entry's result tuple, the 2-d
    ones cut to ``width`` columns (the client's own stride)."""
    return tuple(a[i:i + c].copy() if a.ndim == 1 or width is None
                 else a[i:i + c, :width].copy() for a in r)


def _eval_group(op: str, payloads: list, device: torch.device) -> list:
    """Evaluate one op's merged payloads; returns the per-payload
    results, in order."""
    if op == "pwm":
        # merge the payloads that share a matrix
        groups = {}
        for idx, (rows, wpwm, den) in enumerate(payloads):
            key = (wpwm.tobytes(), float(den), rows.shape[1])
            groups.setdefault(key, []).append(idx)
        out = [None] * len(payloads)
        for idxs in groups.values():
            allrows = np.concatenate([payloads[k][0] for k in idxs])
            STATS["pwm_windows"] += allrows.shape[0]
            _r, wpwm, den = payloads[idxs[0]]
            scores = offload._pwm_scores_device(allrows, wpwm, den, device)
            i = 0
            for k in idxs:
                n = payloads[k][0].shape[0]
                out[k] = scores[i:i + n].copy()
                i += n
        return out
    entries = {"kband": offload._eval_kband_device,
               "edit": offload._eval_edit_batch_device,
               "nw": offload._eval_nw_device,
               "gap": offload._eval_gap_device,
               "rb": offload._eval_rb_device}
    if op not in entries:
        raise ValueError(f"unknown op {op!r}")
    merged = [p for payload in payloads for p in payload]
    STATS[f"{op}_problems"] += len(merged)
    res = entries[op](merged, device)
    out, i = [], 0
    for payload in payloads:
        c = len(payload)
        if op in ("kband", "edit"):
            out.append(res[i:i + c].copy())
        elif op == "rb":
            stride = max((len(p) for _t, p in payload), default=0) + 1
            out.append(_rows(res, i, c, stride))
        else:   # nw, gap: ops cut to the payload's own longest pair
            width = max((len(e) + len(g) for e, g in payload), default=1)
            out.append(_rows(res, i, c, width))
        i += c
    return out


def _conn_reader(conn, q) -> None:
    while True:
        try:
            req = conn.recv()
        except (EOFError, OSError):
            return
        q.put((conn, req, time.monotonic()))


def _reply(conn, msg) -> None:
    try:
        conn.send(msg)
    except OSError:
        pass   # the client went away; the others are still served


def listen(socket_path: str) -> Listener:
    """The service's socket.  Its queue of connections not yet accepted
    is as long as the system allows: the accept thread takes one client
    at a time through the authentication handshake, and under gVisor a
    client whose connect finds the queue full fails at once with EAGAIN
    (BlockingIOError), where Linux makes it wait.  With the default
    queue of one, a locus of a batch whose 8 jobs dialled together
    failed so."""
    return Listener(socket_path, family="AF_UNIX", backlog=socket.SOMAXCONN,
                    authkey=offload.AUTHKEY)


def serve(socket_path: str, device, ready_file: str = None) -> None:
    """Serve until a shutdown request arrives."""
    # never route to ourselves: the service evaluates on its own device
    # even when started from an environment that points clients here
    os.environ.pop(offload.SERVICE_ENV, None)
    device = offload.use_device(device)
    spans_dir = os.environ.get(timing.PROFILE_ENV)
    if spans_dir:
        timing.trace_on()
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    listener = listen(socket_path)
    q: "queue.Queue" = queue.Queue()
    stop = threading.Event()

    def accept_loop():
        while not stop.is_set():
            try:
                conn = listener.accept()
            except (OSError, EOFError):
                if stop.is_set():
                    return
                continue
            threading.Thread(target=_conn_reader, args=(conn, q),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    if ready_file:
        with open(ready_file, "w") as f:
            f.write("ready\n")

    while True:
        item = q.get()
        if item[1][0] == "shutdown":
            _reply(item[0], ("ok", {"stats": dict(STATS),
                                    "offload": dict(offload.STATS),
                                    "launches": dict(limits.LAUNCHES)}))
            break
        # merge the requests already waiting; waiting 1 or 4 ms for
        # more measured no faster on the H100 (PERF.md)
        batch = [item]
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item[1][0] == "shutdown":
                q.put(item)   # handled after this batch
                break
            batch.append(item)

        by_op = {}
        for c, (op, payload), arrived in batch:
            if op == "hello":
                _reply(c, ("ok", str(device)))
                continue
            STATS["requests"] += 1
            by_op.setdefault(op, []).append((c, payload, arrived))
        for op, items in by_op.items():
            STATS["merged_batches"] += 1
            payloads = [p for _c, p, _t in items]
            sp = timing.timed_span(
                "pintron_service_eval", op=op, requests=len(items),
                problems=sum(offload.problem_count(op, p)
                             for p in payloads))
            try:
                with sp:
                    results = _eval_group(op, payloads, device)
            except Exception as e:  # noqa: BLE001 - every client is told
                STATS["errors"] += 1
                results = [("err", f"{type(e).__name__}: {e}")] * len(items)
            else:
                results = [("ok", res) for res in results]
            finally:
                STATS["eval_s"][op] = (STATS["eval_s"].get(op, 0.0)
                                       + sp.end - sp.start)
            kept = timing.recording()
            for (c, _p, arrived), msg in zip(items, results):
                _reply(c, msg)
                if kept:
                    timing.record("pintron_service_request", arrived,
                                  time.monotonic(), op=op,
                                  wait=sp.start - arrived, eval=sp.id)

    stop.set()
    listener.close()
    if spans_dir:
        timing.write_spans(spans_dir, timing.trace_take())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pintron-torch-devservice",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--socket", required=True)
    p.add_argument("--device", required=True,
                   help="torch device the service owns (cuda, cuda:N, cpu)")
    p.add_argument("--ready-file", default=None)
    args = p.parse_args(argv)
    serve(args.socket, args.device, ready_file=args.ready_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
