"""The benchmark's launcher around the port's device service.

    python benchmark/harness/service.py --socket S --device D \
        --ready-file F [--fault answer|half]

Runs ``pintron_tpu_torch.devservice.serve`` as the batch driver starts
it, with one op of the benchmark's own beside the port's six:
``("bench_ctl", {"what": ...})``, answered from this process, which
owns the card:

  * ``trace_start`` / ``trace_stop``: the profiler and the program's
    span recorder (``runtime/timing.py``) over the window;
    ``trace_stop`` answers with the timeline (``trace.stop``) and, under
    ``spans``, the spans this process kept (those of the service's own
    ``bench_ctl`` requests left out);
  * ``report``: the card's name, the peak of its memory
    allocated in this process, (op, start, end) of every batch the
    service evaluated, on the monotonic clock, and ``forbidden``: the
    top-level names of ``runner.FORBIDDEN`` (``jax``, ``jaxlib``,
    ``flax``, ``pintron_tpu``) that this process's ``sys.modules``
    holds, compared whole.

``--fault`` (the benchmark's tests only) plants one of
``benchmark/harness/faults.py``'s faults where the service produces
the answers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--socket", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--ready-file", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path[0] = ROOT
    import torch
    from benchmark.harness import runner, trace
    from pintron_tpu_torch import devservice
    from pintron_tpu_torch.ops import offload
    from pintron_tpu_torch.runtime import timing

    if args.fault:
        from benchmark.harness import faults
        faults.plant(offload, args.fault)
    evals, state = [], {}
    orig = devservice._eval_group

    def control(payload):
        what = payload["what"]
        if what == "trace_start":
            state["trace"] = trace.start()
            timing.trace_on()
            return None
        if what == "trace_stop":
            timing.trace_off()
            spans = [s for s in timing.trace_take()
                     if s.attrs.get("op") != "bench_ctl"]
            return {**trace.stop(state.pop("trace")), "spans": spans}
        if what == "report":
            dev = torch.device(args.device)
            cuda = dev.type == "cuda"
            return {"kind": (torch.cuda.get_device_name(dev) if cuda
                             else "cpu"),
                    "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                          if cuda else 0),
                    "evals": list(evals),
                    "forbidden": runner.forbidden_modules(sys.modules)}
        raise ValueError(f"bench_ctl: unknown request {what!r}")

    def eval_group(op, payloads, device):
        if op == "bench_ctl":
            return [control(pl) for pl in payloads]
        t0 = time.monotonic()
        try:
            return orig(op, payloads, device)
        finally:
            evals.append((op, t0, time.monotonic()))

    devservice._eval_group = eval_group
    devservice.serve(args.socket, args.device, ready_file=args.ready_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
