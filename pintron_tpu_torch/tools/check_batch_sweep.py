"""The batch driver on every golden locus with inputs in one sweep,
each locus against a one-at-a-time pipeline run and the goldens.

    python -m pintron_tpu_torch.tools.check_batch_sweep \
        [--device cuda|cuda:N|cpu|host] [--jobs N] \
        [--solo-device host|cuda|cuda:N|cpu] [case ...]

The counterpart of the JAX package's ``tools/check_batch_sweep.py``.
All the loci go into one manifest, run by ``python -m
pintron_tpu_torch.batch --device D --jobs N -k``: with a torch device
(``cuda`` by default, raising without a card) that is one device
service, the card's only owner, serving every locus's STEP 2 and STEP 4
batches.  Each locus's ``pintron-full-output.json`` and
``pintron-all-isoforms.gtf`` must then equal, byte for byte, those of
``python -m pintron_tpu_torch.pipeline`` run on that locus alone, with
``--device host`` unless ``--solo-device`` says otherwise (the JAX
tool's solo runs were its host path too).  Each locus is also
classified against its golden by ``check_e2e.classify_case``, the host
run standing beside a stage-5 candidate, and must be of the solo run's
class.  ``sweep`` does the work and returns it as a dict.  The exit
code is 1 when a locus fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from pintron_tpu_torch.regression import differing
from pintron_tpu_torch.tools.check_e2e import (FINALS, classify_case,
                                               finals_match, gene_of,
                                               run_pipeline)
from pintron_tpu_torch.tools.check_stage2 import (INPUTS, REPO,
                                                  golden_cases, unpack)

OUTS = ("pintron-full-output.json", "pintron-all-isoforms.gtf")
BATCH_TIMEOUT_S = 3600


def sweep(cases, device="cuda", jobs: int = 0,
          solo_device="host") -> dict:
    """Run ``cases`` through one batch on ``device`` with ``jobs`` loci
    at once (0: the batch driver's default).  Returns {"device", "jobs",
    "seconds" (the batch's wall), "summary" (its last line: the
    service's counters and kernel launches under "service"), "cases":
    {case: {"ok", "differs" (batch != solo), "label", "bucket",
    "solo_bucket" (the solo run's class), "job_seconds",
    "solo_seconds"}}, "skipped", "ok"}.  A locus is ok when the batch's
    finals equal the solo run's and both are of one class, not diff.
    A failed sweep keeps its directory ("root"); a batch that fails
    raises."""
    root = tempfile.mkdtemp(prefix="batch-sweep-")
    loci, skipped = [], []
    for case in cases:
        gold = os.path.join(root, "gold", case)
        if not unpack(case, gold):
            skipped.append(case)
            continue
        loci.append((case, gold, os.path.join(root, "batch", case)))
    manifest = os.path.join(root, "jobs.tsv")
    with open(manifest, "w") as f:
        for case, gold, work in loci:
            f.write(f"{work}\t{gold}/genomic.txt\t{gold}/ests.txt\t"
                    f"{gene_of(case)}\thuman\n")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pintron_tpu_torch.batch", "--manifest",
         manifest, "--jobs", str(jobs), "--device", str(device), "-k",
         "--summary", os.path.join(root, "summary.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=BATCH_TIMEOUT_S)
    dt = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"batch --device {device}: rc {r.returncode} "
                           f"(kept {root})\n{r.stdout[-2000:]}"
                           f"{r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    job_s = {os.path.basename(j["workdir"]): j["seconds"]
             for j in map(json.loads, lines[:-1])}
    out = {}
    for case, gold, work in loci:
        solo = os.path.join(root, "solo", case)
        os.makedirs(solo)
        for fn in INPUTS:
            shutil.copy(os.path.join(gold, fn), solo)
        solo_s = run_pipeline(solo, gene_of(case), solo_device,
                              json_name=OUTS[0])
        bad = differing(work, solo, OUTS)
        # the classification reads the finals under the goldens' names
        for d in (work, solo):
            shutil.copy(os.path.join(d, OUTS[0]), os.path.join(d, FINALS[0]))
        host = solo if solo_device == "host" else None
        if host is None and not finals_match(work, gold):
            host = os.path.join(root, "host", case)
            os.makedirs(host)
            for fn in INPUTS:
                shutil.copy(os.path.join(gold, fn), host)
            run_pipeline(host, gene_of(case), "host")
        label, bucket = classify_case(work, gold, gene_of(case), host)
        _solo_label, solo_bucket = classify_case(solo, gold, gene_of(case),
                                                 host or solo)
        out[case] = {"ok": not bad and bucket == solo_bucket != "diff",
                     "differs": bad, "label": label, "bucket": bucket,
                     "solo_bucket": solo_bucket,
                     "job_seconds": job_s.get(case), "solo_seconds": solo_s}
    ok = all(c["ok"] for c in out.values())
    res = {"device": str(device), "jobs": jobs, "seconds": dt,
           "summary": summary, "cases": out, "skipped": skipped, "ok": ok}
    if ok:
        shutil.rmtree(root, ignore_errors=True)
    else:
        res["root"] = root
    return res


def case_line(case: str, c: dict) -> str:
    return (f"{'OK ' if c['ok'] else 'FAIL'} {case:14s} {c['label']:32s} "
            f"job {c['job_seconds']} s, solo {c['solo_seconds']:.1f} s"
            + (f"  batch != solo: {', '.join(c['differs'])}"
               if c["differs"] else ""))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cases", nargs="*",
                   help="golden cases (default: every test*.tar.gz)")
    p.add_argument("--device", default="cuda",
                   help="the batch's device: cuda (the default), cuda:N, "
                        "cpu or host")
    p.add_argument("--jobs", type=int, default=0,
                   help="loci at once (default: the batch driver's)")
    p.add_argument("--solo-device", default="host",
                   help="the one-at-a-time runs' device (default: host)")
    args = p.parse_args(argv)
    from pintron_tpu_torch.ops import offload
    for d in (args.device, args.solo_device):
        if not offload.is_host(d):
            offload.check_card(d)
    res = sweep(args.cases or golden_cases(), args.device, args.jobs,
                args.solo_device)
    for case in res["skipped"]:
        print(f"SKIP {case} (no inputs)")
    s = res["summary"]
    print(f"batch sweep --device {res['device']}: {s['jobs']} loci in "
          f"{res['seconds']:.1f} s ({s['ok']} ok); service "
          f"{json.dumps(s['service'])}", flush=True)
    for case, c in res["cases"].items():
        print(case_line(case, c), flush=True)
    if not res["ok"]:
        print(f"kept {res['root']}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
