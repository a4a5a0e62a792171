"""The port's whole pipeline on every golden locus with inputs, its
finals classified against the goldens.

    python -m pintron_tpu_torch.tools.check_e2e \
        [--device cuda|cuda:N|cpu|host] [case ...]

The counterpart of the JAX package's ``tools/check_e2e.py``.  Each case
runs ``python -m pintron_tpu_torch.pipeline --device D -k`` (``cuda`` by
default, raising without a card) with the gene label the golden run
used (``GENES``), and ``classify_case`` puts its finals (``full.json``
and ``pintron-all-isoforms.gtf``) in one bucket:

  * ``byte``: both equal the golden's byte for byte;
  * ``canonical``: equal up to the isoform and intron numbering
    (``regression.compare_outputs``);
  * ``stage5-class``: the run lies in the class of outputs that the
    reference's stage 5 can give, whose Perl iterates hashes in a random
    order, and its finals equal the port's own ``--device host`` run on
    the same input byte for byte.  The class is proven by
    ``regression.stage5_class_equal`` where the golden carries
    ``build-ests.txt`` ("verified"); where it carries only the stage-4
    artifacts, by those being byte-equal ("stage-4 input").  The JAX
    tool replays the reference's own binaries on the run's
    ``build-ests.txt`` instead; they are not part of the repository, so
    the port holds the device run to its host path;
  * ``diff``: anything else.

In every bucket the STEP 2 and STEP 4 artifacts the golden carries must
equal the run's byte for byte, and the GTF must carry the gene label.
The JAX tool's fallback to inputs outside the tarballs is not kept:
the cases are the tarballs that carry ``genomic.txt`` and
``ests.txt``.  The exit code is 1 when a case is ``diff``.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from pintron_tpu_torch.tools.check_stage2 import (INPUTS, REPO,
                                                  golden_cases, unpack)

# the gene label of each golden run (the others used the default AAMP)
GENES = {"test-AMBN": "AMBN", "test-TP53": "TP53"}
FINALS = ("full.json", "pintron-all-isoforms.gtf")
STEP4_ARTIFACTS = ("out-after-intron-agree.txt", "predicted-introns.txt")
PIPELINE_TIMEOUT_S = 1800


def gene_of(case: str) -> str:
    return GENES.get(case, "AAMP")


def run_pipeline(work: str, gene: str, device,
                 json_name: str = "full.json") -> float:
    """``python -m pintron_tpu_torch.pipeline`` on ``work``'s inputs,
    keeping the intermediate files; returns its wall seconds and raises
    when it fails."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pintron_tpu_torch.pipeline",
         "--device", str(device), "--workdir", work, "-g", "genomic.txt",
         "-s", "ests.txt", "-o", json_name,
         "-t", "pintron-all-isoforms.gtf", f"--gene={gene}",
         "--organism=human", "-k"],
        cwd=REPO, capture_output=True, text=True,
        timeout=PIPELINE_TIMEOUT_S)
    if r.returncode:
        raise RuntimeError(f"pipeline --device {device} on {work}: rc "
                           f"{r.returncode}\n{r.stderr[-2000:]}")
    return time.perf_counter() - t0


def finals_match(work: str, gold: str) -> bool:
    """True when the finals equal the golden's byte for byte or up to
    the numbering (no host run is needed to classify them)."""
    from pintron_tpu_torch.regression import compare_outputs
    res = compare_outputs(work, gold)
    return ((res["json_byte"] and res["gtf_byte"])
            or (res["json_canonical"] and res["gtf_canonical"]))


def classify_case(work: str, gold: str, gene: str, host_work=None):
    """Classify one run's outputs in ``work`` against the golden in
    ``gold``.  ``host_work`` holds the port's ``--device host`` finals
    on the same input; without it no run is ``stage5-class``.  Returns
    (label, bucket), bucket one of byte, canonical, stage5-class,
    diff."""
    from pintron_tpu_torch.regression import (STAGE2_ARTIFACTS,
                                              compare_outputs, differing,
                                              stage5_class_equal)
    carried = [n for n in STAGE2_ARTIFACTS + STEP4_ARTIFACTS
               if os.path.exists(os.path.join(gold, n))]
    missing = [n for n in carried
               if not os.path.exists(os.path.join(work, n))]
    bad = missing or differing(work, gold, carried)
    if bad:
        return f"DIFF (STEP 2/4 artifacts: {', '.join(bad)})", "diff"
    with open(os.path.join(work, FINALS[1])) as f:
        labels = set(re.findall(r'gene_id "([^"]*)"', f.read()))
    if labels - {gene}:
        return f"DIFF (gene labels {sorted(labels)}, want {gene})", "diff"
    res = compare_outputs(work, gold)
    if res["json_byte"] and res["gtf_byte"]:
        return "byte-identical", "byte"
    if res["json_canonical"] and res["gtf_canonical"]:
        return "canonical", "canonical"
    s5 = stage5_class_equal(work, gold)
    verified = s5["ok"]
    stage4 = bool(s5.get("no_golden_intermediates")) and s5["input_byte"]
    if not (verified or stage4):
        failed = [k for k, v in s5.items() if v is False and k != "ok"]
        return f"DIFF (stage 5: {', '.join(failed) or 'finals'})", "diff"
    if host_work is None:
        return "DIFF (stage-5 class, no --device host run)", "diff"
    bad = differing(work, host_work, FINALS)
    if bad:
        return (f"DIFF (stage-5 class, != the --device host run: "
                f"{', '.join(bad)})", "diff")
    proof = "verified" if verified else "stage-4 input"
    return f"stage5-class ({proof}, == host)", "stage5-class"


def check_case(case: str, device="cuda") -> dict:
    """The pipeline on one golden case on ``device``, classified.
    Returns {"case", "device", "label", "bucket" (or "skipped"),
    "seconds", "host_seconds" (None when no host run was needed)}."""
    root = tempfile.mkdtemp(prefix=f"e2e-{case}-")
    try:
        gold = os.path.join(root, "gold")
        if not unpack(case, gold):
            return {"case": case, "device": str(device),
                    "label": "no inputs", "bucket": "skipped"}

        def run(mode, name):
            work = os.path.join(root, name)
            os.makedirs(work)
            for fn in INPUTS:
                shutil.copy(os.path.join(gold, fn), work)
            return work, run_pipeline(work, gene_of(case), mode)

        work, dt = run(str(device), "run")
        # a stage-5 candidate is held to a host run in a process of its own
        host_work, host_dt = (None, None) if finals_match(work, gold) \
            else run("host", "host-run")
        label, bucket = classify_case(work, gold, gene_of(case), host_work)
        return {"case": case, "device": str(device), "label": label,
                "bucket": bucket, "seconds": dt, "host_seconds": host_dt}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cases", nargs="*",
                   help="golden cases (default: every test*.tar.gz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default), cuda:N, cpu (the plain "
                        "PyTorch ops) or host (the native host path)")
    args = p.parse_args(argv)
    from pintron_tpu_torch.ops import offload
    if not offload.is_host(args.device):
        offload.check_card(args.device)
    counts = dict.fromkeys(("byte", "canonical", "stage5-class", "diff",
                            "skipped"), 0)
    for case in args.cases or golden_cases():
        res = check_case(case, args.device)
        counts[res["bucket"]] += 1
        if res["bucket"] == "skipped":
            print(f"SKIP {case} (no inputs)", flush=True)
            continue
        host = (f" (host run {res['host_seconds']:.1f} s)"
                if res["host_seconds"] is not None else "")
        print(f"{case:14s} {res['label']:40s} {res['seconds']:6.1f} s{host}",
              flush=True)
    print(counts)
    return 1 if counts["diff"] else 0


if __name__ == "__main__":
    sys.exit(main())
