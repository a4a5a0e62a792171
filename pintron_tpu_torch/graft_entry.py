"""The port's entry point: the batched scoring step with an example
batch (counterpart of the JAX package's ``__graft_entry__.entry``).

    from pintron_tpu_torch.graft_entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    dist, scores, support = fn(*args)

``fn`` is ``parallel.mesh.alignment_step`` with its static arguments
bound at the JAX entry's sizes: a batch of 64 pairs, genomic windows of
256 codes, ``max_rows`` 192, ``k_max`` 16 (band width 33,
``kband_kernel``'s 2-cells-a-lane instance), 32 candidate introns and
the ``P5_GTAG_U2`` donor matrix.  ``example_args`` are its eight
tensors on ``device``.

``dryrun_multichip(n, device)`` runs the pipeline on real data over a
mesh of ``n`` shards and over two processes, on the AMBN golden case
(``tests/golden/test-AMBN.tar.gz``): STEP 2 with ``PINTRON_TORCH_MESH=n``
in this process (each K-band group sharded over ``parallel.mesh.
make_mesh(n)``; on one card every shard lies on ``cuda:0``), its five
artifacts byte for byte against the goldens; the pipeline resumed for
STEPs 3-8, its ``full.json`` and GTF byte for byte; then STEP 2 over two
processes (``parallel.multihost.run_est_fact_multiprocess``), byte for
byte, with the ranks' agreement.

    python -m pintron_tpu_torch.graft_entry [--device D]
    python -m pintron_tpu_torch.graft_entry --dryrun N [--device D]
"""

from __future__ import annotations

import functools
import os
import shutil
import tarfile
import tempfile
import time

import torch

from pintron_tpu_torch.parallel.mesh import (alignment_step, example_batch,
                                             to_device)
from pintron_tpu_torch.regression import STAGE2_ARTIFACTS, differing

BATCH = 64
N_MAX = 256
MAX_ROWS = 192
K_MAX = 16
N_INTRONS = 32


def entry(device="cuda"):
    """Returns (fn, example_args); ``device="cuda"`` raises without a
    card."""
    arrays, denom = example_batch(batch=BATCH, n_max=N_MAX, m_max=MAX_ROWS,
                                  k_max=K_MAX, n_introns=N_INTRONS)
    example_args = to_device(arrays, device)
    fn = functools.partial(alignment_step, n_introns=N_INTRONS,
                           max_rows=MAX_ROWS, k_max=K_MAX, denominator=denom)
    return fn, example_args


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL_FILES = ("full.json", "pintron-all-isoforms.gtf")


def _assert_same(gold: str, work: str, names, what: str) -> None:
    bad = differing(gold, work, names)
    if bad:
        raise AssertionError(f"{bad} differ from golden {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The AMBN pipeline over a mesh of ``n_devices`` shards on
    ``device`` and over two processes, byte for byte against the
    goldens; raises on any difference.  ``"cuda"`` raises without a
    card.  Returns a report: the mesh, STEP 2's wall over it, the
    K-band groups it sharded (``offload.STATS["mesh_batches"]``), its
    kernel launches and the two-process run's report."""
    from pintron_tpu_torch.ops import kband, offload
    from pintron_tpu_torch.parallel.multihost import \
        run_est_fact_multiprocess
    from pintron_tpu_torch.pipeline import pintron_pipeline
    from pintron_tpu_torch.stages.est_fact import run_est_fact

    device = offload.check_card(device)
    tmp = tempfile.mkdtemp(prefix="pintron-torch-dryrun-")
    gold, work, work2 = (os.path.join(tmp, d) for d in ("gold", "w", "mh"))
    old_env = {k: os.environ.get(k)
               for k in (offload.MESH_ENV, "PINTRON_FRESH_MEMO")}
    try:
        with tarfile.open(os.path.join(REPO, "tests", "golden",
                                       "test-AMBN.tar.gz")) as tf:
            tf.extractall(gold)
        for d in (work, work2):
            os.makedirs(d)
            for fn in ("genomic.txt", "ests.txt"):
                shutil.copy(os.path.join(gold, fn), d)

        os.environ[offload.MESH_ENV] = str(n_devices)
        os.environ["PINTRON_FRESH_MEMO"] = "1"
        before = dict(kband.LAUNCHES)
        sharded0 = offload.STATS["mesh_batches"]
        t0 = time.perf_counter()
        run_est_fact(work, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step2_s = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in kband.LAUNCHES.items()}
        mesh_batches = offload.STATS["mesh_batches"] - sharded0
        if n_devices > 1 and mesh_batches <= 0:
            raise AssertionError("no K-band group went over the mesh")
        if device.type == "cuda" and (
                launches["kband"] <= 0 or launches["kband"] % n_devices):
            raise AssertionError(
                f"kband_kernel launched {launches['kband']} times, not a "
                f"positive multiple of the {n_devices} shards")
        _assert_same(gold, work, STAGE2_ARTIFACTS,
                     f"on the {n_devices}-shard mesh")

        # resume from the mesh's STEP 2 artifacts: STEPs 3-8
        pintron_pipeline(workdir=work, output_filename="full.json",
                         gene="AMBN", organism="human", resume=True,
                         keep_intermediate=True, device=device)
        _assert_same(gold, work, FINAL_FILES,
                     f"after the {n_devices}-shard mesh pipeline")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        mp = run_est_fact_multiprocess(work2, 2, device=device)
        if len(mp["ranks"]) != 2 or any(
                r["global_counts"] != mp["global_counts"]
                for r in mp["ranks"]):
            raise AssertionError(f"the two ranks disagree: {mp['ranks']}")
        _assert_same(gold, work2, STAGE2_ARTIFACTS, "in the 2-process run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"mesh": n_devices, "device": str(device), "step2_s": step2_s,
            "mesh_batches": mesh_batches, "launches": launches,
            "multiprocess": mp}


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="run dryrun_multichip(N) instead of entry()")
    a = p.parse_args()
    if a.dryrun:
        print(json.dumps(dryrun_multichip(a.dryrun, a.device)))
        print(f"dryrun_multichip({a.dryrun}) ok")
    else:
        fn, args = entry(a.device)
        out = fn(*args)
        print("entry ok:", [tuple(o.shape) for o in out])
