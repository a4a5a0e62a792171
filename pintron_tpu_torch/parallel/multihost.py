"""STEP 2 (est-fact) over several OS processes joined by torch.distributed.

The port's counterpart of the JAX package's ``parallel/multihost.py``.
``run_est_fact_multiprocess(workdir, nprocs, device)`` runs est-fact as
``nprocs`` spawned processes, the ranks, with the three parts a
multi-host run needs:

* **disjoint sharding**: rank r owns EST units r, r+N, r+2N, ... (the
  per-EST independence axis, main-est-fact.c:249-291) and runs the
  device flow over them.  Its batches go to one device service on
  ``device`` that the parent starts (``batch.start_service``): the
  service is the one owner of the card, and no rank creates a CUDA
  context.
* **a collective carrying real data**: after its shard, every rank
  joins a gloo process group (a ``FileStore`` in the run's directory,
  so no port is needed), all-reduces its shard's problem counts, and
  all-gathers its shard's candidate intron set, which every rank merges
  by a sorted dedup.  The operands are host data (counts, and intron
  sets derived from host text), so the group runs on CPU tensors, on
  the CPU machine and on the card's alike.
* **a deterministic merge**: the parent checks that the ranks agree on
  the reduced counts and on the merged set's digest, and that the digest
  equals the one derived from the merged artifacts; then it writes the
  six stage-2 artifacts in unit order, byte-identical to the
  one-process run for any N.

With ``collective=False`` the ranks run the native host path, with no
service and no group.

The ranks attach one suffix-tree index (``SuffixTree.load``) that the
parent writes into the run's own temporary directory while the ranks
start, and removes with it; a rank waits for its ``.ready`` file and
refuses an index whose ``.ready`` names another layout than
``INDEX_FORMAT``.  No cache outlives a run, so no run, of this package
or of the JAX one, attaches an index another wrote.

Nothing falls back: a service that does not start raises, and a rank
that fails, or has not finished when the run's timeout passes, fails
the run; the parent then kills every rank still running and stops the
service.  Each family of the device flow runs on the device, as in the
one-process flow.

CLI: python -m pintron_tpu_torch.parallel.multihost <workdir> [N]
         [--host] [--device cuda|cuda:N|cpu]
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pintron_tpu_torch.index import gst
from pintron_tpu_torch.ops import limits, offload
from pintron_tpu_torch.stages.est_fact import OUTPUT_NAMES

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _read_genomic(workdir: str):
    """The workdir's preprocessed genomic record and its bytes."""
    from pintron_tpu_torch.io import multifasta as mf
    with open(os.path.join(workdir, "genomic.txt")) as f:
        gen = mf.read_multifasta(f)[0]
    mf.parse_genomic_header(gen)
    mf.ntails_removal(gen)
    return gen, gen.seq.encode("latin1")


def _config(workdir: str):
    from pintron_tpu_torch.config import Config
    ini = os.path.join(workdir, "config.ini")
    config = Config.from_ini(ini) if os.path.exists(ini) else Config()
    config.validate()
    return config


def _write_index(gen_seq_bytes: bytes, prefix: str) -> None:
    """Build and save the index, then publish its ``.ready`` file
    (written aside and renamed, so a rank never reads half of it)."""
    gst.SuffixTree(gen_seq_bytes).save(prefix)
    tmp = f"{prefix}.ready.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(gst.INDEX_FORMAT + "\n")
    os.replace(tmp, prefix + ".ready")


def _wait_index(prefix: str, deadline: float) -> None:
    """Wait for the index's ``.ready`` file; raise at the deadline, or
    when it names another layout than this package's."""
    while not os.path.exists(prefix + ".ready"):
        if time.time() > deadline:
            raise RuntimeError(f"the index {prefix} was not ready before "
                               "the run's timeout")
        time.sleep(0.005)
    with open(prefix + ".ready") as f:
        layout = f.read().strip()
    if layout != gst.INDEX_FORMAT:
        raise RuntimeError(f"the index {prefix} has the layout {layout!r}, "
                           f"not {gst.INDEX_FORMAT!r}")


def _shard_blobs(workdir: str, shard, idx_prefix: str, device: str):
    """The device flow over one EST shard, its batches on ``device``
    (through the service when ``PINTRON_TORCH_SERVICE`` is set).
    Returns ([(unit index, six blobs)], offload.STATS)."""
    from pintron_tpu_torch.stages.est_fact import _run_units_device
    offload.use_device(device)
    gen, gen_seq_bytes = _read_genomic(workdir)
    blobs = _run_units_device(gen, gst.SuffixTree.load(idx_prefix),
                              gen_seq_bytes, _config(workdir),
                              os.path.join(workdir, "ests.txt"),
                              fresh=True, shard=shard)
    return blobs, dict(offload.STATS)


def _shard_blobs_host(workdir: str, shard, idx_prefix: str):
    """The native host path over one EST shard (byte-identical to the
    device flow): [(unit index, six blobs)]."""
    import pintron_tpu_torch.stages.est_fact as ef
    from pintron_tpu_torch.io import multifasta as mf
    gen, gen_seq_bytes = _read_genomic(workdir)
    tree = gst.SuffixTree.load(idx_prefix)
    with open(os.path.join(workdir, "ests.txt")) as fh:
        ests = mf.read_multifasta(fh)
    units = [ef._unit_for_record(gen, e) for e in ests]
    ef._WORKER_CTX = (gen, tree, gen_seq_bytes, _config(workdir))
    ef._GEN_KEEPALIVE = gen_seq_bytes
    ef._TEXT_KEEPALIVE = tree.text
    try:
        return [(i, ef._process_unit(u)) for i, u in enumerate(units)
                if i % shard[1] == shard[0]]
    finally:
        ef._WORKER_CTX = None


def _intron_candidates(blobs) -> np.ndarray:
    """Candidate intron set from raw-multifasta factor rows: adjacent
    factors of one factorization with a genomic gap define a candidate
    (gen_end+1, gen_start-1) intron, the registry seed that stage 4
    consumes (main-intron-agreement.c:172-287).  Returns a sorted,
    deduped (n, 2) int64 array."""
    cands = set()
    for _i, six in blobs:
        prev_ge = None
        for ln in six[0].splitlines():
            if ln.startswith(">"):
                prev_ge = None
                continue
            if not ln or not ln[0].isdigit():
                if ln.startswith("#"):
                    continue
                prev_ge = None
                continue
            parts = ln.split(" ", 4)
            if len(parts) < 4:
                continue
            gs, ge = int(parts[2]), int(parts[3])
            if prev_ge is not None and gs > prev_ge + 1:
                cands.add((prev_ge + 1, gs - 1))
            prev_ge = ge
    if not cands:
        return np.zeros((0, 2), dtype=np.int64)
    return np.array(sorted(cands), dtype=np.int64)


def _digest(cands: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        cands, dtype=np.int64).tobytes()).hexdigest()


def _collective(rank: int, nprocs: int, store: str, stats, blobs):
    """Join the gloo group, all-reduce the shard's [problems,
    device_problems], all-gather the candidate intron sets and merge
    them.  Returns (global counts, merged candidate count, digest)."""
    import torch.distributed as dist
    timeout = float(os.environ.get("PINTRON_DEVICE_TIMEOUT_S", "600"))
    kw = ({"timeout": datetime.timedelta(seconds=timeout)}
          if timeout > 0 else {})
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=nprocs, **kw)
    try:
        counts = torch.tensor([stats["problems"], stats["device_problems"]],
                              dtype=torch.int64)
        dist.all_reduce(counts)
        cand = torch.from_numpy(_intron_candidates(blobs))
        maxn = torch.tensor([len(cand)], dtype=torch.int64)
        dist.all_reduce(maxn, op=dist.ReduceOp.MAX)
        padded = torch.full((max(int(maxn), 1), 2), -1, dtype=torch.int64)
        padded[:len(cand)] = cand
        gathered = [torch.empty_like(padded) for _ in range(nprocs)]
        dist.all_gather(gathered, padded)
    finally:
        dist.destroy_process_group()
    flat = torch.cat(gathered).numpy()
    merged = np.unique(flat[flat[:, 0] >= 0], axis=0).reshape(-1, 2)
    return counts.tolist(), len(merged), _digest(merged)


def child_main(spec: dict) -> int:
    """One rank: its shard, then (collective mode) the group; writes its
    pickle to ``spec["out"]``."""
    t_boot = time.time() - spec["spawn_ts"]
    rank, nprocs = spec["rank"], spec["nprocs"]
    t0 = time.monotonic()
    _wait_index(spec["idx_prefix"], spec["deadline"])
    t_wait = time.monotonic() - t0
    t0 = time.monotonic()
    if spec["mode"] == "host":
        blobs = _shard_blobs_host(spec["workdir"], (rank, nprocs),
                                  spec["idx_prefix"])
    else:
        blobs, stats = _shard_blobs(spec["workdir"], (rank, nprocs),
                                    spec["idx_prefix"], spec["device"])
    timing = {"boot": round(t_boot, 3), "idx_wait": round(t_wait, 3),
              "shard": round(time.monotonic() - t0, 3)}
    rec = {"rank": rank, "blobs": blobs, "timing": timing}
    if spec["mode"] != "host":
        t0 = time.monotonic()
        counts, n_merged, digest = _collective(rank, nprocs, spec["store"],
                                               stats, blobs)
        timing["collective"] = round(time.monotonic() - t0, 3)
        rec.update(stats=stats, launches=dict(limits.LAUNCHES),
                   local_problems=stats["problems"], global_counts=counts,
                   local_candidates=len(_intron_candidates(blobs)),
                   merged_candidates=n_merged, merged_digest=digest)
    with open(spec["out"], "wb") as f:
        pickle.dump(rec, f)
    return 0


def run_est_fact_multiprocess(workdir: str, nprocs: int, device="cuda",
                              timeout: float = 900.0,
                              collective: bool = True) -> dict:
    """Run STEP 2 over ``workdir`` as ``nprocs`` ranks on disjoint EST
    shards, write the merged stage-2 artifacts there, and return a
    report: per rank its units, stats, counts and timing; the reduced
    counts every rank agreed on; the merged candidate count; and the
    service's shutdown report (its counters and kernel launches).
    ``device`` (``"cuda"``, the default, ``"cuda:N"`` or ``"cpu"``) is
    the service's; ``"cuda"`` raises without a card.  With
    ``collective=False`` the ranks run the native host path and
    ``device`` is not used.  Raises when a rank fails or the run
    passes ``timeout`` seconds."""
    from pintron_tpu_torch.batch import start_service, stop_service
    if collective:
        device = str(offload.check_card(device))
    _gen, gen_seq_bytes = _read_genomic(workdir)
    outdir = tempfile.mkdtemp(prefix="pintron-torch-mh-")
    idx_prefix = os.path.join(outdir, "index")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    deadline = time.time() + timeout
    service, procs = None, []
    try:
        if collective:
            service = start_service(device)
            env[offload.SERVICE_ENV] = service[1]
        outs = [os.path.join(outdir, f"rank{r}.pkl") for r in range(nprocs)]
        for r, out in enumerate(outs):
            spec = {"rank": r, "nprocs": nprocs, "workdir": workdir,
                    "out": out, "store": os.path.join(outdir, "store"),
                    "idx_prefix": idx_prefix, "device": device,
                    "mode": "collective" if collective else "host",
                    "deadline": deadline, "spawn_ts": time.time()}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pintron_tpu_torch.parallel.multihost",
                 "--child", json.dumps(spec)], env=env))
        # built while the ranks' interpreters start
        _write_index(gen_seq_bytes, idx_prefix)
        report = _wait_and_merge(procs, outs, workdir, deadline, nprocs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        svc_report = stop_service(*service) if service else None
        shutil.rmtree(outdir, ignore_errors=True)
    report.update(collective=collective, service=svc_report,
                  device=device if collective else "host")
    return report


def _wait_and_merge(procs, outs, workdir: str, deadline: float,
                    nprocs: int) -> dict:
    """Wait for every rank (raising on the first that fails, or at the
    deadline), check their agreement and write the merged artifacts."""
    running = set(range(len(procs)))
    while running:
        for r in sorted(running):
            rc = procs[r].poll()
            if rc is None:
                continue
            if rc != 0:
                raise RuntimeError(f"multihost rank {r} exited with {rc}")
            running.discard(r)
        if running and time.time() > deadline:
            raise RuntimeError(f"multihost ranks {sorted(running)} did not "
                               "finish before the run's timeout")
        time.sleep(0.02)

    merged = {}
    report = {"nprocs": nprocs, "ranks": []}
    counts_seen, digests_seen = set(), set()
    for out in outs:
        with open(out, "rb") as f:
            d = pickle.load(f)
        merged.update(d["blobs"])
        report["ranks"].append(
            {"rank": d["rank"], "units": len(d["blobs"]),
             "timing": d["timing"],
             **{k: d[k] for k in ("stats", "launches", "local_problems",
                                  "global_counts", "local_candidates")
                if k in d}})
        if "global_counts" in d:
            counts_seen.add(tuple(d["global_counts"]))
            digests_seen.add((d["merged_candidates"], d["merged_digest"]))
    ordered = [(i, merged[i]) for i in sorted(merged)]
    if counts_seen:
        # every rank reduced the same counts and merged the same set,
        # and that set is the one the merged artifacts give (the
        # one-process view)
        if len(counts_seen) != 1:
            raise AssertionError(f"ranks disagree on the all-reduced "
                                 f"counts: {counts_seen}")
        if len(digests_seen) != 1:
            raise AssertionError(f"ranks disagree on the merged candidate "
                                 f"introns: {digests_seen}")
        n_merged, digest = digests_seen.pop()
        ref = _intron_candidates(ordered)
        if (len(ref), _digest(ref)) != (n_merged, digest):
            raise AssertionError("collectively merged candidate introns "
                                 "differ from the one-process derivation")
        report["global_counts"] = list(counts_seen.pop())
        report["merged_candidate_introns"] = n_merged
        report["merged_digest"] = digest
    from pintron_tpu_torch.utils import write_text
    for k, name in enumerate(OUTPUT_NAMES):
        write_text(os.path.join(workdir, name),
                   "".join(b[k] for _i, b in ordered))
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        return child_main(json.loads(argv[1]))
    p = argparse.ArgumentParser(prog="pintron-tpu-torch-multihost",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("workdir")
    p.add_argument("nprocs", nargs="?", type=int, default=2)
    p.add_argument("--host", action="store_true",
                   help="the native host path in every rank, no group")
    p.add_argument("--device", default="cuda",
                   help="the device service's device (cuda, the default, "
                        "cuda:N or cpu)")
    a = p.parse_args(argv)
    report = run_est_fact_multiprocess(a.workdir, a.nprocs, device=a.device,
                                       collective=not a.host)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
