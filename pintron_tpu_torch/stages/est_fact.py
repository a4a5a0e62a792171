"""est-fact (STEP 2) with every DP family on a torch device.

The port's counterpart of the device flow of
``pintron_tpu.stages.est_fact`` (``_run_units_device`` and the routing
of ``run_est_fact``), as the JAX package runs it with every family
forced on (``PINTRON_DEVICE_{NW,RB,GAP,KBAND}=1``).  Per round, the
native collect passes list the DP problems of the whole EST set, the
offload (``pintron_tpu_torch.ops.offload``) evaluates them in batches
(the CUDA kernels on a GPU, their plain PyTorch versions on the CPU),
and the results go where the C cascade reads them:

  * endpoint NW: ``eval_nw``, then the tag-1/2 memo
    (``epm_fill_endpoints``), before the noisy collect;
  * K-band: ``eval_kband``, then the noisy-exon memo
    (``epm_fill_noisy``);
  * refine-borders: per chunk, ``eval_rb``, then the tag-10 memo
    (``epm_fill_rb``);
  * gap alignment: per chunk, ``eval_gap``, then the window-keyed
    lookaside (``ri_lookaside_set``) around each cascade.

A problem the offload did not evaluate (an oversized one) is left out
of the fill, and the cascade computes it on the host.  Outputs are
byte-identical to the host path by construction.

With the device service set (``PINTRON_TORCH_SERVICE``), the batches go
to the service, and a large locus is sharded round-robin over fork
workers (``_run_units_device_forked``), as pintron_tpu's service mode
does: the host side of the flow runs on every core, and the service
merges the workers' batches.

Everything device-free (MEG construction, candidate enumeration, the
collect pass, the cascade, the writers) is imported from
``pintron_tpu.stages.est_fact``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

import pintron_tpu.stages.est_fact as _ref
from pintron_tpu.config import Config
from pintron_tpu.index.gst import SuffixTree
from pintron_tpu.io import multifasta as mf
from pintron_tpu.meg import graph as megmod
from pintron_tpu.native import dp_census, dp_census_reset, get_lib
from pintron_tpu.stages.est_fact import (TimeoutExpired, _collect_endpoints,
                                         _collect_gaps, _collect_introns,
                                         _collect_noisy,
                                         _native_cand_arrays,
                                         _own_meg_arrays, _unit_for_record,
                                         build_meg,
                                         internal_get_est_factorizations,
                                         write_intronic_edges, write_meg,
                                         write_multifasta_output)
from pintron_tpu_torch.ops import kband, offload

# host spans of the device flow's phases, read by measure_step2 from a
# torch.profiler trace (no cost when no profiler runs)
_span = torch.profiler.record_function

# smallest locus (records in ests.txt) that the service mode shards over
# fork workers: pintron_tpu's value (est_fact.py:2079-2092), not one
# measured for the port
FORK_MIN_RECORDS = 128

OUTPUT_NAMES = ("raw-multifasta-out.txt", "megs.txt",
                "processed-megs.txt", "processed-megs-info.txt",
                "processed-ests.txt", "meg-edges.txt")


# the native collect, fill and lookaside entries the device flow calls
NATIVE_ENTRIES = ("est_collect_noisy", "est_collect_endpoints",
                  "est_collect_gaps", "est_collect_introns", "epm_fill_noisy",
                  "epm_fill_endpoints", "epm_fill_rb", "ri_lookaside_set",
                  "ri_lookaside_clear")


def _native_lib():
    """The native library with the entries the device flow needs;
    raises when it is unavailable (the port never drops to another path
    on its own)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native library (pintron_tpu.native) is "
                           "unavailable")
    missing = [n for n in NATIVE_ENTRIES if not hasattr(lib, n)]
    if missing:
        raise RuntimeError(f"the native library lacks {missing}")
    if not _ref._native_gates():
        raise RuntimeError("the native est-fact paths are disabled "
                           "(PINTRON_NO_NATIVE_* or graph logging)")
    return lib


def _run_units_device(gen: mf.EstInfo, tree: SuffixTree,
                      gen_seq_bytes: bytes, config: Config,
                      ests_path: str, fresh: bool = False,
                      shard=(0, 1)):
    """Device flow over the units of ``ests_path`` that this process
    owns: with ``shard=(w, n)``, units w, w+n, w+2n, ... (the
    data-parallel EST axis of main-est-fact.c:249-291, split
    round-robin over the sharded flow's fork workers).

    Rounds mirror the sequential control flow: round 1 runs every
    unit's first EST, later rounds run the RC copies of units whose
    forward strand failed plus any timeout-ladder retries
    (compute-est-fact.c:192-293; main-est-fact.c:247-291).

    Returns [(unit index, six-blob tuple)] for the owned units, in file
    order."""
    lib = _native_lib()
    # the native memo fast-paths on the genomic and suffix-tree buffers'
    # addresses; holding them in the reference module keeps a freed
    # buffer from being recycled at the same address
    _ref._GEN_KEEPALIVE = gen_seq_bytes
    _ref._TEXT_KEEPALIVE = tree.text
    if fresh and hasattr(lib, "ep_memo_wipe"):
        lib.ep_memo_wipe()

    with open(ests_path) as fh:
        ests = mf.read_multifasta(fh)
    units = [_unit_for_record(gen, e) for e in ests]
    # per-unit output streams in OUTPUT_NAMES order:
    # (raw, megs, processed-megs, megs-info, processed-ests, intronic)
    bufs = [tuple(io.StringIO() for _ in range(6)) for _ in units]

    attempts = [{"unit": i, "est_idx": 0, "inc": 0,
                 "prev_tp": 0, "prev_te": 0}
                for i in range(shard[0], len(units), shard[1])]
    while attempts:
        round_recs = []
        problems = []        # deduped global device batch
        prob_index = {}      # (seq_id, coords) -> index into problems
        next_attempts = []

        with _span("pintron_step2_meg_enum"):
            for att in attempts:
                est = units[att["unit"]][att["est_idx"]]
                t_meg0 = time.monotonic()
                while True:
                    V, att["inc"], meg_arrays = build_meg(
                        est, tree, gen_seq_bytes, config, att["inc"])
                    tp, te = megmod.meg_stats(V)
                    same = (att["prev_tp"] > 2 and att["prev_te"] > 0
                            and (att["prev_tp"] <= tp
                                 or att["prev_te"] <= te))
                    if not same:
                        break
                    att["inc"] += 1
                att["prev_tp"], att["prev_te"] = tp, te
                meg_time = time.monotonic() - t_meg0
                if meg_arrays is not None:
                    meg_arrays = _own_meg_arrays(meg_arrays)
                    V = megmod.MegFlat(meg_arrays)

                rec = {"att": att, "est": est, "V": V,
                       "meg_arrays": meg_arrays, "cands": None,
                       "probmap": None, "meg_time": meg_time,
                       "deadline": None}
                if meg_arrays is not None:
                    deadline = None
                    t_enum0 = time.monotonic()
                    if config.max_single_factorization_time:
                        deadline = (t_enum0
                                    + config.max_single_factorization_time)
                    rec["deadline"] = deadline
                    try:
                        cands = _native_cand_arrays(
                            meg_arrays, config, gen_seq_bytes, deadline)
                    except TimeoutExpired:
                        # enumeration timeout, no facts: bump seed length and
                        # retry next round (compute-est-fact.c:241-286)
                        att["inc"] += 1
                        next_attempts.append(att)
                        continue
                    # charge this EST only its own enumeration time: the
                    # cascade runs after every other record's enumeration
                    # and the global device batch, so the per-EST budget is
                    # re-based just before the cascade
                    rec["enum_elapsed"] = time.monotonic() - t_enum0
                    if cands is not None:
                        rec["cands"] = cands
                        rec["est_bytes"] = est.seq.encode("latin1")
                        rec["est_orig_bytes"] = est.original_seq.encode(
                            "latin1")
                round_recs.append(rec)

        _offload_endpoints(lib, round_recs, gen_seq_bytes)

        # Noisy-exon collect (it memo-hits the endpoints filled above):
        # every K-band check of the round goes to the device batch.
        with _span("pintron_step2_collect_noisy"):
            for rec in round_recs:
                if rec["cands"] is not None:
                    col = _collect_noisy(
                        lib, rec["cands"], gen_seq_bytes,
                        rec["est_bytes"], rec["est_orig_bytes"],
                        int(rec["meg_arrays"][7]) - 2, config)
                    if col is not None:
                        coords, probs, seq_id = col
                        idxs = []
                        for c, p in zip(coords, probs):
                            key = (seq_id, int(c[0]), int(c[1]),
                                   int(c[2]), int(c[3]))
                            j = prob_index.get(key)
                            if j is None:
                                j = len(problems)
                                prob_index[key] = j
                                problems.append(p)
                            idxs.append(j)
                        rec["probmap"] = (coords, idxs)
                rec["prob_end"] = len(problems)

        # Device evaluation of the round's K-band problems, chunked and
        # pipelined: chunk i+1's batch runs on the executor thread while
        # chunk i's cascades run here (small rounds stay one batch).
        # Problem indices are assigned in record order, so a record only
        # references problems evaluated by its own or an earlier chunk.
        # A chunk that timed out (wedged device) leaves its slice
        # invalid; those records skip the memo pre-fill and the native
        # cascade recomputes on host (byte-identical).  A chunk that
        # failed raises.
        ok_global = np.zeros(len(problems), dtype=np.int64)
        ok_valid = np.zeros(len(problems), dtype=bool)

        def fill_kband(rec):
            if rec["probmap"] is not None and rec["probmap"][1]:
                coords, idxs = rec["probmap"]
                ivec = np.asarray(idxs, dtype=np.int64)
                if bool(ok_valid[ivec].all()):
                    okvec = np.ascontiguousarray(ok_global[ivec])
                    lib.epm_fill_noisy(
                        gen_seq_bytes, len(gen_seq_bytes),
                        rec["est_bytes"], len(rec["est_bytes"]),
                        rec["est_orig_bytes"],
                        len(rec["est_orig_bytes"]),
                        coords.ctypes.data, okvec.ctypes.data,
                        len(idxs))

        @_span("pintron_step2_cascade")
        def run_cascade(rec):
            att = rec["att"]
            est = rec["est"]

            t_fact0 = time.monotonic()
            deadline = rec.get("deadline")
            if deadline is not None:
                # re-base: wall time spent on OTHER records' work between
                # this EST's enumeration and its cascade must not count
                # against its per-EST budget
                deadline = (t_fact0
                            + config.max_single_factorization_time
                            - rec.get("enum_elapsed", 0.0))
            la = rec.get("ri_look")
            if la is not None:
                recsc, arena_np, smc, opsc, nc, stride = la
                lib.ri_lookaside_set(
                    recsc.ctypes.data, len(recsc), arena_np.ctypes.data,
                    smc.ctypes.data, opsc.ctypes.data, nc.ctypes.data,
                    stride)
            try:
                factorized, timeout = internal_get_est_factorizations(
                    gen, est, config, rec["V"],
                    meg_arrays=rec["meg_arrays"],
                    gen_seq_bytes=gen_seq_bytes,
                    cands=rec["cands"], deadline=deadline)
            finally:
                if la is not None:
                    lib.ri_lookaside_clear()
            fact_time = time.monotonic() - t_fact0

            raw, megs, pmegs, tmeg, pests, intronic = bufs[att["unit"]]
            has_facts = (factorized is not None
                         and factorized.factorizations)
            if not timeout or has_facts:
                megs.write("\n\n***********\n\n")
                megs.write(f">{est.est_id}\n")
                megs.write(f"{est.original_seq}\n")
                write_meg(megs, rec["V"])
            if has_facts:
                intronic.write(f">{est.est_id}\n")
                write_intronic_edges(intronic, rec["V"])
                pmegs.write(f">{est.est_id}\n")
                pmegs.write(f"{est.original_seq}\n")
                write_meg(pmegs, rec["V"])
                tmeg.write(f"{int(rec['meg_time'] * 1e6)} "
                           f"{int(fact_time * 1e6)} "
                           f"{len(factorized.factorizations)}\n")
                write_multifasta_output(gen, factorized, raw,
                                        config.retain_externals)
                pests.write(f">{est.est_id}\n{est.original_seq}\n")
                return  # unit resolved (RC copy skipped)
            if timeout:
                att["inc"] += 1
                next_attempts.append(att)
                return
            # resolved with no factorizations: try the RC copy
            if att["est_idx"] == 0 and len(units[att["unit"]]) > 1:
                next_attempts.append(
                    {"unit": att["unit"], "est_idx": 1, "inc": 0,
                     "prev_tp": 0, "prev_te": 0})

        # two chunks suffice for the cross-chunk pipeline (chunk i+1's
        # device batch runs while chunk i's cascades run)
        n_chunks = (1 if len(round_recs) <= 256
                    else min(2, max(1, len(round_recs) // 128)))
        step = max(1, (len(round_recs) + n_chunks - 1) // n_chunks)
        bounds = [(round_recs[c0:c0 + step],
                   round_recs[min(c0 + step, len(round_recs)) - 1]
                   ["prob_end"])
                  for c0 in range(0, len(round_recs), step)]

        import concurrent.futures as _futmod
        pool = (_futmod.ThreadPoolExecutor(max_workers=1)
                if len(bounds) > 1 else None)

        # Submit EVERY chunk's K-band batch up front: the single
        # executor thread evaluates them serially ahead of the cascades,
        # while this thread works through the host cascades (the native
        # calls release the GIL).
        try:
            launches = []
            prev_end = 0
            for recs_c, pend in bounds:
                lo, hi = prev_end, pend
                prev_end = pend
                if hi <= lo:
                    launches.append(None)
                elif pool is None:
                    launches.append(
                        ("done", offload.eval_kband(problems[lo:hi]),
                         lo, hi))
                else:
                    launches.append(
                        ("fut", pool.submit(offload.eval_kband,
                                            problems[lo:hi]), lo, hi))
            # Software pipeline: chunk i's gap batch is in flight on the
            # executor thread while chunk i-1's cascades run here (and
            # while chunk i+1's collect and rb work proceeds).
            staged = None   # (recs_c, pending gap batch) awaiting cascades
            for (recs_c, _pend), launch in zip(bounds, launches):
                if launch is not None:
                    kind, val, lo, hi = launch
                    res = val if kind == "done" else val.result()
                    if res is not None:
                        ok_global[lo:hi] = res
                        ok_valid[lo:hi] = True
                for rec in recs_c:
                    fill_kband(rec)
                _offload_rb(lib, recs_c, gen_seq_bytes, config)
                prep = _prep_introns(lib, recs_c, gen_seq_bytes, config,
                                     pool)
                if staged is not None:
                    _resolve_introns(staged[1])
                    for rec in staged[0]:
                        run_cascade(rec)
                staged = (recs_c, prep)
            if staged is not None:
                _resolve_introns(staged[1])
                for rec in staged[0]:
                    run_cascade(rec)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        attempts = next_attempts

    offload.tally(device_runs=1)
    return [(i, tuple(s.getvalue() for s in bufs[i]))
            for i in range(shard[0], len(units), shard[1])]


def _run_units_device_forked(gen: mf.EstInfo, tree: SuffixTree,
                             gen_seq_bytes: bytes, config: Config,
                             ests_path: str, fresh: bool, nworkers: int):
    """The device flow sharded over ``nworkers`` fork workers, which all
    send their batches to the one device service: the host side of the
    flow (MEG construction, collect passes, cascades) runs on as many
    cores, and the service merges the workers' batches.  The workers
    never create a CUDA context (nor does this process, which forks
    them).  Returns (per-record blobs in file order, the workers' host
    DP cells by family); the workers' offload counters are added to
    this process's.  A failed worker raises here, after every worker
    has ended: no other path stands in for it."""
    import multiprocessing

    ctx = multiprocessing.get_context("fork")

    def child_main(w, pw):
        # report only this worker's own work: the counters inherited
        # from the parent are not merged again
        offload.reset_stats()
        dp_census_reset()
        try:
            res = _run_units_device(gen, tree, gen_seq_bytes, config,
                                    ests_path, fresh=fresh,
                                    shard=(w, nworkers))
            pw.send(("ok", res, dict(offload.STATS), dp_census() or {}))
        except BaseException as e:  # noqa: BLE001 - reported to the parent
            pw.send(("err", f"{type(e).__name__}: {e}", None, None))
        finally:
            pw.close()

    workers = []
    for w in range(nworkers):
        pr, pw = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=child_main, args=(w, pw))
        proc.start()
        pw.close()
        workers.append((pr, proc))

    merged, census, errors = {}, {}, []
    for w, (pr, proc) in enumerate(workers):
        try:
            status, payload, stats, cells = pr.recv()
        except (EOFError, OSError) as e:
            status, payload = "err", f"no reply ({type(e).__name__})"
        pr.close()
        proc.join()
        if status != "ok":
            errors.append(f"worker {w} (exit {proc.exitcode}): {payload}")
            continue
        merged.update(payload)
        offload.tally(**{k: v for k, v in stats.items()
                         if k != "device_runs"})
        for k, v in cells.items():
            census[k] = census.get(k, 0) + v
    if errors:
        raise RuntimeError("sharded STEP 2 device flow failed: "
                           + "; ".join(errors))
    offload.tally(device_runs=1)
    return [merged[i] for i in sorted(merged)], census


@_span("pintron_step2_nw_phase")
def _offload_endpoints(lib, round_recs, gen_seq_bytes: bytes) -> None:
    """Endpoint-NW phase of a round: collect the head/tail alignment
    problems from the candidate arrays, evaluate them in one device
    batch with the traceback, and pre-fill the tag-1/2 memo with the
    evaluated ones, so the noisy collect pass memo-hits them."""
    per_rec = []
    problems = []
    for rec in round_recs:
        if rec["cands"] is None or rec["meg_arrays"] is None:
            continue
        recs = _collect_endpoints(
            lib, rec["cands"], gen_seq_bytes, rec["est_bytes"],
            rec["est_orig_bytes"], int(rec["meg_arrays"][7]) - 2)
        if recs is None or not len(recs):
            continue
        base = len(problems)
        eb = rec["est_bytes"]
        for r in recs:
            problems.append(
                (eb[int(r[5]):int(r[5]) + int(r[6])],
                 gen_seq_bytes[int(r[7]):int(r[7]) + int(r[8])]))
        per_rec.append((rec, recs, base))
    if not problems:
        return
    res = offload.eval_nw(problems)
    if res is None:
        return
    ops, nsteps, evaluated = res
    stride = ops.shape[1]
    for rec, recs, base in per_rec:
        keep = np.flatnonzero(evaluated[base:base + len(recs)])
        if not len(keep):
            continue
        recsc = np.ascontiguousarray(recs[keep])
        ops_c = np.ascontiguousarray(ops[base + keep])
        n_c = np.ascontiguousarray(nsteps[base + keep], dtype=np.int64)
        lib.epm_fill_endpoints(
            gen_seq_bytes, len(gen_seq_bytes),
            rec["est_bytes"], len(rec["est_bytes"]),
            rec["est_orig_bytes"], len(rec["est_orig_bytes"]),
            recsc.ctypes.data, len(keep), ops_c.ctypes.data,
            n_c.ctypes.data, stride)


@_span("pintron_step2_rb_phase")
def _offload_rb(lib, recs_c, gen_seq_bytes: bytes, config: Config) -> None:
    """Refine-borders phase of a chunk: collect FILTER 4's gap problems
    (a cascade replay on the warm K-band memo), evaluate both DP passes'
    row tables in one device batch, and pre-fill the tag-10 memo for
    the records whose two passes were both evaluated (the native cut
    selection runs in ``epm_fill_rb``)."""
    per_rec = []
    problems = []
    for rec in recs_c:
        if rec["cands"] is None or rec["meg_arrays"] is None:
            continue
        recs = _collect_gaps(lib, rec["meg_arrays"], rec["cands"],
                             gen_seq_bytes, rec["est_bytes"],
                             rec["est_orig_bytes"], config)
        if recs is None or not len(recs):
            continue
        base = len(problems)
        eb = rec["est_bytes"]
        for r in recs:
            pp = eb[int(r[4]):int(r[4]) + int(r[5])]
            tt = gen_seq_bytes[int(r[6]):int(r[6]) + int(r[7])]
            tw = min(int(r[5]) + int(r[8]), int(r[7]))
            problems.append((tt[:tw], pp))                # forward pass
            problems.append((tt[::-1][:tw], pp[::-1]))    # reversed pass
        per_rec.append((rec, recs, base))
    if not problems:
        return
    res = offload.eval_rb(problems)
    if res is None:
        return
    vals, pos, evaluated = res
    stride = vals.shape[1]
    for rec, recs, base in per_rec:
        fwd = base + 2 * np.arange(len(recs))
        keep = np.flatnonzero(evaluated[fwd] & evaluated[fwd + 1])
        if not len(keep):
            continue
        fwd, bwd = fwd[keep], fwd[keep] + 1
        tables = [np.ascontiguousarray(a[ix])
                  for ix in (fwd, bwd) for a in (vals, pos)]
        recsc = np.ascontiguousarray(recs[keep])
        lib.epm_fill_rb(
            gen_seq_bytes, len(gen_seq_bytes),
            rec["est_bytes"], len(rec["est_bytes"]),
            rec["est_orig_bytes"], len(rec["est_orig_bytes"]),
            recsc.ctypes.data, len(keep),
            *(t.ctypes.data for t in tables), stride)


@_span("pintron_step2_gap_collect")
def _prep_introns(lib, recs_c, gen_seq_bytes: bytes, config: Config,
                  pool):
    """Gap-alignment phase of a chunk, part 1: collect every speculative
    gap problem of the chunk's refine-intron chains
    (``est_collect_introns``) and submit one device batch, on the
    executor when there is one.  Returns (per_rec, pending batch), or
    None when the chunk has no gap problem."""
    per_rec = []
    problems = []
    for rec in recs_c:
        if rec["cands"] is None or rec["meg_arrays"] is None:
            continue
        col = _collect_introns(lib, rec["meg_arrays"], rec["cands"],
                               gen_seq_bytes, rec["est_bytes"],
                               rec["est_orig_bytes"], config)
        if col is None or not len(col[0]):
            continue
        recs, arena = col
        base = len(problems)
        for r in recs:
            eo, nn, go, mm = (int(x) for x in r[9:13])
            problems.append((arena[eo:eo + nn], arena[go:go + mm]))
        per_rec.append((rec, recs, arena, base))
    if not problems:
        return None
    if pool is None:
        return per_rec, ("done", offload.eval_gap(problems))
    return per_rec, ("fut", pool.submit(offload.eval_gap, problems))


@_span("pintron_step2_gap_wait")
def _resolve_introns(prep) -> None:
    """Part 2: wait for the chunk's gap batch and attach to each record
    its evaluated windows' results, which ``run_cascade`` installs in
    the lookaside around the record's cascade.  A window left out
    misses the lookaside and the cascade computes it on the host."""
    if prep is None:
        return
    per_rec, (kind, val) = prep
    res = val if kind == "done" else val.result()
    if res is None:
        return
    sm, ops, nsteps, evaluated = res
    stride = ops.shape[1]
    for rec, recs, arena, base in per_rec:
        keep = np.flatnonzero(evaluated[base:base + len(recs)])
        if not len(keep):
            continue
        rec["ri_look"] = (
            np.ascontiguousarray(recs[keep]),
            np.frombuffer(arena, dtype=np.uint8),
            np.ascontiguousarray(sm[base + keep], dtype=np.int64),
            np.ascontiguousarray(ops[base + keep]),
            np.ascontiguousarray(nsteps[base + keep], dtype=np.int64),
            stride)


def run_est_fact(workdir: str = ".", config: Optional[Config] = None,
                 log=lambda *a: None, device=None) -> None:
    """The est-fact stage entry point (main-est-fact.c:90-339).

    ``device=None`` runs pintron_tpu's host path (the fork pool).  With
    a device (``"cuda"``, ``"cuda:N"`` or ``"cpu"``) every DP family's
    batches run there; ``"cuda"`` raises when no CUDA device is
    available.  With the device service set (``PINTRON_TORCH_SERVICE``)
    the batches go to the service, and a locus of at least
    ``FORK_MIN_RECORDS`` records is sharded over ``PINTRON_EST_WORKERS``
    fork workers (default: one per core), as pintron_tpu's service mode
    does (est_fact.py:2079-2092)."""
    if os.environ.get("PINTRON_DEVICE"):
        raise RuntimeError(
            "PINTRON_DEVICE is set: pintron_tpu would run its JAX device "
            "flow.  Unset it; the port selects its device with the "
            "`device` argument")
    if device is None:
        _ref.run_est_fact(workdir, config=config, log=log)
        return
    device = offload.use_device(device)
    _native_lib()

    sys.setrecursionlimit(1_000_000)
    from pintron_tpu.runtime import (TimerRegistry, log_info_extended,
                                     resource_usage_log)
    from pintron_tpu.utils import write_text
    timers = TimerRegistry()
    info_log = os.path.join(workdir, f"info-pid-{os.getpid()}.log")

    def checkpoint(desc: str) -> None:
        # event+memory checkpoints at the reference's milestones
        # (main-est-fact.c:115,181,221,233,243,290 -> util.c:221-268)
        try:
            log_info_extended(desc, info_log)
        except OSError:
            pass

    def wpath(name):
        return os.path.join(workdir, name)

    checkpoint("started")
    if config is None:
        ini = wpath("config.ini")
        config = Config.from_ini(ini) if os.path.exists(ini) else Config()
        config.validate()
    config.dump_ini(wpath("config-dump.ini"))

    timers["io"].start()
    with open(wpath("genomic.txt")) as fh:
        gen_list = mf.read_multifasta(fh)
    if len(gen_list) != 1:
        raise ValueError(f"genomic.txt holds {len(gen_list)} records, "
                         "expected 1")
    gen = gen_list[0]
    mf.parse_genomic_header(gen)
    mf.ntails_removal(gen)
    timers["io"].stop()
    checkpoint("ests-read-and-preprocessed")
    gen_seq_bytes = gen.seq.encode("latin1")

    checkpoint("alignment-begin")
    dp_census_reset()
    cells0 = offload.STATS["device_cells"]
    timers["algorithm"].start()
    # fresh-locus benchmark mode: wipe the persistent result memo
    fresh = bool(os.environ.get("PINTRON_FRESH_MEMO"))
    nworkers = (int(os.environ.get("PINTRON_EST_WORKERS", "0"))
                or (os.cpu_count() or 1))
    with open(wpath("ests.txt")) as fh:
        n_records = sum(1 for line in fh if line.startswith(">"))
    tree = SuffixTree(gen_seq_bytes)
    sharded = (offload.service_socket() is not None and nworkers > 1
               and n_records >= FORK_MIN_RECORDS)
    if sharded:
        # host cascade on every core, device batches merged on the
        # service; small loci skip the forks, whose fixed cost (fork,
        # pipes, result pickling) exceeds the work they would share
        results, host_cells = _run_units_device_forked(
            gen, tree, gen_seq_bytes, config, wpath("ests.txt"), fresh,
            nworkers)
    else:
        results = [blobs for _i, blobs in _run_units_device(
            gen, tree, gen_seq_bytes, config, wpath("ests.txt"),
            fresh=fresh)]
        host_cells = dp_census() or {}
    timers["algorithm"].stop()
    checkpoint("alignment-end")
    dev_cells = offload.STATS["device_cells"] - cells0
    total = dev_cells + sum(host_cells.values())
    logging.getLogger("pintron").info(
        "est-fact device flow: %s", json.dumps(
            {"device": str(offload.service_device() or device),
             "service": offload.service_socket(),
             "workers": nworkers if sharded else 1,
             "stats": offload.STATS, "launches": kband.LAUNCHES,
             "host_dp_cells": host_cells,
             "device_cell_share": dev_cells / total if total else 0.0},
            sort_keys=True))

    timers["io"].start()
    for k, name in enumerate(OUTPUT_NAMES):
        write_text(wpath(name), "".join(r[k] for r in results))
    timers["io"].stop()
    checkpoint("output-written")
    timers.log_all()
    resource_usage_log(level=logging.DEBUG)
