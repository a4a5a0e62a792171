"""Stage 2: EST factorization (the aligner), with every DP family of
its device flow on a torch device.

Rebuild of est-fact (main-est-fact.c, compute-est-fact.c,
est-factorizations.c:126-594).  Produces `raw-multifasta-out.txt`,
`processed-ests.txt`, `megs.txt`, `processed-megs.txt`,
`processed-megs-info.txt` and `meg-edges.txt` with the reference's file
formats.

The port's copy of ``pintron_tpu.stages.est_fact``: the host code (MEG
construction, candidate enumeration, the native collect passes, the
cascade drivers, the fork pool of the host path, the writers) is that
module's, and the device flow is the port's own.  ``run_est_fact``
takes ``device``:

  * ``"cuda"`` (the default) or ``"cuda:N"``: the device flow, every DP
    family's batches on the card (raises when no CUDA device is
    available);
  * ``"cpu"``: the same flow with the plain PyTorch ops on the CPU;
  * ``"host"``: the native host path with no device batch (the fork
    pool), the JAX package's default mode.

Per round of the device flow, the native collect passes list the DP
problems of the whole EST set, the offload
(``pintron_tpu_torch.ops.offload``) evaluates them in batches (the CUDA
kernels on a GPU, their plain PyTorch versions on the CPU), and the
results go where the C cascade reads them:

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

Each family's switch, ``PINTRON_DEVICE_{KBAND,NW,GAP,RB}``, routes it
(``offload.family_routes``): unset or ``1`` on the card (the default),
``0`` on the host DP inside the cascade, ``auto`` under the self-tuner
(``offload.tuned_off`` / ``tune_report``); any other value raises.

With the device service set (``PINTRON_TORCH_SERVICE``), the batches go
to the service, and a large locus is sharded round-robin over fork
workers (``_run_units_device_forked``): the host side of the flow runs
on every core, and the service merges the workers' batches.
"""

from __future__ import annotations

import io
import json
import logging
import os
import sys
import time
from typing import List, Optional, TextIO, Tuple

import numpy as np

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.factorize import filters as flt
from pintron_tpu_torch.factorize.embeddings import (
    EmbeddingEnumerator, TimeoutExpired, get_factorizations_from_embeddings)
from pintron_tpu_torch.factorize.polya import (correct_composition_tail,
                                               detect_polya_signal)
from pintron_tpu_torch.factorize.refine_intron import refine_intron
from pintron_tpu_torch.factorize.refinement import (
    refine_est_factorizations, remove_duplicated_factorizations,
    remove_factorizations_with_very_small_exons)
from pintron_tpu_torch.factorize.types import Factor, Factorization
from pintron_tpu_torch.index.gst import SuffixTree
from pintron_tpu_torch.io import multifasta as mf
from pintron_tpu_torch.meg import graph as megmod
from pintron_tpu_torch.meg import simplify as simp
from pintron_tpu_torch.meg.graph import MEG
from pintron_tpu_torch.native import dp_census, dp_census_reset, get_lib
from pintron_tpu_torch.ops import limits, offload
from pintron_tpu_torch.runtime import timing


class FactorizedEst:
    def __init__(self, info: mf.EstInfo):
        self.info = info
        self.factorizations: List[Factorization] = []
        self.polya_signals: List[bool] = []
        self.polyadenil_signals: List[bool] = []
        self.refined = False  # True when the native path already ran the
        #                       full refinement pass (skip the host one)


# The native memo epoch (epm_begin in dp.c) fast-paths on the genomic
# buffer's (pointer, length); holding the previous gen bytes object here
# guarantees its buffer is never freed-and-recycled at the same address,
# so a pointer match always means "same content".  _TEXT_KEEPALIVE plays
# the same role for the suffix-tree text buffer (the native vertex
# scan's per-locus prev-char table caches on its pointer).
_GEN_KEEPALIVE: Optional[bytes] = None
_TEXT_KEEPALIVE: Optional[bytes] = None


def _native_est_process(meg_arrays, config: Config, gen_seq_bytes: bytes,
                        est_bytes: bytes, est_orig_bytes: bytes,
                        deadline: Optional[float], cands=None):
    """One-call native flow: candidate enumeration + filter cascade +
    intron refinement + polyA + refinement pass (est_process in
    native/dp.c).  Returns (factorizations, polya, polyad) or None when
    the native path is unavailable/unsupported; raises TimeoutExpired on
    enumeration timeout.  When ``cands`` = (off, f, n) numpy arrays (the
    device-offload flow's pre-enumerated candidates), the enumeration is
    skipped and est_process_cands consumes them instead."""
    from pintron_tpu_torch.native import get_lib, np_scratch
    lib = get_lib()
    if lib is None or not hasattr(lib, "est_process"):
        return None
    global _GEN_KEEPALIVE
    _GEN_KEEPALIVE = gen_seq_bytes
    nv, ncols, ptrs = meg_arrays[6], meg_arrays[7], meg_arrays[8]
    counts, counts_ptr = np_scratch("ep_counts", 4)
    cap_facts, cap_factors = 256, 2048
    while True:
        out_off, off_ptr = np_scratch("ep_off", cap_facts + 1)
        out_f, f_ptr = np_scratch("ep_f", 4 * cap_factors)
        out_pa, pa_ptr = np_scratch("ep_pa", cap_facts)
        out_pd, pd_ptr = np_scratch("ep_pd", cap_facts)
        cap_facts = min(out_off.size - 1, out_pa.size, out_pd.size)
        cap_factors = out_f.size // 4
        args = (
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
            nv, ncols,
            gen_seq_bytes, len(gen_seq_bytes),
            est_bytes, len(est_bytes),
            est_orig_bytes, len(est_orig_bytes),
            config.min_factor_len, config.min_intron_length,
            deadline if deadline is not None else 0.0,
            config.complexity_threshold, config.max_site_difference,
            config.max_coverage_diff, config.max_gapLength_diff,
            config.max_number_of_factorizations,
            config.suffpref_length_on_est,
            config.suffpref_length_for_intron,
            config.suffpref_length_on_gen,
            off_ptr, f_ptr, pa_ptr, pd_ptr,
            cap_facts, cap_factors, counts_ptr)
        if cands is not None:
            c_off, c_f, c_n = cands
            nf = lib.est_process_cands(
                *args, c_off.ctypes.data, c_f.ctypes.data, c_n)
        else:
            nf = lib.est_process(*args)
        if nf == -2:
            cap_facts = int(counts[1]) + 1
            cap_factors = int(counts[2]) + 1
            continue
        if nf == -1:
            raise TimeoutExpired()
        if nf < 0:
            return None
        break
    facts: List[Factorization] = []
    f = out_f
    for i in range(nf):
        a, b = int(out_off[i]), int(out_off[i + 1])
        facts.append([Factor(int(f[4 * k]), int(f[4 * k + 1]),
                             int(f[4 * k + 2]), int(f[4 * k + 3]))
                      for k in range(a, b)])
    n_flags = int(counts[0])
    polya = [bool(out_pa[i]) for i in range(n_flags)]
    polyad = [bool(out_pd[i]) for i in range(n_flags)]
    return facts, polya, polyad


def _native_candidate_factorizations(meg_arrays, config: Config,
                                     gen_seq_bytes: bytes,
                                     deadline: Optional[float]):
    """Run the native embedding enumeration + factorization merge
    (meg_factorizations in native/dp.c).  Returns a list of candidate
    factorizations, None if the native path is unavailable, or raises
    TimeoutExpired."""
    from pintron_tpu_torch.native import get_lib, np_scratch
    lib = get_lib()
    if lib is None or not hasattr(lib, "meg_factorizations"):
        return None
    nv, ncols, ptrs = meg_arrays[6], meg_arrays[7], meg_arrays[8]
    need2, need2_ptr = np_scratch("fact_need2", 2)
    cap_facts, cap_factors = 1024, 8192
    while True:
        out_off, off_ptr = np_scratch("fact_off", cap_facts + 1)
        out_f, f_ptr = np_scratch("fact_f", 4 * cap_factors)
        cap_facts = out_off.size - 1
        cap_factors = out_f.size // 4
        nf = lib.meg_factorizations(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
            nv, ncols, gen_seq_bytes, len(gen_seq_bytes),
            config.min_factor_len, config.min_intron_length,
            deadline if deadline is not None else 0.0,
            off_ptr, f_ptr,
            cap_facts, cap_factors, need2_ptr)
        if nf == -2:
            cap_facts = int(need2[0]) + 1
            cap_factors = int(need2[1]) + 1
            continue
        if nf == -1:
            raise TimeoutExpired()
        if nf < 0:
            return None
        break
    out: List[Factorization] = []
    f = out_f
    for i in range(nf):
        a, b = int(out_off[i]), int(out_off[i + 1])
        out.append([Factor(int(f[4 * k]), int(f[4 * k + 1]),
                           int(f[4 * k + 2]), int(f[4 * k + 3]))
                    for k in range(a, b)])
    return out


def _native_cand_arrays(meg_arrays, config: Config, gen_seq_bytes: bytes,
                        deadline: Optional[float]):
    """Raw-array variant of _native_candidate_factorizations for the
    device-offload flow: returns owned numpy copies (off, f, n) suitable
    for est_collect_noisy / est_process_cands, None when unavailable, or
    raises TimeoutExpired."""
    import numpy as np

    from pintron_tpu_torch.native import get_lib, np_scratch
    lib = get_lib()
    if lib is None or not hasattr(lib, "meg_factorizations"):
        return None
    nv, ncols, ptrs = meg_arrays[6], meg_arrays[7], meg_arrays[8]
    need2, need2_ptr = np_scratch("fact_need2", 2)
    cap_facts, cap_factors = 1024, 8192
    while True:
        out_off, off_ptr = np_scratch("fact_off", cap_facts + 1)
        out_f, f_ptr = np_scratch("fact_f", 4 * cap_factors)
        cap_facts = out_off.size - 1
        cap_factors = out_f.size // 4
        nf = lib.meg_factorizations(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
            nv, ncols, gen_seq_bytes, len(gen_seq_bytes),
            config.min_factor_len, config.min_intron_length,
            deadline if deadline is not None else 0.0,
            off_ptr, f_ptr,
            cap_facts, cap_factors, need2_ptr)
        if nf == -2:
            cap_facts = int(need2[0]) + 1
            cap_factors = int(need2[1]) + 1
            continue
        if nf == -1:
            raise TimeoutExpired()
        if nf < 0:
            return None
        break
    # np_scratch buffers are reused across calls: copy out
    off = np.array(out_off[:nf + 1], dtype=np.int64)
    nfac = int(off[nf])
    f = np.array(out_f[:4 * nfac], dtype=np.int64)
    return off, f, nf


def get_est_factorizations(est_info: mf.EstInfo, V: MEG, config: Config,
                           gen_info: mf.EstInfo,
                           deadline: Optional[float],
                           meg_arrays=None,
                           gen_seq_bytes: Optional[bytes] = None,
                           cands=None) -> Optional[FactorizedEst]:
    """est-factorizations.c:126-594.  Returns None on timeout."""
    est = FactorizedEst(est_info)
    est_length = len(V) - 2
    gen_seq = gen_info.seq
    est_seq = est_info.seq

    import os as _os
    if meg_arrays is not None and not _os.environ.get(
            "PINTRON_NO_NATIVE_EST_PROCESS"):
        if gen_seq_bytes is None:
            gen_seq_bytes = gen_seq.encode("latin1")
        try:
            res = _native_est_process(
                meg_arrays, config, gen_seq_bytes,
                est_seq.encode("latin1"),
                est_info.original_seq.encode("latin1"), deadline,
                cands=cands)
        except TimeoutExpired:
            return None
        if res is not None:
            est.factorizations, est.polya_signals, \
                est.polyadenil_signals = res
            est.refined = True
            return est

    def deadline_check():
        return deadline is not None and time.monotonic() > deadline

    def python_candidates():
        for Vi in V:
            for p in Vi:
                p.number_of_visits = 0
                p.visited = False
        enum = EmbeddingEnumerator(config, gen_seq, deadline_check)
        for Vi in V:
            for next_pairing in Vi:
                if next_pairing.visited:
                    continue
                sub_embeddings = enum.get_subtree_embeddings(next_pairing)
                yield from get_factorizations_from_embeddings(
                    sub_embeddings, config)

    factorization_list: List[Factorization] = []

    try:
        candidates = None
        if meg_arrays is not None:
            if gen_seq_bytes is None:
                gen_seq_bytes = gen_seq.encode("latin1")
            candidates = _native_candidate_factorizations(
                meg_arrays, config, gen_seq_bytes, deadline)
        if candidates is None:
            candidates = python_candidates()
        for add_f in candidates:
            is_ok = flt.check_for_not_source_sink_factorization(
                add_f, est_length)
            if is_ok:
                is_ok = flt.check_exon_start_end(add_f)
            if is_ok:
                add_f = flt.handle_endpoints(add_f, gen_seq, est_seq)
                if not add_f:
                    is_ok = False
            if is_ok:
                add_f = flt.clean_external_exons(add_f, gen_seq,
                                                 est_seq)
                if not add_f:
                    is_ok = False
            if is_ok:
                add_f = flt.clean_low_complexity_exons_2(
                    add_f, gen_seq, est_seq, config)
                if not add_f:
                    is_ok = False
            if is_ok:
                add_f = flt.clean_noisy_exons(add_f, gen_seq,
                                              est_seq, False)
                if not add_f:
                    is_ok = False
            if is_ok:
                is_ok = flt.check_est_coverage(add_f, est_seq)
            if is_ok:
                factorization_list, _added = flt.add_if_not_exists(
                    add_f, factorization_list, config)
    except TimeoutExpired:
        return None

    # coverage + FILTER 1 (est-factorizations.c:272-331)
    coverages: List[float] = []
    max_coverage = 0.0
    for fact in factorization_list:
        is_source_sink = False
        if len(fact) == 1:
            head = fact[0]
            if head.est_start < 0 or head.est_start >= est_length:
                coverages.append(-1.0)
                is_source_sink = True
        if not is_source_sink:
            cov = flt.compute_coverage(fact, est_length)
            coverages.append(cov)
            if max_coverage < cov:
                max_coverage = cov

    est_seq_len = len(est_seq)
    keep = []
    for fact, cov in zip(factorization_list, coverages):
        if cov == -1.0 or max_coverage - cov > config.max_coverage_diff:
            continue
        if (max_coverage - cov) * est_seq_len > 100:
            continue
        keep.append(fact)
    factorization_list = keep

    # FILTER 3: total gap length (est-factorizations.c:376-414)
    gap_lengths = [flt.compute_gap_length(f) for f in factorization_list]
    min_gap = -1
    for gl in gap_lengths:
        if min_gap == -1 or min_gap > gl:
            min_gap = gl
    if config.max_gapLength_diff != -1:
        factorization_list = [
            f for f, gl in zip(factorization_list, gap_lengths)
            if gl - min_gap <= config.max_gapLength_diff]

    # FILTER 4: gap errors (est-factorizations.c:420-433)
    factorization_list = [
        f for f in factorization_list
        if flt.check_gap_errors(f, est_seq, gen_seq, config)]

    # artifact check
    if (config.max_number_of_factorizations != 0
            and len(factorization_list)
            > config.max_number_of_factorizations):
        factorization_list = []

    # intron refinement (est-factorizations.c:444-492)
    for fact in factorization_list:
        if not fact:
            continue
        first_intron = True
        for k in range(len(fact) - 1):
            refine_intron(config, gen_seq, est_seq, fact[k], fact[k + 1],
                          first_intron)
            first_intron = False
        if len(fact) >= 2 and fact[0].est_start == fact[1].est_start:
            fact.pop(0)

    # polyA detection (est-factorizations.c:572-585)
    for fact in factorization_list:
        correct_composition_tail(fact, gen_seq, est_info.original_seq)
        polya, polyadenil = detect_polya_signal(fact, gen_seq,
                                                est_info.original_seq)
        est.polya_signals.append(polya)
        est.polyadenil_signals.append(polyadenil)

    est.factorizations = factorization_list
    return est


def internal_get_est_factorizations(gen_info: mf.EstInfo,
                                    est_info: mf.EstInfo, config: Config,
                                    V: MEG, meg_arrays=None,
                                    gen_seq_bytes: Optional[bytes] = None,
                                    cands=None,
                                    deadline: Optional[float] = None
                                    ) -> Tuple[Optional[FactorizedEst],
                                               bool]:
    """compute-est-fact.c:154-190.  Returns (factorized, timeout_expired).
    ``deadline`` lets the batched device flow thread the SAME per-EST
    clock through enumeration and cascade (it starts the clock at
    enumeration, like the sequential path does here)."""
    if deadline is None and config.max_single_factorization_time:
        deadline = time.monotonic() + config.max_single_factorization_time
    fe = get_est_factorizations(est_info, V, config, gen_info, deadline,
                                meg_arrays=meg_arrays,
                                gen_seq_bytes=gen_seq_bytes,
                                cands=cands)
    timeout = deadline is not None and time.monotonic() > deadline
    if fe is not None:
        if not fe.refined:
            fe.factorizations = refine_est_factorizations(
                gen_info.seq, est_info.seq, est_info.original_seq,
                fe.factorizations, config)
            remove_factorizations_with_very_small_exons(fe.factorizations)
            if fe.factorizations:
                remove_duplicated_factorizations(fe.factorizations)
    else:
        timeout = True
    return fe, timeout


def build_meg(est_info: mf.EstInfo, tree: SuffixTree, gen_seq_bytes: bytes,
              shared_config: Config, inc_pairing_len: int
              ) -> Tuple[MEG, int]:
    """compute-est-fact.c:90-152 retry-on-complexity loop.  Returns
    (V, inc_pairing_len, flat_arrays)."""
    from pintron_tpu_torch.meg.dot import log_graphs_enabled, save_meg_to_filename
    log_graphs = log_graphs_enabled()

    config = shared_config.clone()
    pattern = est_info.seq.encode("latin1")
    if not log_graphs:
        V, inc, flat = megmod.build_meg_native(pattern, tree, gen_seq_bytes,
                                               shared_config, config,
                                               inc_pairing_len)
        if V is not None:
            return V, inc, flat
    while True:
        config.min_factor_len = shared_config.min_factor_len + inc_pairing_len
        V = megmod.build_vertex_set(pattern, tree, gen_seq_bytes, config)
        megmod.build_edge_set(V, config)
        if log_graphs:
            save_meg_to_filename(V, "meg-1-untouched.dot")
        simp.simplify_meg(V, config)
        if log_graphs:
            save_meg_to_filename(V, "meg-2-after-basic-simplification.dot")
        if config.trans_red:
            simp.transitive_reduction(V)
            if log_graphs:
                save_meg_to_filename(
                    V, "meg-3-after-transitive-reduction.dot")
        too_complex = simp.is_too_complex_for_compaction(V, config)
        if not too_complex and config.short_edge_comp:
            simp.compact_short_edges(V, config)
            if log_graphs:
                save_meg_to_filename(
                    V, "meg-4-after-short-edge-contraction.dot")
        too_complex = too_complex or simp.is_too_complex(V, config)
        if too_complex:
            if (shared_config.min_factor_len + inc_pairing_len + 1 + 2
                    < len(V)):
                inc_pairing_len += 1
                continue
        return V, inc_pairing_len, None


def write_meg(fh: TextIO, V) -> None:
    """io-meg.c:meg_write."""
    if isinstance(V, megmod.MegFlat):
        V.write_meg(fh)
        return
    index = 0
    for Vi in V:
        for p in Vi:
            fh.write(f"({p.p},{p.t},{p.l})\n")
            p.id = index
            index += 1
    fh.write("#adj#\n")
    for Vi in V:
        for p in Vi:
            for a in p.adjs:
                fh.write(f"{p.id}-{a.id}\n")


def write_intronic_edges(fh: TextIO, V) -> None:
    """max-emb-graph.c:add_intronic_edges_to_file."""
    if isinstance(V, megmod.MegFlat):
        V.write_intronic_edges(fh)
        return
    INTRONIC_EDGE = 50
    for Vi in V:
        for p in Vi:
            if p.is_source() or p.is_sink():
                continue
            for a in p.adjs:
                if a.is_sink():
                    continue
                fh.write(f"{p.t + p.l} {a.t} {p.p + p.l} {a.p} "
                         f"{a.t - p.t - p.l} {a.p - p.p - p.l} "
                         f"{(a.t - p.t) - (a.p - p.p)} {p.l} {a.l}")
                if (a.t - p.t) - (a.p - p.p) >= INTRONIC_EDGE:
                    fh.write(" intronic")
                fh.write("\n")


def compute_est_fact(gen_info: mf.EstInfo, est_info: mf.EstInfo,
                     tree: SuffixTree, gen_seq_bytes: bytes,
                     config: Config,
                     fmeg: Optional[TextIO], fpmeg: Optional[TextIO],
                     ftmeg: Optional[TextIO], fintronic: Optional[TextIO]
                     ) -> FactorizedEst:
    """compute-est-fact.c:192-293: MEG + factorization with the retry
    ladder."""
    inc_pairing_len = 0
    prev_tot_pairings = 0
    prev_tot_edges = 0
    factorized: Optional[FactorizedEst] = None

    while True:
        t_meg0 = time.monotonic()
        while True:
            V, inc_pairing_len, meg_arrays = build_meg(
                est_info, tree, gen_seq_bytes, config, inc_pairing_len)
            tot_pairings, tot_edges = megmod.meg_stats(V)
            same = (prev_tot_pairings > 2 and prev_tot_edges > 0
                    and (prev_tot_pairings <= tot_pairings
                         or prev_tot_edges <= tot_edges))
            if not same:
                break
            inc_pairing_len += 1
        prev_tot_pairings = tot_pairings
        prev_tot_edges = tot_edges
        meg_time = time.monotonic() - t_meg0

        t_fact0 = time.monotonic()
        factorized, timeout = internal_get_est_factorizations(
            gen_info, est_info, config, V, meg_arrays=meg_arrays,
            gen_seq_bytes=gen_seq_bytes)
        fact_time = time.monotonic() - t_fact0

        has_facts = factorized is not None and factorized.factorizations
        if not timeout or has_facts:
            if fmeg is not None:
                fmeg.write("\n\n***********\n\n")
                fmeg.write(f">{est_info.est_id}\n")
                fmeg.write(f"{est_info.original_seq}\n")
                write_meg(fmeg, V)

        if has_facts:
            if fintronic is not None:
                fintronic.write(f">{est_info.est_id}\n")
                write_intronic_edges(fintronic, V)
            if fpmeg is not None:
                fpmeg.write(f">{est_info.est_id}\n")
                fpmeg.write(f"{est_info.original_seq}\n")
                write_meg(fpmeg, V)
            if ftmeg is not None:
                ftmeg.write(f"{int(meg_time * 1e6)} "
                            f"{int(fact_time * 1e6)} "
                            f"{len(factorized.factorizations)}\n")
            return factorized
        if not timeout:
            return factorized if factorized is not None \
                else FactorizedEst(est_info)
        inc_pairing_len += 1


def write_multifasta_output(gen: mf.EstInfo, est: FactorizedEst,
                            fh: TextIO, retain_externals: bool) -> None:
    """io-multifasta.c:187-243."""
    if not est.factorizations:
        return
    for fact, polya, polyadenil in zip(est.factorizations,
                                       est.polya_signals,
                                       est.polyadenil_signals):
        size = len(fact)
        if not (retain_externals or size > 2
                or (size == 2 and est.info.suff_polyA_length != -1)):
            continue
        fh.write(f">{est.info.est_id}\n")
        if not retain_externals:
            polya = False
            polyadenil = False
        fh.write(f"#polya={1 if polya else 0}\n"
                 f"#polyad={1 if polyadenil else 0}\n")
        l_index = 0 if retain_externals else 1
        if retain_externals:
            r_index = size + 1
        else:
            r_index = size if est.info.suff_polyA_length == -1 else size + 1
        for counter, factor in enumerate(fact, start=1):
            if counter > l_index and counter < r_index:
                est_sub = est.info.original_seq[
                    factor.est_start:factor.est_end + 1]
                gen_sub = gen.original_seq[
                    gen.pref_N_length + factor.gen_start:
                    gen.pref_N_length + factor.gen_end + 1]
                fh.write(f"{factor.est_start + 1} {factor.est_end + 1} "
                         f"{gen.pref_N_length + factor.gen_start + 1} "
                         f"{gen.pref_N_length + factor.gen_end + 1} "
                         f"{est_sub} {gen_sub}\n")


# Per-process context used by _process_unit: set directly in sequential
# mode, or rebuilt inside each persistent worker from the pickled
# (gen, gen_seq_bytes, config) triple it receives per run.
_WORKER_CTX = None

# Test-only straggler injection (seconds): set on the module BEFORE the
# pool is created so forked workers inherit it; worker 0 then sleeps
# before claiming records, exercising the dynamic re-shard path.
_TEST_STRAGGLER_S: Optional[float] = None

# persistent output buffer for the fused native unit flow (grow-only;
# each worker process is single-threaded)
_UNIT_OUT = None


def _native_cfg_arrays(config: Config):
    """(icfg_ptr, dcfg ndarray) marshaled for unit_process/worker_run."""
    import numpy as np

    from pintron_tpu_torch.native import np_scratch
    icfg, icfg_ptr = np_scratch("up_icfg", 13)
    icfg[:13] = [config.min_factor_len, config.max_intron_length,
                 config.min_intron_length, config.max_pairings_in_MEG,
                 1 if config.trans_red else 0,
                 1 if config.short_edge_comp else 0,
                 config.max_site_difference, config.max_gapLength_diff,
                 config.max_number_of_factorizations,
                 config.suffpref_length_on_est,
                 config.suffpref_length_for_intron,
                 config.suffpref_length_on_gen,
                 1 if config.retain_externals else 0]
    dcfg = np.array([config.min_string_depth_rate,
                     config.max_prefix_discarded_rate,
                     config.max_suffix_discarded_rate,
                     config.max_freq_shortest_pairing,
                     config.complexity_threshold,
                     config.max_coverage_diff,
                     float(config.max_single_factorization_time or 0)],
                    dtype=np.float64)
    return icfg_ptr, dcfg


def _native_gates():
    """True when the fused native paths may run at all."""
    import os
    if os.environ.get("PINTRON_NO_NATIVE_EST_PROCESS") \
            or os.environ.get("PINTRON_NO_NATIVE_UNIT"):
        return False
    from pintron_tpu_torch.meg.dot import log_graphs_enabled
    return not log_graphs_enabled()


def _native_worker_run(gen: mf.EstInfo, tree: SuffixTree,
                       gen_seq_bytes: bytes, config: Config,
                       ests_path: str, w: int, n: int,
                       claim_addr: Optional[int] = None):
    """Whole-run native worker (worker_run in native/dp.c): parse
    ests.txt, preprocess the owned records, and run every owned unit —
    all in one C call.  Returns a list of (record_index, six-blob tuple
    or None) in file order, where None marks a unit the C side declined
    (host fallback recomputes just that unit); or None when the whole
    run must fall back."""
    import os
    if not _native_gates() or os.environ.get("PINTRON_NO_NATIVE_WORKER"):
        return None
    from pintron_tpu_torch.native import get_lib, np_scratch
    lib = get_lib()
    if lib is None or not hasattr(lib, "worker_run"):
        return None

    import ctypes

    global _GEN_KEEPALIVE, _TEXT_KEEPALIVE, _UNIT_OUT
    _GEN_KEEPALIVE = gen_seq_bytes
    _TEXT_KEEPALIVE = tree.text

    flat = tree.flat_arrays()
    ptrs = flat["_ptrs"]
    from pintron_tpu_torch.meg.graph import _gen_maps
    _ai, alph_size, _a256, a256_ptr = _gen_maps(gen_seq_bytes)
    gen_orig = gen.original_seq.encode("latin1")
    icfg_ptr, dcfg = _native_cfg_arrays(config)

    path_b = os.fspath(ests_path).encode()
    data_p = ctypes.c_void_p()
    meta_p = ctypes.c_void_p()
    n_units = lib.worker_run(
        tree.text, len(tree.text),
        ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
        ptrs[6], ptrs[7], ptrs[8], ptrs[9], ptrs[10], ptrs[11],
        a256_ptr, alph_size,
        gen_seq_bytes, len(gen_seq_bytes),
        gen_orig, len(gen_orig),
        gen.pref_N_length,
        icfg_ptr, dcfg.ctypes.data,
        path_b, claim_addr, w, n,
        ctypes.byref(data_p), ctypes.byref(meta_p))
    if n_units < 0:
        return None
    try:
        meta = ctypes.cast(
            meta_p, ctypes.POINTER(ctypes.c_int64 * (7 * n_units))
        ).contents if n_units else []
        total = sum(max(meta[7 * u + 1 + s], 0)
                    for u in range(n_units) for s in range(6))
        data = ctypes.string_at(data_p, total) if total else b""
        out = []
        pos = 0
        for u in range(n_units):
            rec = int(meta[7 * u])
            lens = [int(meta[7 * u + 1 + s]) for s in range(6)]
            if lens[0] == -1:
                out.append((rec, None))
                continue
            blobs = []
            for ln in lens:
                blobs.append(data[pos:pos + ln].decode("latin1"))
                pos += ln
            out.append((rec, tuple(blobs)))
        return out
    finally:
        lib.up_buf_free(data_p)
        lib.up_buf_free(meta_p)


def _unit_for_record(gen: mf.EstInfo, est: mf.EstInfo) -> List[mf.EstInfo]:
    """Preprocess one parsed record into its work unit (a fixed-strand
    EST alone, or a forward EST plus its RC copy)."""
    mf.set_est_gb_identification(est)
    mf.set_est_strand_and_rc(est, gen)
    mf.polyat_substitution(est)
    if not est.fixed_strand:
        rev = est.copy_and_reverse()
        mf.polyat_substitution(rev)
        return [est, rev]
    return [est]


def _run_units(gen: mf.EstInfo, tree: SuffixTree, gen_seq_bytes: bytes,
               config: Config, ests_path: str, w: int, n: int,
               fresh: bool = False, claim_addr: Optional[int] = None):
    """Produce (record_index, six-blob tuple) pairs for this worker's
    share of ests.txt: whole-run native call when possible, per-unit or
    whole-run host fallback otherwise.  The share is records w::n, or —
    when ``claim_addr`` points at a shared atomic counter — whatever
    records this worker wins by fetch-add (dynamic balancing; each
    record still processed exactly once, reassembly is by record
    index).  ``fresh`` wipes the persistent result memo first, so the
    run measures fresh-locus work (benchmark mode)."""
    global _WORKER_CTX
    if fresh:
        from pintron_tpu_torch.native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "ep_memo_wipe"):
            lib.ep_memo_wipe()
    _WORKER_CTX = (gen, tree, gen_seq_bytes, config)
    try:
        res = _native_worker_run(gen, tree, gen_seq_bytes, config,
                                 ests_path, w, n, claim_addr=claim_addr)
        if res is not None:
            if not all(t is not None for _, t in res):
                with open(ests_path) as fh:
                    ests = mf.read_multifasta(fh)
                res = [(rec, t if t is not None else _process_unit(
                            _unit_for_record(gen, ests[rec])))
                       for rec, t in res]
            return res
        if claim_addr is not None:
            # a stride fallback would double-process records other
            # workers claimed; surface the failure so the parent
            # retries the whole run deterministically
            raise RuntimeError("native worker unavailable mid-claim")
        return [(w + k * n, _process_unit(u))
                for k, u in enumerate(
                    _worker_units_from_file(gen, ests_path, w, n))]
    finally:
        _WORKER_CTX = None


def _collect_noisy(lib, cands, gen_seq_bytes: bytes, est_bytes: bytes,
                   est_orig_bytes: bytes, est_length: int, config: Config):
    """Native collect pass (est_collect_noisy in dp.c): list the noisy-
    exon K-band problems the cascade will need for this EST.  Returns
    (coords Nx4 int64, problems [(gen_win, est_win, max_err)], seq_id)
    or None when the memo is unavailable (plain CPU path then)."""
    import numpy as np

    from pintron_tpu_torch.native import np_scratch
    c_off, c_f, c_n = cands
    meta, meta_ptr = np_scratch("cn_meta", 2)
    cap = 256
    while True:
        out, out_ptr = np_scratch("cn_out", 9 * cap)
        cap = out.size // 9
        n = lib.est_collect_noisy(
            c_off.ctypes.data, c_f.ctypes.data, c_n,
            gen_seq_bytes, len(gen_seq_bytes),
            est_bytes, len(est_bytes),
            est_orig_bytes, len(est_orig_bytes),
            est_length, config.complexity_threshold,
            out_ptr, cap, meta_ptr)
        if n == -2:
            cap = int(meta[0]) + 1
            continue
        if n < 0:
            return None
        break
    recs = np.array(out[:9 * n], dtype=np.int64).reshape(n, 9)
    coords = np.ascontiguousarray(recs[:, :4])
    probs = []
    for r in recs:
        g = gen_seq_bytes[int(r[4]):int(r[4]) + int(r[5])]
        e = est_bytes[int(r[6]):int(r[6]) + int(r[7])]
        probs.append((g, e, int(r[8])))
    return coords, probs, int(meta[1])


def _collect_endpoints(lib, cands, gen_seq_bytes: bytes,
                       est_bytes: bytes, est_orig_bytes: bytes,
                       est_length: int):
    """Native collect pass for the endpoint-NW offload
    (est_collect_endpoints in dp.c): list the head/tail alignment
    problems whose tag-1/2 memo entries are missing.  Returns the
    (n, 9) int64 record array, or None when unavailable."""
    import numpy as np

    from pintron_tpu_torch.native import np_scratch
    if not hasattr(lib, "est_collect_endpoints"):
        return None
    c_off, c_f, c_n = cands
    meta, meta_ptr = np_scratch("ce_meta", 2)
    cap = 128
    while True:
        out, out_ptr = np_scratch("ce_out", 9 * cap)
        cap = out.size // 9
        n = lib.est_collect_endpoints(
            c_off.ctypes.data, c_f.ctypes.data, c_n,
            gen_seq_bytes, len(gen_seq_bytes),
            est_bytes, len(est_bytes),
            est_orig_bytes, len(est_orig_bytes),
            est_length, out_ptr, cap, meta_ptr)
        if n == -2:
            cap = int(meta[0]) + 1
            continue
        if n < 0:
            return None
        break
    return np.array(out[:9 * int(n)], dtype=np.int64).reshape(int(n), 9)


def _collect_gaps(lib, meg_arrays, cands, gen_seq_bytes: bytes,
                  est_bytes: bytes, est_orig_bytes: bytes,
                  config: Config):
    """Native collect pass for the refine-borders offload
    (est_collect_gaps in dp.c): replay the cascade with the warm K-band
    memo and list FILTER 4's gap problems.  Returns the (n, 9) int64
    record array, or None when unavailable."""
    import numpy as np

    from pintron_tpu_torch.native import np_scratch
    if not hasattr(lib, "est_collect_gaps"):
        return None
    nv, ncols, ptrs = meg_arrays[6], meg_arrays[7], meg_arrays[8]
    c_off, c_f, c_n = cands
    meta, meta_ptr = np_scratch("cg_meta", 2)
    cap = 128
    while True:
        out, out_ptr = np_scratch("cg_out", 9 * cap)
        cap = out.size // 9
        n = lib.est_collect_gaps(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
            nv, ncols,
            gen_seq_bytes, len(gen_seq_bytes),
            est_bytes, len(est_bytes),
            est_orig_bytes, len(est_orig_bytes),
            config.min_factor_len, config.min_intron_length, 0.0,
            config.complexity_threshold, config.max_site_difference,
            config.max_coverage_diff, config.max_gapLength_diff,
            config.max_number_of_factorizations,
            config.suffpref_length_on_est,
            config.suffpref_length_for_intron,
            config.suffpref_length_on_gen,
            c_off.ctypes.data, c_f.ctypes.data, c_n,
            out_ptr, cap, meta_ptr)
        if n == -2:
            cap = int(meta[0]) + 1
            continue
        if n < 0:
            return None
        break
    return np.array(out[:9 * int(n)], dtype=np.int64).reshape(int(n), 9)


def _collect_introns(lib, meg_arrays, cands, gen_seq_bytes: bytes,
                     est_bytes: bytes, est_orig_bytes: bytes,
                     config: Config):
    """Native collect pass for the intron-refinement (gap-alignment)
    offload (est_collect_introns in dp.c): replay the cascade through
    FILTER 4 with the warm K-band/rb memos, then walk each refine-intron
    chain against the tag-3 memo and list the first un-memoized gap
    problem per chain.  Returns (records (n, 13) int64, window arena
    bytes, the windows left out for their size), or None when
    unavailable."""
    import numpy as np

    from pintron_tpu_torch.native import np_scratch
    if not hasattr(lib, "est_collect_introns"):
        return None
    nv, ncols, ptrs = meg_arrays[6], meg_arrays[7], meg_arrays[8]
    c_off, c_f, c_n = cands
    meta, meta_ptr = np_scratch("ci_meta", 3)
    cap = 128
    arena_cap = 64 * 1024
    while True:
        out, out_ptr = np_scratch("ci_out", 13 * cap)
        cap = out.size // 13
        # byte arena carried in an int64 scratch (np_scratch is
        # int64-only); viewed as bytes below
        arena, arena_ptr = np_scratch("ci_arena", (arena_cap + 7) // 8)
        arena_cap = arena.size * 8
        n = lib.est_collect_introns(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
            nv, ncols,
            gen_seq_bytes, len(gen_seq_bytes),
            est_bytes, len(est_bytes),
            est_orig_bytes, len(est_orig_bytes),
            config.min_factor_len, config.min_intron_length, 0.0,
            config.complexity_threshold, config.max_site_difference,
            config.max_coverage_diff, config.max_gapLength_diff,
            config.max_number_of_factorizations,
            config.suffpref_length_on_est,
            config.suffpref_length_for_intron,
            config.suffpref_length_on_gen,
            c_off.ctypes.data, c_f.ctypes.data, c_n,
            out_ptr, cap, arena_ptr, arena_cap, meta_ptr)
        if n == -2:
            cap = int(meta[0]) + 1
            arena_cap = max(arena_cap, int(meta[1]) + 1)
            continue
        if n < 0:
            return None
        break
    recs = np.array(out[:13 * int(n)], dtype=np.int64).reshape(int(n), 13)
    arena_bytes = arena.view(np.uint8).tobytes()
    return recs, arena_bytes, int(meta[2])


def _own_meg_arrays(flat):
    """Deep-copy a scratch-backed MegFlat arrays tuple (build_meg_native
    reuses per-process scratch on every call) into owned arrays.  The
    device flow holds many ESTs' MEGs at once across subsequent
    build_meg calls, so scratch-backed views would be clobbered."""
    import numpy as np
    p, t, l, col, off, adj, nv, ncols, _ptrs = flat
    nadj = int(off[nv]) if nv else 0
    own = (np.array(p[:nv]), np.array(t[:nv]), np.array(l[:nv]),
           np.array(col[:nv]), np.array(off[:nv + 1]),
           np.array(adj[:nadj]))
    ptrs = tuple(a.ctypes.data for a in own)
    return own + (nv, ncols, ptrs)



# ---- the device flow -----------------------------------------------------

# smallest locus (records in ests.txt) that the service mode shards over
# fork workers: the JAX package's value, not one measured for the port
FORK_MIN_RECORDS = 128

OUTPUT_NAMES = ("raw-multifasta-out.txt", "megs.txt",
                "processed-megs.txt", "processed-megs-info.txt",
                "processed-ests.txt", "meg-edges.txt")


# the native collect, fill and lookaside entries the device flow calls
NATIVE_ENTRIES = ("est_collect_noisy", "est_collect_endpoints",
                  "est_collect_gaps", "est_collect_introns", "epm_fill_noisy",
                  "epm_fill_endpoints", "epm_fill_rb", "ri_lookaside_set",
                  "ri_lookaside_clear", "ri_dev_set_bounds")


def _native_lib():
    """The native library with the entries the device flow needs;
    raises when it is unavailable (the port never drops to another path
    on its own)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native library (pintron_tpu_torch.native) "
                           "is unavailable")
    missing = [n for n in NATIVE_ENTRIES if not hasattr(lib, n)]
    if missing:
        raise RuntimeError(f"the native library lacks {missing}")
    if not _native_gates():
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

    Each DP family runs where its switch routes it
    (``offload.family_routes``): on the card, on the host DP inside the
    cascade, or under the self-tuner, one opportunity a round (K-band,
    NW) or a chunk (rb, gap) as in the JAX device flow.

    Returns [(unit index, six-blob tuple)] for the owned units, in file
    order."""
    global _GEN_KEEPALIVE, _TEXT_KEEPALIVE
    lib = _native_lib()
    routes = offload.family_routes()
    # the native memo fast-paths on the genomic and suffix-tree buffers'
    # addresses; holding them here keeps a freed buffer from being
    # recycled at the same address
    _GEN_KEEPALIVE = gen_seq_bytes
    _TEXT_KEEPALIVE = tree.text
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

        with timing.span("pintron_step2_meg_enum"):
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

        if offload.on_card("nw", routes["nw"]):
            _offload_endpoints(lib, round_recs, gen_seq_bytes, routes["nw"])

        # Noisy-exon collect (it memo-hits the endpoints filled above):
        # every K-band check of the round goes to the device batch.  With
        # the family on the host no problem is collected, and the cascade
        # (the rb collect's replay first) computes the checks itself.
        kband_on = offload.on_card("kband", routes["kband"])
        with timing.span("pintron_step2_collect_noisy"):
            for rec in round_recs:
                if kband_on and rec["cands"] is not None:
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
        # A chunk that failed or timed out raises.
        ok_global = np.zeros(len(problems), dtype=np.int64)

        def fill_kband(rec):
            if rec["probmap"] is not None and rec["probmap"][1]:
                coords, idxs = rec["probmap"]
                okvec = np.ascontiguousarray(
                    ok_global[np.asarray(idxs, dtype=np.int64)])
                lib.epm_fill_noisy(
                    gen_seq_bytes, len(gen_seq_bytes),
                    rec["est_bytes"], len(rec["est_bytes"]),
                    rec["est_orig_bytes"], len(rec["est_orig_bytes"]),
                    coords.ctypes.data, okvec.ctypes.data, len(idxs))

        @timing.span("pintron_step2_cascade")
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

        def eval_kband(chunk):
            ok, elapsed = _timed(offload.eval_kband, chunk)
            if routes["kband"] == offload.AUTO:
                offload.tune_report("kband", elapsed,
                                    offload.host_estimate("kband", chunk))
            return ok

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
                        ("done", eval_kband(problems[lo:hi]), lo, hi))
                else:
                    launches.append(
                        ("fut", pool.submit(timing.bind(eval_kband),
                                            problems[lo:hi]), lo, hi))
            # Software pipeline: chunk i's gap batch is in flight on the
            # executor thread while chunk i-1's cascades run here (and
            # while chunk i+1's collect and rb work proceeds).
            staged = None   # (recs_c, pending gap batch) awaiting cascades
            for (recs_c, _pend), launch in zip(bounds, launches):
                if launch is not None:
                    kind, val, lo, hi = launch
                    ok_global[lo:hi] = (val if kind == "done"
                                        else val.result())
                for rec in recs_c:
                    fill_kband(rec)
                if offload.on_card("rb", routes["rb"]):
                    _offload_rb(lib, recs_c, gen_seq_bytes, config,
                                routes["rb"])
                prep = (_prep_introns(lib, recs_c, gen_seq_bytes, config,
                                      pool, routes["gap"])
                        if offload.on_card("gap", routes["gap"]) else None)
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
    this process's, and their tuner latches taken into this process's
    (``offload.inherit_latches``), which later forks inherit.  A failed
    worker raises here, after every worker has ended: no other path
    stands in for it."""
    import multiprocessing

    ctx = multiprocessing.get_context("fork")

    def child_main(w, pw):
        # report only this worker's own work: the counters inherited
        # from the parent are not merged again
        offload.reset_stats()
        dp_census_reset()
        try:
            res = _run_units_worker(gen, tree, gen_seq_bytes, config,
                                    ests_path, fresh, w, nworkers)
            pw.send(("ok", res, dict(offload.STATS), dp_census() or {},
                     offload.latches(), timing.trace_take()))
        except BaseException as e:  # noqa: BLE001 - reported to the parent
            pw.send(("err", f"{type(e).__name__}: {e}", None, None, None,
                     timing.trace_take()))
        finally:
            pw.close()

    workers = []
    with timing.span("pintron_fork", processes=nworkers):
        for w in range(nworkers):
            pr, pw = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=child_main, args=(w, pw))
            proc.start()
            pw.close()
            workers.append((pr, proc))

    with timing.span("pintron_fork_wait"):
        merged, census, errors = _merge_workers(workers)
    if errors:
        raise RuntimeError("sharded STEP 2 device flow failed: "
                           + "; ".join(errors))
    offload.tally(device_runs=1)
    return [merged[i] for i in sorted(merged)], census


def _merge_workers(workers):
    """Each worker's reply, in worker order, merged: (blobs by unit,
    host DP cells by family, the failed workers)."""
    merged, census, errors = {}, {}, []
    for w, (pr, proc) in enumerate(workers):
        try:
            status, payload, stats, cells, latched, spans = pr.recv()
            timing.trace_add(spans)
        except (EOFError, OSError) as e:
            status, payload = "err", f"no reply ({type(e).__name__})"
        pr.close()
        proc.join()
        if status != "ok":
            errors.append(f"worker {w} (exit {proc.exitcode}): {payload}")
            continue
        merged.update(payload)
        offload.inherit_latches(latched)
        offload.tally(**{k: v for k, v in stats.items()
                         if k != "device_runs"})
        for k, v in cells.items():
            census[k] = census.get(k, 0) + v
    return merged, census, errors


def _run_units_worker(gen, tree, gen_seq_bytes, config, ests_path, fresh,
                      w: int, nworkers: int):
    """``_run_units_device`` over worker ``w``'s shard of ``nworkers``,
    as one ``pintron_est_worker`` span (attrs: worker, nworkers, and
    cpu_s, this process's CPU seconds in it)."""
    cpu0 = time.process_time()
    with timing.span("pintron_est_worker", worker=w, nworkers=nworkers):
        try:
            return _run_units_device(gen, tree, gen_seq_bytes, config,
                                     ests_path, fresh=fresh,
                                     shard=(w, nworkers))
        finally:
            timing.note(cpu_s=time.process_time() - cpu0)


def _timed(fn, *args):
    """(fn(*args), its wall seconds)."""
    t0 = time.monotonic()
    res = fn(*args)
    return res, time.monotonic() - t0


@timing.span("pintron_step2_nw_phase")
def _offload_endpoints(lib, round_recs, gen_seq_bytes: bytes,
                       route: str) -> None:
    """Endpoint-NW phase of a round: collect the head/tail alignment
    problems from the candidate arrays, evaluate them in one device
    batch with the traceback, and pre-fill the tag-1/2 memo with the
    evaluated ones, so the noisy collect pass memo-hits them.  Under
    ``auto`` the batch's time goes to the tuner."""
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
    (ops, nsteps, evaluated), elapsed = _timed(offload.eval_nw, problems)
    if route == offload.AUTO:
        offload.tune_report("nw", elapsed,
                            offload.host_estimate("nw", problems))
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


@timing.span("pintron_step2_rb_phase")
def _offload_rb(lib, recs_c, gen_seq_bytes: bytes, config: Config,
                route: str) -> None:
    """Refine-borders phase of a chunk: collect FILTER 4's gap problems
    (a cascade replay on the warm K-band memo), evaluate both DP passes'
    row tables in one device batch, and pre-fill the tag-10 memo for
    the records whose two passes were both evaluated (the native cut
    selection runs in ``epm_fill_rb``).  Under ``auto`` a batch under
    ``offload.RB_MIN_BATCH`` problems is left to the host DP, and a
    batch's time goes to the tuner."""
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
    if route == offload.AUTO and len(problems) < offload.RB_MIN_BATCH:
        offload.tally(rb_on_host=1)
        return
    (vals, pos, evaluated), elapsed = _timed(offload.eval_rb, problems)
    if route == offload.AUTO:
        offload.tune_report("rb", elapsed,
                            offload.host_estimate("rb", problems))
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


@timing.span("pintron_step2_gap_collect")
def _prep_introns(lib, recs_c, gen_seq_bytes: bytes, config: Config,
                  pool, route: str):
    """Gap-alignment phase of a chunk, part 1: collect every speculative
    gap problem of the chunk's refine-intron chains
    (``est_collect_introns``) and submit one device batch, on the
    executor when there is one.  Returns (per_rec, pending timed batch,
    host estimate for the tuner or None), or None when the chunk has no
    gap problem, or (under ``auto``) fewer than
    ``offload.GAP_MIN_BATCH``, which the host DP computes.  The collect
    leaves a window over ``offload.TRACEBACK_BOUND`` to the host DP
    (counted in ``gap_too_wide``)."""
    lib.ri_dev_set_bounds(*offload.TRACEBACK_BOUND)
    per_rec = []
    problems = []
    for rec in recs_c:
        if rec["cands"] is None or rec["meg_arrays"] is None:
            continue
        col = _collect_introns(lib, rec["meg_arrays"], rec["cands"],
                               gen_seq_bytes, rec["est_bytes"],
                               rec["est_orig_bytes"], config)
        if col is None:
            continue
        recs, arena, too_wide = col
        offload.tally(gap_too_wide=too_wide)
        if not len(recs):
            continue
        base = len(problems)
        for r in recs:
            eo, nn, go, mm = (int(x) for x in r[9:13])
            problems.append((arena[eo:eo + nn], arena[go:go + mm]))
        per_rec.append((rec, recs, arena, base))
    if not problems:
        return None
    est = None
    if route == offload.AUTO:
        if len(problems) < offload.GAP_MIN_BATCH:
            offload.tally(gap_on_host=1)
            return None
        est = offload.host_estimate("gap", problems)
    if pool is None:
        return per_rec, ("done", _timed(offload.eval_gap, problems)), est
    return (per_rec, ("fut", pool.submit(timing.bind(_timed),
                                         offload.eval_gap, problems)), est)


@timing.span("pintron_step2_gap_wait")
def _resolve_introns(prep) -> None:
    """Part 2: wait for the chunk's gap batch (its time goes to the
    tuner under ``auto``) and attach to each record its evaluated
    windows' results, which ``run_cascade`` installs in
    the lookaside around the record's cascade.  A window left out
    misses the lookaside and the cascade computes it on the host."""
    if prep is None:
        return
    per_rec, (kind, val), est = prep
    (sm, ops, nsteps, evaluated), elapsed = (val if kind == "done"
                                             else val.result())
    if est is not None:
        offload.tune_report("gap", elapsed, est)
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


# ---- the host path -------------------------------------------------------

def _native_unit_process(unit: List[mf.EstInfo], gen: mf.EstInfo,
                         tree: SuffixTree, gen_seq_bytes: bytes,
                         config: Config):
    """One-call native flow for a whole work unit (unit_process in
    native/dp.c): vertex scan + MEG build + retry ladders + est_process +
    the six output-text sections, mirroring compute_est_fact and the
    sequential loop of main-est-fact.c:247-291.  Returns the six output
    blobs or None when the native path is unavailable (the caller then
    recomputes through the host path)."""
    if not _native_gates():
        return None
    from pintron_tpu_torch.native import get_lib, np_scratch
    lib = get_lib()
    if lib is None or not hasattr(lib, "unit_process"):
        return None

    import ctypes

    global _GEN_KEEPALIVE, _TEXT_KEEPALIVE, _UNIT_OUT
    _GEN_KEEPALIVE = gen_seq_bytes
    _TEXT_KEEPALIVE = tree.text

    flat = tree.flat_arrays()
    ptrs = flat["_ptrs"]
    from pintron_tpu_torch.meg.graph import _gen_maps
    _alph_index, alph_size, _a256, a256_ptr = _gen_maps(gen_seq_bytes)

    gen_orig = gen.original_seq.encode("latin1")

    parts: List[bytes] = []
    meta: List[int] = []
    off = 0
    for est in unit:
        idb = est.est_id.encode("latin1")
        seqb = est.seq.encode("latin1")
        origb = est.original_seq.encode("latin1")
        meta += [off, len(idb), off + len(idb), len(seqb),
                 off + len(idb) + len(seqb), len(origb),
                 1 if est.fixed_strand else 0, est.suff_polyA_length]
        parts += [idb, seqb, origb]
        off += len(idb) + len(seqb) + len(origb)
    blob = b"".join(parts)
    emeta, emeta_ptr = np_scratch("up_emeta", len(meta))
    emeta[:len(meta)] = meta
    icfg_ptr, dcfg = _native_cfg_arrays(config)
    out_meta, out_meta_ptr = np_scratch("up_ometa", 8)

    if _UNIT_OUT is None:
        _UNIT_OUT = ctypes.create_string_buffer(1 << 20)
    while True:
        rc = lib.unit_process(
            tree.text, len(tree.text),
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
            ptrs[6], ptrs[7], ptrs[8], ptrs[9], ptrs[10], ptrs[11],
            a256_ptr, alph_size,
            gen_seq_bytes, len(gen_seq_bytes),
            gen_orig, len(gen_orig),
            gen.pref_N_length,
            icfg_ptr, dcfg.ctypes.data,
            blob, emeta_ptr, len(unit),
            _UNIT_OUT, len(_UNIT_OUT),
            out_meta_ptr)
        if rc == -2:
            _UNIT_OUT = ctypes.create_string_buffer(
                max(2 * len(_UNIT_OUT), int(out_meta[6]) + 4096))
            continue
        if rc != 0:
            return None
        break
    data = ctypes.string_at(_UNIT_OUT, int(out_meta[6]))
    res = []
    pos = 0
    for i in range(6):
        ln = int(out_meta[i])
        res.append(data[pos:pos + ln].decode("latin1"))
        pos += ln
    return tuple(res)


def _worker_units_from_file(gen: mf.EstInfo, ests_path: str, w: int,
                            n: int):
    """Parse ests.txt inside the worker and yield this worker's share of
    the work units (record k -> unit k; each record is one unit: a
    fixed-strand EST alone or a forward EST plus its RC copy).  Only the
    owned records are preprocessed — unit structure depends solely on
    each record's own header, so worker w can skip everything else."""
    with open(ests_path) as fh:
        ests = mf.read_multifasta(fh)
    for idx, est in enumerate(ests):
        if idx % n != w:
            continue
        yield _unit_for_record(gen, est)


def _worker_main(conn) -> None:
    """Persistent worker loop: each message carries the run context and
    this worker's interleaved share of the units — either explicit
    EstInfo lists, or ('file', ests_path, w, n) telling the worker to
    parse ests.txt itself (no sequence bytes cross the pipe).  The reply
    is the list of per-unit output blobs (or ('err', traceback)).  The
    (gen, config, suffix tree) context is cached by digest so repeated
    runs on the same locus ship only the digest."""
    import sys as _sys
    _sys.setrecursionlimit(1_000_000)
    global _WORKER_CTX
    ctx_cache = {}
    tree_cache = {}
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            return
        digest, payload, units = msg
        try:
            cached = ctx_cache.get(digest)
            if cached is None:
                gen, gen_seq_bytes, config = payload
                ctx_cache.clear()  # one run context at a time
                # the suffix tree depends only on the genomic bytes:
                # keep it across config-only context changes
                tree = tree_cache.get(gen_seq_bytes)
                if tree is None:
                    tree_cache.clear()  # one locus at a time
                    tree = SuffixTree(gen_seq_bytes)
                    tree_cache[gen_seq_bytes] = tree
                cached = (gen, tree, gen_seq_bytes, config)
                ctx_cache[digest] = cached
            if isinstance(units, tuple) and units and units[0] == "file":
                _path, _w, _n = units[1], units[2], units[3]
                _fresh = bool(units[4]) if len(units) > 4 else False
                _claim = units[5] if len(units) > 5 else None
                _tree = cached[1]
                if _TEST_STRAGGLER_S and _w == 0:
                    # test hook (set via module state BEFORE the pool
                    # forks, tests/test_est_fact.py): delay worker 0 so
                    # the dynamic claim counter re-shards its records
                    time.sleep(_TEST_STRAGGLER_S)
                if _fresh:
                    # fresh-locus benchmark mode: rebuild the index too
                    _tree = SuffixTree(cached[2])
                res = _run_units(cached[0], _tree, cached[2],
                                 cached[3], _path, _w, _n, fresh=_fresh,
                                 claim_addr=_claim)
            else:
                _WORKER_CTX = cached
                res = [_process_unit(u) for u in units]
            conn.send(res)
        except Exception:
            import traceback
            try:
                conn.send(("err", traceback.format_exc()))
            except Exception:
                return
        finally:
            _WORKER_CTX = None


class _PersistentPool:
    """Fork-based worker processes kept alive across run_est_fact calls
    (the pipeline and the benchmark call the stage repeatedly; pool
    setup/teardown would otherwise dominate small loci).  Units are
    dealt round-robin (worker w gets units w::n) and reassembled by
    index, so output is byte-identical to sequential order."""

    def __init__(self, n: int):
        import ctypes
        import mmap
        import multiprocessing
        ctx = multiprocessing.get_context("fork")
        self.n = n
        self.pipes = []
        self.procs = []
        self.sent_digests = set()
        # shared atomic record-claim counter for dynamic balancing: an
        # anonymous MAP_SHARED page created BEFORE the forks, so every
        # worker inherits the same mapping at the same address
        try:
            self.claim_mm = mmap.mmap(-1, 8)
            self.claim_addr = ctypes.addressof(
                ctypes.c_char.from_buffer(self.claim_mm))
        except (OSError, ValueError):
            self.claim_mm = None
            self.claim_addr = None
        for _ in range(n):
            parent_conn, child_conn = ctx.Pipe()
            proc = ctx.Process(target=_worker_main, args=(child_conn,),
                               daemon=True)
            proc.start()
            child_conn.close()
            self.pipes.append(parent_conn)
            self.procs.append(proc)

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def _digest(self, gen, gen_seq_bytes, config):
        import hashlib
        import pickle
        # the digest must cover everything the cached context carries:
        # the gen EstInfo (header/strand/coordinate metadata), the
        # genomic bytes, and the config
        return hashlib.sha1(
            pickle.dumps((gen, config)) + gen_seq_bytes).hexdigest()

    def run(self, gen, gen_seq_bytes, config, units):
        payload = (gen, gen_seq_bytes, config)
        digest = self._digest(gen, gen_seq_bytes, config)
        send_payload = payload if digest not in self.sent_digests else None
        for w, conn in enumerate(self.pipes):
            conn.send((digest, send_payload, units[w::self.n]))
        self.sent_digests = {digest}
        results = [None] * len(units)
        for w, conn in enumerate(self.pipes):
            res = conn.recv()
            if isinstance(res, tuple) and res and res[0] == "err":
                raise RuntimeError(res[1])
            for k, r in zip(range(w, len(units), self.n), res):
                results[k] = r
        return results

    def run_file(self, gen, gen_seq_bytes, config, ests_path,
                 fresh=False):
        """Like run(), but each worker parses ests.txt itself and
        preprocesses only its own records, so no sequence bytes cross
        the pipe and the parent does no EST work.  Workers claim records
        dynamically off a shared atomic counter when available (static
        round-robin otherwise); reassembly is by record index, so the
        output is byte-identical to the sequential order either way.
        ``fresh`` makes each worker wipe its persistent caches first
        (fresh-locus benchmark mode)."""
        payload = (gen, gen_seq_bytes, config)
        digest = self._digest(gen, gen_seq_bytes, config)
        send_payload = payload if digest not in self.sent_digests else None
        claim = self.claim_addr if self._dynamic_ok() else None
        if claim is not None:
            import struct
            struct.pack_into("q", self.claim_mm, 0, 0)
        for w, conn in enumerate(self.pipes):
            conn.send((digest, send_payload,
                       ("file", ests_path, w, self.n, fresh, claim)))
        self.sent_digests = {digest}
        per_worker = []
        for conn in self.pipes:
            res = conn.recv()
            if isinstance(res, tuple) and res and res[0] == "err":
                raise RuntimeError(res[1])
            per_worker.append(res)
        total = sum(len(r) for r in per_worker)
        results = [None] * total
        for res in per_worker:
            for rec, blobs in res:
                if rec >= total or results[rec] is not None:
                    raise RuntimeError("inconsistent record claims")
                results[rec] = blobs
        if any(r is None for r in results):
            raise RuntimeError("missing record results")
        return results

    def _dynamic_ok(self) -> bool:
        """Dynamic claiming requires the native whole-run worker; the
        gates are environment/machine-level, identical in parent and
        (forked) workers, so deciding here is safe."""
        if self.claim_addr is None or not _native_gates():
            return False
        import os
        if os.environ.get("PINTRON_NO_NATIVE_WORKER") \
                or os.environ.get("PINTRON_STATIC_UNITS"):
            return False
        from pintron_tpu_torch.native import get_lib
        lib = get_lib()
        return lib is not None and hasattr(lib, "worker_run")

    def shutdown(self) -> None:
        for conn in self.pipes:
            try:
                conn.send(None)
                conn.close()
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=1)


_POOL = None

# single-slot suffix-tree cache for the sequential (no-pool) path,
# keyed by the genomic bytes (one locus at a time, like the workers)
_SEQ_TREE_CACHE = None


def _drop_pool_after_fork() -> None:
    """A forked child must never talk to the parent's pool: the worker
    processes are not its children and the pipe fds are shared.  Drop
    the reference so the child builds its own pool on first use."""
    global _POOL
    _POOL = None


import os as _os  # noqa: E402

_os.register_at_fork(after_in_child=_drop_pool_after_fork)


def _get_pool(nworkers: int):
    global _POOL
    if _POOL is not None and (_POOL.n != nworkers or not _POOL.alive()):
        _POOL.shutdown()
        _POOL = None
    if _POOL is None:
        _POOL = _PersistentPool(nworkers)
    return _POOL


def _process_unit(unit: List[mf.EstInfo]) -> Tuple[str, str, str, str, str,
                                                   str]:
    """Process one independent EST unit (a fixed-strand EST alone, or a
    forward EST followed by its reverse-complement copy) and return the
    text each output file receives, in (raw, megs, processed-megs,
    megs-info, processed-ests, meg-edges) order.  Mirrors the sequential
    loop of main-est-fact.c:247-291: the RC copy is skipped when the
    forward strand aligned."""
    import io
    gen, tree, gen_seq_bytes, config = _WORKER_CTX
    native = _native_unit_process(unit, gen, tree, gen_seq_bytes, config)
    if native is not None:
        return native
    f_out = io.StringIO()
    fmeg = io.StringIO()
    fpmeg = io.StringIO()
    ftmeg = io.StringIO()
    f_est_out = io.StringIO()
    fintronic = io.StringIO()
    k = 0
    is_reverse = False
    while k < len(unit):
        est = unit[k]
        factorized = compute_est_fact(gen, est, tree, gen_seq_bytes,
                                      config, fmeg, fpmeg, ftmeg,
                                      fintronic)
        if factorized.factorizations:
            write_multifasta_output(gen, factorized, f_out,
                                    config.retain_externals)
            f_est_out.write(f">{est.est_id}\n{est.original_seq}\n")
            if not est.fixed_strand and not is_reverse:
                k += 1  # forward aligned: skip its reverse copy
            is_reverse = False
        else:
            if is_reverse or est.fixed_strand:
                is_reverse = False
            else:
                is_reverse = True
        k += 1
    return (f_out.getvalue(), fmeg.getvalue(), fpmeg.getvalue(),
            ftmeg.getvalue(), f_est_out.getvalue(), fintronic.getvalue())



def run_est_fact(workdir: str = ".", config: Optional[Config] = None,
                 log=lambda *a: None, device="cuda") -> None:
    """The est-fact stage entry point (main-est-fact.c:90-339).

    ``device`` is ``"cuda"`` (the default), ``"cuda:N"``, ``"cpu"`` or
    ``"host"`` (see the module docstring); ``"cuda"`` raises when no
    CUDA device is available.  With a torch device and the device
    service set (``PINTRON_TORCH_SERVICE``) the batches go to the
    service, and a locus of at least ``FORK_MIN_RECORDS`` records is
    sharded over ``PINTRON_EST_WORKERS`` fork workers (default: one per
    core); ``PINTRON_DEVICE_{KBAND,NW,GAP,RB}`` route each family (see
    the module docstring; a value other than unset, ``1``, ``0`` or
    ``auto`` raises ValueError here).  With ``"host"`` the units run on
    the fork pool of ``PINTRON_EST_WORKERS`` workers (sequentially with
    one)."""
    for var, use in (("PINTRON_DEVICE", "the `device` argument"),
                     ("PINTRON_DEVICE_MESH", offload.MESH_ENV)):
        if os.environ.get(var):
            raise RuntimeError(f"{var} is set: it is the JAX package's "
                               f"switch.  Unset it; the port uses {use}")
    routes = offload.family_routes()
    host = offload.is_host(device)
    if not host:
        device = offload.use_device(device)
        _native_lib()

    sys.setrecursionlimit(1_000_000)
    from pintron_tpu_torch.runtime import (TimerRegistry, log_info_extended,
                                           resource_usage_log)
    from pintron_tpu_torch.utils import write_text
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

    with timers["io"], timing.span("pintron_est_io"):
        with open(wpath("genomic.txt")) as fh:
            gen_list = mf.read_multifasta(fh)
        if len(gen_list) != 1:
            raise ValueError(f"genomic.txt holds {len(gen_list)} records, "
                             "expected 1")
        gen = gen_list[0]
        mf.parse_genomic_header(gen)
        mf.ntails_removal(gen)
    checkpoint("ests-read-and-preprocessed")
    gen_seq_bytes = gen.seq.encode("latin1")

    checkpoint("alignment-begin")
    timers["algorithm"].start()
    nworkers = (int(os.environ.get("PINTRON_EST_WORKERS", "0"))
                or (os.cpu_count() or 1))
    # Fresh-locus benchmark mode: wipe the persistent result memo and
    # rebuild the index each run, so repeated runs on the same input
    # measure fresh work instead of cache hits.
    fresh = bool(os.environ.get("PINTRON_FRESH_MEMO"))
    if host:
        results = _run_host(gen, gen_seq_bytes, config, wpath("ests.txt"),
                            nworkers, fresh)
    else:
        results = _run_device(gen, gen_seq_bytes, config, wpath("ests.txt"),
                              nworkers, fresh, device, routes)
    timers["algorithm"].stop()
    checkpoint("alignment-end")

    with timers["io"], timing.span("pintron_est_io"):
        for k, name in enumerate(OUTPUT_NAMES):
            write_text(wpath(name), "".join(r[k] for r in results))
    checkpoint("output-written")
    timers.log_all()
    resource_usage_log(level=logging.DEBUG)


def _run_host(gen: mf.EstInfo, gen_seq_bytes: bytes, config: Config,
              ests_path: str, nworkers: int, fresh: bool):
    """The host path: the units on the fork pool, or sequentially."""
    global _SEQ_TREE_CACHE
    results = None
    if nworkers > 1:
        # Pooled path: workers parse ests.txt themselves and preprocess
        # only their own records (one record = one independent work
        # unit — a fixed-strand EST alone, or a forward EST plus its RC
        # copy).  Units never share state (the genomic index is
        # read-only), so they are the data-parallel axis.
        try:
            results = _get_pool(nworkers).run_file(
                gen, gen_seq_bytes, config, ests_path, fresh=fresh)
        except (ValueError, OSError, RuntimeError):
            results = None  # pool unavailable: fall through to sequential
    if results is None:
        cached = _SEQ_TREE_CACHE
        if fresh or cached is None or cached[0] != gen_seq_bytes:
            _SEQ_TREE_CACHE = (gen_seq_bytes, SuffixTree(gen_seq_bytes))
        tree = _SEQ_TREE_CACHE[1]
        results = [blobs for _rec, blobs in
                   _run_units(gen, tree, gen_seq_bytes, config, ests_path,
                              0, 1, fresh=fresh)]
    return results


def _run_device(gen: mf.EstInfo, gen_seq_bytes: bytes, config: Config,
                ests_path: str, nworkers: int, fresh: bool,
                device: "torch.device", routes: dict):
    """The device flow, in this process or sharded over fork workers
    through the service; logs the ``est-fact device flow:`` line, with
    each family's route and the tuner's latches after the run."""
    dp_census_reset()
    cells0 = offload.STATS["device_cells"]
    with open(ests_path) as fh:
        n_records = sum(1 for line in fh if line.startswith(">"))
    with timing.span("pintron_est_index"):
        tree = SuffixTree(gen_seq_bytes)
    sharded = (offload.service_socket() is not None and nworkers > 1
               and n_records >= FORK_MIN_RECORDS)
    if sharded:
        # host cascade on every core, device batches merged on the
        # service; small loci skip the forks, whose fixed cost (fork,
        # pipes, result pickling) exceeds the work they would share
        results, host_cells = _run_units_device_forked(
            gen, tree, gen_seq_bytes, config, ests_path, fresh, nworkers)
    else:
        results = [blobs for _i, blobs in _run_units_worker(
            gen, tree, gen_seq_bytes, config, ests_path, fresh, 0, 1)]
        host_cells = dp_census() or {}
    dev_cells = offload.STATS["device_cells"] - cells0
    total = dev_cells + sum(host_cells.values())
    logging.getLogger("pintron").info(
        "est-fact device flow: %s", json.dumps(
            {"device": str(offload.service_device() or device),
             "service": offload.service_socket(),
             "workers": nworkers if sharded else 1,
             # with a service, the service's own environment decides
             "mesh": None if offload.service_socket() else offload.mesh_size(),
             "stats": offload.STATS, "launches": limits.LAUNCHES,
             "host_dp_cells": host_cells,
             "routes": routes, "latches": offload.latches(),
             "device_cell_share": dev_cells / total if total else 0.0},
            sort_keys=True))
    return results
