"""Intron agreement (STEP 4) with its device sites on a torch device.

The port's counterpart of ``pintron_tpu.stages.intron_agreement``,
whose device call sites (``PINTRON_DEVICE=1``) import the JAX offload.
``run_intron_agreement(workdir, device)`` with a device (``"cuda"``,
``"cuda:N"`` or ``"cpu"``) runs a copy of the reference's stage
(intron_agreement.py:602-890) that differs at the two device sites
only:

  * the branch-point sweep: every registry intron's BPS windows are
    scored in one batch per matrix (``pwm_kernel`` on a GPU) and made
    exact on the host (``pintron_tpu_torch.factorize.classify``);
  * the predicted-introns edit stats: every (intron, supporting EST)
    pair's two window distances in one batch (``edit_score_kernel``
    through ``offload.eval_edit_batch``).

A failed batch raises; only a batch cut short by the wedge latch leaves
its work to the host path, which gives the same bytes.  Every helper is
imported from the reference module.  ``device=None`` runs the
reference's stage itself.  The stage logs one line,
``intron-agreement device flow: {...}``, with the offload counters
(``pwm_windows``, ``edit_problems``) and the kernel launches.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Tuple

import pintron_tpu.factorize.classify as _cl
import pintron_tpu.stages.intron_agreement as _ref
from pintron_tpu.factorize.alignments import edit_distance
from pintron_tpu.factorize.seq_util import real_substring
from pintron_tpu.io import multifasta as mf
from pintron_tpu.io.multifasta import _atoi
from pintron_tpu.stages.est_fact import (FactorizedEst,
                                         write_multifasta_output)
from pintron_tpu.stages.intron_agreement import (
    GenomicIntron, Intron, IntronRegistry, _GiIndex, find_better_intron,
    get_abs_region_start_end, get_intron_composition, get_repeat_sequence,
    set_agree_flags, try_agreement, try_agreement_to_intron_list,
    try_agreement_to_intron_list_on_single_site)
from pintron_tpu.stages.min_factorization import (EstFactorizations,
                                                  read_factorizations)
from pintron_tpu_torch.factorize.classify import precompute_bps_device
from pintron_tpu_torch.ops import kband, offload


def run_intron_agreement(workdir: str = ".", device=None) -> None:
    """The stage entry point.  ``device=None`` runs pintron_tpu's host
    stage; with a device the BPS sweep and the edit stats run there
    (``"cuda"`` raises when no CUDA device is available, unless the
    batches go to the device service)."""
    if os.environ.get("PINTRON_DEVICE"):
        raise RuntimeError(
            "PINTRON_DEVICE is set: pintron_tpu would run its JAX device "
            "sites.  Unset it; the port selects its device with the "
            "`device` argument")
    if device is None:
        _ref.run_intron_agreement(workdir)
        return
    device = offload.use_device(device)
    stats0 = dict(offload.STATS)
    launches0 = dict(kband.LAUNCHES)
    _run_device(workdir)
    logging.getLogger("pintron").info(
        "intron-agreement device flow: %s", json.dumps(
            {"device": str(offload.service_device() or device),
             "service": offload.service_socket(),
             "stats": {k: offload.STATS[k] - stats0[k] for k in stats0},
             "launches": {k: kband.LAUNCHES[k] - launches0[k]
                          for k in launches0}},
            sort_keys=True))


def _run_device(workdir: str) -> None:
    """The reference's ``run_intron_agreement``
    (main-intron-agreement.c:58-956) with its two device sites on the
    port's offload."""

    def wpath(name):
        return os.path.join(workdir, name)

    with open(wpath("genomic.txt")) as fh:
        gen_list = mf.read_multifasta(fh)
    gen = gen_list[0]
    mf.parse_genomic_header(gen)
    # note: NO N-tail removal in this stage

    with open(wpath("processed-ests.txt")) as fh:
        estinfo_list = mf.read_multifasta(fh)
    with open(wpath("out-agree.txt")) as fh:
        ests = read_factorizations(fh)

    gen_seq = gen.seq
    gen_length = len(gen_seq)
    registry: List[GenomicIntron] = IntronRegistry()

    # attach EST infos and build intron compositions (first record with a
    # given id wins, like the reference's linear scan)
    first_by_id = {}
    for ei in estinfo_list:
        first_by_id.setdefault(ei.est_id, ei)
    compositions: List[Tuple[EstFactorizations, List[Intron], mf.EstInfo]] = []
    for est in ests:
        info = first_by_id.get(est.est_id)
        if info is not None:
            mf.set_est_gb_identification(info)
        assert info is not None
        exon_composition = est.factorizations[0]
        composition = get_intron_composition(info, gen_length, gen_seq,
                                             exon_composition, registry)
        compositions.append((est, composition, info))

    # classify the registry: every intron's BPS sweep in one device
    # batch per matrix (exact through the f64 finish); classify reads
    # the overrides through exists_good_bps
    _cl.classify_genomic_intron_start_end.cache_clear()
    if registry:
        n = precompute_bps_device(gen_seq,
                                  [(gi.start, gi.end) for gi in registry])
        if n is None:
            # a batch cut short by the wedge latch: un-pin the override
            # table, and the host path classifies every intron
            _cl._BPS_OVERRIDE_GEN = None
    for gi in registry:
        (gi.type, gi.score5, gi.score3, gi.BPS_position, gi.BPS_score) = \
            _cl.classify_genomic_intron_start_end(gen_seq, gi.start,
                                                 gi.end)
        gi.classified = True

    # agree flags + per-priority intron lists
    refseq_list: List[Intron] = []
    canonical_list: List[Intron] = []
    agreement_list: List[Intron] = []
    for est, composition, info in compositions:
        for intron in composition:
            set_agree_flags(intron)
            if intron.agree_type <= intron.gen_intron.agree_type:
                intron.gen_intron.agree_type = intron.agree_type
            if intron.is_real:
                if intron.agree_type == 0:
                    refseq_list.append(intron)
                elif intron.agree_type == 1:
                    canonical_list.append(intron)
                else:
                    agreement_list.append(intron)

    genomic_refseq_list = [gi for gi in registry if gi.agree_type == 0]
    genomic_canonical_list = [gi for gi in registry if gi.agree_type == 1]
    genomic_agreement_list = [gi for gi in registry
                              if gi.agree_type not in (0, 1)]

    # static coordinate-window indexes over the (fixed) per-priority
    # genomic lists; registry start/end never change during the waterfall
    if os.environ.get("PINTRON_NO_GI_INDEX"):
        ix_ref = ix_can = ix_agr = None
    else:
        ix_ref = _GiIndex(genomic_refseq_list)
        ix_can = _GiIndex(genomic_canonical_list)
        ix_agr = _GiIndex(genomic_agreement_list)

    # waterfall: canonical -> refseq
    for intron in canonical_list:
        try_agreement_to_intron_list(gen_seq, intron, genomic_refseq_list,
                                     0, index=ix_ref)

    # canonical -> better-Burset canonical
    for intron in canonical_list:
        if not intron.agreed:
            freq_from = intron.gen_intron.burset_frequency
            if ix_can is not None:
                s0 = intron.gen_intron.start
                e0 = intron.gen_intron.end
                gi_iter = (genomic_canonical_list[k]
                           for k in ix_can.window_and(s0, e0, 12))
            else:
                gi_iter = iter(genomic_canonical_list)
            for gi in gi_iter:
                if (gi.start != intron.gen_intron.start
                        or gi.end != intron.gen_intron.end):
                    if gi.burset_frequency > freq_from:
                        if try_agreement(gen_seq, intron, gi, 0):
                            break

    # others -> refseq/canonical (err 4), then single-site
    agreed_list: List[Intron] = []
    not_agreed_list: List[Intron] = []
    for intron in agreement_list:
        ok = try_agreement_to_intron_list(gen_seq, intron,
                                          genomic_refseq_list, 4,
                                          index=ix_ref)
        if not ok:
            ok = try_agreement_to_intron_list(gen_seq, intron,
                                              genomic_canonical_list, 4,
                                              index=ix_can)
            if ok:
                agreed_list.append(intron)
            else:
                ok = try_agreement_to_intron_list_on_single_site(
                    gen_seq, intron, genomic_refseq_list, registry,
                    index=ix_ref)
                if not ok:
                    ok = try_agreement_to_intron_list_on_single_site(
                        gen_seq, intron, genomic_canonical_list, registry,
                        index=ix_can)
                    if ok:
                        agreed_list.append(intron)
                    else:
                        not_agreed_list.append(intron)
                else:
                    agreed_list.append(intron)
        else:
            agreed_list.append(intron)

    # others -> better-Burset others
    final_not_agreed: List[Intron] = []
    for intron in not_agreed_list:
        freq_from = intron.gen_intron.burset_frequency
        ok = False
        if ix_agr is not None:
            s0 = intron.gen_intron.start
            e0 = intron.gen_intron.end
            gi_iter = (genomic_agreement_list[k]
                       for k in ix_agr.window_and(s0, e0, 12))
        else:
            gi_iter = iter(genomic_agreement_list)
        for gi in gi_iter:
            if (gi.start != intron.gen_intron.start
                    or gi.end != intron.gen_intron.end):
                if gi.burset_frequency > freq_from:
                    if gi.supportingESTs > 0:
                        ok = try_agreement(gen_seq, intron, gi, 4)
                        if ok:
                            break
        if ok:
            agreed_list.append(intron)
        else:
            final_not_agreed.append(intron)

    # local ±3nt Burset repair
    for intron in final_not_agreed:
        find_better_intron(gen_seq, intron, registry)

    # output: rebuild exon compositions, collect supporting-EST info
    gen.pref_N_length = 0
    with open(wpath("out-after-intron-agree.txt"), "w") as f_out:
        for est, composition, info in compositions:
            exon_composition = []
            head = composition.pop(0)
            for intron in composition:
                exon_composition.append(intron.donor)
                if intron.is_real:
                    intron.gen_intron.info.append((info, intron.donor.est_end))
            # write with the est-fact writer semantics (retain externals)
            fe = FactorizedEst(info)
            fe.factorizations = [exon_composition]
            fe.polya_signals = [est.polya[0]]
            fe.polyadenil_signals = [est.polyadenil[0]]
            write_multifasta_output(gen, fe, f_out, True)

    strand = _atoi(gen.strand_as_read or "")

    registry_sorted = sorted(registry, key=lambda g: (g.start, g.end))

    # every intron's donor/acceptor edit-error stats in one device batch:
    # two independent <= 15 nt window edit distances per (intron,
    # supporting EST) pair (main-intron-agreement.c:804-904).  Exact:
    # the device computes the host edit_distance's recurrence.  A
    # wedged device (None) leaves edit_memo empty and the loop below
    # computes each pair on the host.
    edit_memo = None
    pairs = []
    for gi in registry_sorted:
        if not gi.info:
            continue
        d_sfx = real_substring(gi.start - 15, 15, gen_seq).encode("latin1")
        a_pfx = real_substring(gi.end + 1, 15, gen_seq).encode("latin1")
        for einfo, est_cut in gi.info:
            pairs.append((d_sfx, real_substring(est_cut + 1 - 15, 15,
                                                einfo.seq).encode("latin1")))
            pairs.append((a_pfx, real_substring(est_cut + 1, 15,
                                                einfo.seq).encode("latin1")))
    if pairs:
        dists = offload.eval_edit_batch(pairs)
        if dists is not None:
            edit_memo = iter(dists.tolist())

    with open(wpath("predicted-introns.txt"), "w") as gtf_out:
        first_time = True
        for gi in registry_sorted:
            if not gi.info:
                continue
            if not first_time:
                gtf_out.write("\n")
            first_time = False
            gtf_out.write(f"{gi.start + 1}\t{gi.end + 1}\t")
            if gen.abs_start < gen.abs_end:
                abs_start, abs_end = get_abs_region_start_end(
                    gen.abs_start, gen.abs_end, strand, gi.start + 1,
                    gi.end + 1)
            else:
                abs_start, abs_end = get_abs_region_start_end(
                    gen.abs_end, gen.abs_start, strand, gi.start + 1,
                    gi.end + 1)
            gtf_out.write(f"{abs_start}\t{abs_end}\t")
            gtf_out.write(f"{gi.end - gi.start + 1}\t")
            gtf_out.write(f"{len(gi.info)}\t")

            repeat = get_repeat_sequence(gen_seq, gi.start, gi.end)
            donor_suffix = real_substring(gi.start - 15, 15, gen_seq)
            acceptor_prefix = real_substring(gi.end + 1, 15, gen_seq)
            intron_prefix = real_substring(gi.start, 20, gen_seq)
            intron_suffix = real_substring(gi.end - 20 + 1, 20, gen_seq)

            tot_donor_edit = 0
            tot_acceptor_edit = 0
            for einfo, est_cut in gi.info:
                gtf_out.write(f"{einfo.gb},")
                if edit_memo is not None:
                    tot_donor_edit += next(edit_memo)
                    tot_acceptor_edit += next(edit_memo)
                    continue
                donor_EST_suffix = real_substring(est_cut + 1 - 15, 15,
                                                  einfo.seq)
                acceptor_EST_prefix = real_substring(est_cut + 1, 15,
                                                     einfo.seq)
                tot_donor_edit += edit_distance(donor_suffix,
                                                donor_EST_suffix)
                tot_acceptor_edit += edit_distance(acceptor_prefix,
                                                   acceptor_EST_prefix)
            mean_donor = tot_donor_edit / len(gi.info)
            mean_acceptor = tot_acceptor_edit / len(gi.info)
            gtf_out.write(f"\t{mean_donor:f}\t{mean_acceptor:f}\t")
            gtf_out.write(f"{gi.score5:f}\t{gi.score3:f}\t")
            gtf_out.write(f"{gi.BPS_score:f}\t{gi.BPS_position}\t")
            gtf_out.write(f"{gi.type}\t")
            gtf_out.write(f"{gi.donor_pt}{gi.acceptor_pt}\t")
            gtf_out.write(f"{repeat if repeat is not None else '.'}\t")
            gtf_out.write(f"{donor_suffix}\t")
            gtf_out.write(f"{intron_prefix}\t")
            gtf_out.write(f"{intron_suffix}\t")
            gtf_out.write(f"{acceptor_prefix}")
