"""Stage 4: intron prediction and agreement, with its two device sites
on a torch device.

Rebuild of intron-agreement (main-intron-agreement.c, agree-introns.c).
Builds the genomic-intron registry from per-EST exon compositions,
classifies introns (PWM), then runs the agreement waterfall that snaps
weak introns onto RefSeq/canonical/better-Burset introns, rewriting exon
bounds and EST alignments.  Emits `out-after-intron-agree.txt` and
`predicted-introns.txt`.

The port's copy of ``pintron_tpu.stages.intron_agreement``.
``run_intron_agreement(workdir, device)`` with a torch device
(``"cuda"``, the default, ``"cuda:N"`` or ``"cpu"``) runs its two device
sites there:

  * the branch-point sweep: every registry intron's BPS windows are
    scored in one batch per matrix (``pwm_kernel`` on a GPU) and made
    exact on the host (``pintron_tpu_torch.factorize.classify``);
  * the predicted-introns edit stats: every (intron, supporting EST)
    pair's two window distances in one batch (``edit_score_kernel``
    through ``offload.eval_edit_batch``).

A failed or timed-out batch raises: no host path stands in for it.
With ``device="host"`` both sites run on the host, as the JAX package's
default mode does.  With a device the stage logs one line,
``intron-agreement device flow: {...}``, with the offload counters
(``pwm_windows``, ``edit_problems``) and the kernel launches.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, TextIO, Tuple

from pintron_tpu_torch.factorize.alignments import (compute_alignment,
                                                    edit_distance)
from pintron_tpu_torch.factorize.burset import get_burset_frequency
from pintron_tpu_torch.factorize.classify import (
    classify_genomic_intron_start_end, precompute_bps_device)
from pintron_tpu_torch.factorize.gap_align import compute_gap_alignment
from pintron_tpu_torch.factorize.seq_util import real_substring
from pintron_tpu_torch.factorize.types import Factor
from pintron_tpu_torch.io import multifasta as mf
from pintron_tpu_torch.io.multifasta import _atoi
from pintron_tpu_torch.ops import limits, offload
from pintron_tpu_torch.stages.est_fact import (FactorizedEst,
                                               write_multifasta_output)
from pintron_tpu_torch.stages.min_factorization import (EstFactorizations,
                                                        read_factorizations)



class GenomicIntron:
    __slots__ = ("start", "end", "donor_pt", "acceptor_pt",
                 "burset_frequency", "info", "supportingESTs", "classified",
                 "agree_type", "type", "score5", "score3", "BPS_position",
                 "BPS_score")

    def __init__(self, start: int, end: int):
        self.start = start
        self.end = end
        self.donor_pt: Optional[str] = None
        self.acceptor_pt: Optional[str] = None
        self.burset_frequency = -1
        self.info: List[Tuple[mf.EstInfo, int]] = []
        self.supportingESTs = 0
        self.classified = False
        self.agree_type = 2
        self.type = 2
        self.score5 = 0.0
        self.score3 = 0.0
        self.BPS_position = -1
        self.BPS_score = 0.0


class Intron:
    __slots__ = ("donor", "acceptor", "gen_intron", "est_info", "is_real",
                 "try_agree", "agreed", "agree_type")

    def __init__(self):
        self.donor: Optional[Factor] = None
        self.acceptor: Optional[Factor] = None
        self.gen_intron: Optional[GenomicIntron] = None
        self.est_info: Optional[mf.EstInfo] = None
        self.is_real = False
        self.try_agree = False
        self.agreed = False
        self.agree_type = 2


class IntronRegistry(list):
    """Registry list plus an exact (start, end) -> entry side index.
    The linear-scan lookup can never create coordinate duplicates, so
    the dict lookup is equivalent; plain lists still take the scan."""

    def __init__(self):
        super().__init__()
        self.by_coords: Dict[Tuple[int, int], GenomicIntron] = {}


def add_genomic_intron(gen_seq: str, registry: List[GenomicIntron],
                       start: int, end: int) -> GenomicIntron:
    """agree-introns.c:545-587: registry lookup or creation; NEW introns
    go to the HEAD of the registry (list order matters downstream)."""
    by = getattr(registry, "by_coords", None)
    if by is not None:
        gi = by.get((start, end))
        if gi is not None:
            gi.supportingESTs += 1
            return gi
    else:
        for gi in registry:
            if gi.start == start and gi.end == end:
                gi.supportingESTs += 1
                return gi
    gi = GenomicIntron(start, end)
    # set_pattern + set_intron_Burset_frequency; getBursetFrequency
    # UPPERCASES the stored patterns in place (refine-intron.c:To_upper)
    gi.donor_pt = real_substring(start, 2, gen_seq).upper()
    gi.acceptor_pt = real_substring(end - 1, 2, gen_seq).upper()
    gi.burset_frequency = get_burset_frequency(gi.donor_pt, gi.acceptor_pt)
    gi.supportingESTs = 1
    registry.insert(0, gi)
    if by is not None:
        by[(start, end)] = gi
    return gi


def get_intron_composition(info: mf.EstInfo, gen_length: int, gen_seq: str,
                           exon_composition: List[Factor],
                           registry: List[GenomicIntron]) -> List[Intron]:
    """agree-introns.c:436-543 (exon coords are converted from 1-based in
    place)."""
    composition: List[Intron] = []
    donor: Optional[Factor] = None
    start = -1
    acceptor: Optional[Factor] = None
    for acceptor in exon_composition:
        acceptor.est_start -= 1
        acceptor.est_end -= 1
        acceptor.gen_start -= 1
        acceptor.gen_end -= 1

        end = acceptor.gen_start - 1
        intron = Intron()
        intron.donor = donor
        intron.acceptor = acceptor
        if start >= 0 and end < gen_length:
            gi = add_genomic_intron(gen_seq, registry, start, end)
            intron.is_real = True
        else:
            gi = GenomicIntron(start, end)
            gi.type = 2
            intron.is_real = False
        intron.gen_intron = gi
        intron.est_info = info
        composition.append(intron)
        start = acceptor.gen_end + 1
        donor = acceptor

    last = Intron()
    gi = GenomicIntron(start, gen_length)
    gi.type = 2
    last.is_real = False
    last.gen_intron = gi
    last.est_info = info
    last.donor = acceptor
    last.acceptor = None
    composition.append(last)
    return composition


def set_agree_flags(intron: Intron) -> None:
    """agree-introns.c:366-414."""
    intron.try_agree = True
    intron.agreed = False
    intron.agree_type = 2
    if not intron.is_real:
        return
    gb = intron.est_info.gb or ""
    is_nm_or_nr = (len(gb) >= 3 and gb[0] == "N" and gb[2] == "_"
                   and gb[1] in ("M", "R"))
    if not is_nm_or_nr:
        dp = intron.gen_intron.donor_pt
        ap = intron.gen_intron.acceptor_pt
        if dp not in ("gt", "GT", "gc", "GC"):
            if dp in ("at", "AT"):
                if ap in ("ac", "AC"):
                    if intron.gen_intron.type != 2:
                        intron.agree_type = 1
        else:
            if ap in ("ag", "AG"):
                intron.agree_type = 1
    else:
        intron.try_agree = False
        intron.agree_type = 0


def get_intron_burset_frequency_start_end(gen_seq: str, start: int,
                                          end: int) -> int:
    donor_pt = real_substring(start, 2, gen_seq)
    acceptor_pt = real_substring(end - 1, 2, gen_seq)
    return get_burset_frequency(donor_pt, acceptor_pt)


def correct_est_alignment(gen_seq: str, intron: Intron) -> None:
    """agree-introns.c:769-856."""
    est_suffix_dim = 15
    est_prefix_dim = 15
    gen_suffix_dim = 20
    gen_prefix_dim = 20
    est_seq = intron.est_info.seq

    d = intron.donor
    a = intron.acceptor

    donor_suffix_start = d.est_end - est_suffix_dim
    if donor_suffix_start < d.est_start:
        donor_suffix_start = d.est_start
    donor_suffix_dim = d.est_end - donor_suffix_start + 1
    donor_EST_factor = real_substring(donor_suffix_start,
                                      d.est_end - donor_suffix_start + 1,
                                      est_seq)

    acceptor_prefix_end = a.est_start + est_prefix_dim
    if acceptor_prefix_end > a.est_end:
        acceptor_prefix_end = a.est_end
    acceptor_EST_factor = real_substring(
        a.est_start, acceptor_prefix_end - a.est_start + 1, est_seq)

    dg_start = d.gen_end - gen_suffix_dim
    if dg_start < d.gen_start:
        dg_start = d.gen_start
    donor_GEN_factor = real_substring(dg_start, d.gen_end - dg_start + 1,
                                      gen_seq)

    ag_end = a.gen_start + gen_prefix_dim
    if ag_end > a.gen_end:
        ag_end = a.gen_end
    acceptor_GEN_factor = real_substring(a.gen_start,
                                         ag_end - a.gen_start + 1, gen_seq)

    gen_window = donor_GEN_factor + "x" * 20 + acceptor_GEN_factor
    est_window = donor_EST_factor + acceptor_EST_factor
    al = compute_gap_alignment(est_window, gen_window)
    new_donor_EST_end = d.est_end - donor_suffix_dim + al.factor_cut
    d.est_end = new_donor_EST_end
    a.est_start = new_donor_EST_end + 1


def get_agreement_error_start_end(gen_seq: str, intron_from: Intron,
                                  gen_start: int, gen_end: int) -> int:
    """agree-introns.c:600-767."""
    est_seq = intron_from.est_info.seq
    gi = intron_from.gen_intron

    if gi.start > gen_start:
        diff = gi.start - gen_start
        d = intron_from.donor
        donor_EST_end = d.est_end
        donor_EST_suffix_start = donor_EST_end - 3 * diff
        if donor_EST_suffix_start < d.est_start:
            donor_EST_suffix_start = d.est_start
        donor_EST_suffix = real_substring(
            donor_EST_suffix_start,
            donor_EST_end - donor_EST_suffix_start + 1, est_seq)
        donor_GEN_end = gi.start - 1
        donor_GEN_suffix_start = donor_GEN_end - 3 * diff
        if donor_GEN_suffix_start < d.gen_start:
            donor_GEN_suffix_start = d.gen_start
        donor_GEN_suffix = real_substring(
            donor_GEN_suffix_start,
            donor_GEN_end - donor_GEN_suffix_start + 1, gen_seq)
        al = compute_alignment(donor_EST_suffix, donor_GEN_suffix)
        out = []
        i = 0
        k = 1
        dim = al.dim
        while i < dim and k <= diff:
            if al.est[dim - i - 1] != "-":
                out.append(al.est[dim - i - 1])
            if al.gen[dim - i - 1] != "-":
                k += 1
            i += 1
        donor_seq_reduced = "".join(reversed(out))
    else:
        donor_seq_reduced = ""

    donor_seq_reducing = real_substring(
        gi.start, gen_start - gi.start if gen_start > gi.start else 0,
        gen_seq)

    if gi.end < gen_end:
        diff = gen_end - gi.end
        a = intron_from.acceptor
        acceptor_EST_start = a.est_start
        acceptor_EST_prefix_end = acceptor_EST_start + 3 * diff
        if acceptor_EST_prefix_end > a.est_end:
            acceptor_EST_prefix_end = a.est_end
        acceptor_EST_prefix = real_substring(
            acceptor_EST_start,
            acceptor_EST_prefix_end - acceptor_EST_start + 1, est_seq)
        acceptor_GEN_start = gi.end + 1
        acceptor_GEN_prefix_end = acceptor_GEN_start + 3 * diff
        if acceptor_GEN_prefix_end > a.gen_end:
            acceptor_GEN_prefix_end = a.gen_end
        acceptor_GEN_prefix = real_substring(
            acceptor_GEN_start,
            acceptor_GEN_prefix_end - acceptor_GEN_start + 1, gen_seq)
        al = compute_alignment(acceptor_EST_prefix, acceptor_GEN_prefix)
        out = []
        i = 0
        k = 1
        while i < al.dim and k <= diff:
            if al.est[i] != "-":
                out.append(al.est[i])
            if al.gen[i] != "-":
                k += 1
            i += 1
        acceptor_seq_reduced = "".join(out)
    else:
        acceptor_seq_reduced = ""

    acceptor_seq_reducing = real_substring(
        gen_end + 1, gi.end - gen_end if gi.end > gen_end else 0, gen_seq)

    seq_reduced = donor_seq_reduced + acceptor_seq_reduced
    seq_reducing = donor_seq_reducing + acceptor_seq_reducing
    return edit_distance(seq_reduced, seq_reducing)


def try_agreement(gen_seq: str, intron_from: Intron,
                  gen_intron_to: GenomicIntron, allowed_error: int) -> bool:
    """agree-introns.c:90-129."""
    reducing_range = 12
    start_diff = abs(intron_from.gen_intron.start - gen_intron_to.start)
    end_diff = abs(intron_from.gen_intron.end - gen_intron_to.end)
    if start_diff < reducing_range and end_diff < reducing_range:
        if (intron_from.donor.gen_start < gen_intron_to.start
                and intron_from.acceptor.gen_end > gen_intron_to.end):
            error = get_agreement_error_start_end(
                gen_seq, intron_from, gen_intron_to.start, gen_intron_to.end)
            if error <= allowed_error:
                intron_from.agreed = True
                intron_from.gen_intron.supportingESTs -= 1
                intron_from.gen_intron = gen_intron_to
                intron_from.gen_intron.supportingESTs += 1
                intron_from.donor.gen_end = gen_intron_to.start - 1
                intron_from.acceptor.gen_start = gen_intron_to.end + 1
                correct_est_alignment(gen_seq, intron_from)
                return True
    return False


class _GiIndex:
    """Coordinate-window index over a FIXED genomic-intron list.

    try_agreement can only succeed when |start - s| < 12 and
    |end - e| < 12 (agree-introns.c:90-99), and the single-site variant
    when |start - s| < 16 or |end - e| < 16; registry entries' start/end
    never change during the agreement waterfall, so a static sorted
    index answers "which list positions could match" exactly.  Matches
    are returned in ascending list position, preserving the scan's
    first-success semantics (skipped entries are guaranteed failures,
    which are side-effect-free)."""

    __slots__ = ("glist", "starts", "ends")

    def __init__(self, glist: List[GenomicIntron]):
        self.glist = glist
        self.starts = sorted((gi.start, k) for k, gi in enumerate(glist))
        self.ends = sorted((gi.end, k) for k, gi in enumerate(glist))

    def _range(self, arr, v, rng):
        import bisect
        lo = bisect.bisect_left(arr, (v - rng + 1, -1))
        hi = bisect.bisect_right(arr, (v + rng - 1, 1 << 62))
        return arr[lo:hi]

    def window_and(self, s: int, e: int, rng: int) -> List[int]:
        """positions with |start-s| < rng and |end-e| < rng, ascending"""
        g = self.glist
        return sorted(k for _v, k in self._range(self.starts, s, rng)
                      if abs(g[k].end - e) < rng)

    def window_or(self, s: int, e: int, rng: int) -> List[int]:
        """positions with |start-s| < rng or |end-e| < rng, ascending"""
        ks = {k for _v, k in self._range(self.starts, s, rng)}
        ks.update(k for _v, k in self._range(self.ends, e, rng))
        return sorted(ks)


def try_agreement_to_intron_list(gen_seq: str, intron_from: Intron,
                                 genomic_list: List[GenomicIntron],
                                 allowed_error: int,
                                 index: Optional[_GiIndex] = None) -> bool:
    if index is not None:
        s = intron_from.gen_intron.start
        e = intron_from.gen_intron.end
        for k in index.window_and(s, e, 12):
            gi = genomic_list[k]
            if gi.supportingESTs > 0:
                if try_agreement(gen_seq, intron_from, gi, allowed_error):
                    return True
        return False
    for gi in genomic_list:
        if gi.supportingESTs > 0:
            if try_agreement(gen_seq, intron_from, gi, allowed_error):
                return True
    return False


def _sort_burset_candidates(cands: List[Tuple[int, int, int]]
                            ) -> List[Tuple[int, int, int]]:
    """list_sort with burset_frequency_compare via glibc qsort (mergesort):
    the comparator never returns 0, so equal frequencies end up in REVERSE
    insertion order.  cands items are (start, end, freq)."""
    return [c for _, c in sorted(enumerate(cands),
                                 key=lambda t: (-t[1][2], -t[0]))]


def try_agreement_to_a_burset_frequency_list(gen_seq: str,
                                             intron_from: Intron,
                                             cands: List[Tuple[int, int, int]],
                                             registry: List[GenomicIntron],
                                             allowed_error: int) -> bool:
    """agree-introns.c:315-364."""
    for start, end, freq in cands:
        error = get_agreement_error_start_end(gen_seq, intron_from, start,
                                              end)
        donor_pt = real_substring(start, 2, gen_seq)
        acceptor_pt = real_substring(end - 1, 2, gen_seq)
        max_error = allowed_error
        if donor_pt not in ("GT", "gt", "GC", "gc"):
            if donor_pt not in ("AT", "at"):
                max_error = 0
            else:
                if acceptor_pt not in ("AC", "ac"):
                    max_error = 0
        else:
            if acceptor_pt not in ("AG", "ag"):
                max_error = 0
        if (intron_from.donor.gen_start < start
                and intron_from.acceptor.gen_end > end):
            if error <= max_error:
                intron_from.agreed = True
                new_gi = add_genomic_intron(gen_seq, registry, start, end)
                if not new_gi.classified:
                    (new_gi.type, new_gi.score5, new_gi.score3,
                     new_gi.BPS_position, new_gi.BPS_score) = \
                        classify_genomic_intron_start_end(gen_seq, start,
                                                          end)
                    new_gi.classified = True
                intron_from.gen_intron.supportingESTs -= 1
                intron_from.gen_intron = new_gi
                intron_from.donor.gen_end = new_gi.start - 1
                intron_from.acceptor.gen_start = new_gi.end + 1
                correct_est_alignment(gen_seq, intron_from)
                return True
    return False


def try_agreement_on_donor_site(gen_seq: str, intron_from: Intron,
                                gen_intron_to: GenomicIntron,
                                registry: List[GenomicIntron]) -> bool:
    """agree-introns.c:164-209."""
    cands = []
    cstart = gen_intron_to.start
    eq_start = cstart == intron_from.gen_intron.start
    reducing_range = 16
    cend = intron_from.gen_intron.end - reducing_range
    k = intron_from.gen_intron.end + reducing_range
    if k > intron_from.acceptor.gen_end:
        k = intron_from.gen_intron.end + (
            intron_from.acceptor.gen_end
            - intron_from.acceptor.gen_start + 1) // 2
    current_freq = -1
    if eq_start:
        current_freq = intron_from.gen_intron.burset_frequency
    while cend <= k:
        freq = get_intron_burset_frequency_start_end(gen_seq, cstart, cend)
        if freq > current_freq:
            cands.append((cstart, cend, freq))
        cend += 1
    cands = _sort_burset_candidates(cands)
    return try_agreement_to_a_burset_frequency_list(gen_seq, intron_from,
                                                    cands, registry, 2)


def try_agreement_on_acceptor_site(gen_seq: str, intron_from: Intron,
                                   gen_intron_to: GenomicIntron,
                                   registry: List[GenomicIntron]) -> bool:
    """agree-introns.c:211-256."""
    cands = []
    cend = gen_intron_to.end
    eq_end = cend == intron_from.gen_intron.end
    reducing_range = 16
    cstart = intron_from.gen_intron.start - reducing_range
    if cstart < intron_from.donor.gen_start:
        cstart = intron_from.gen_intron.start - (
            intron_from.donor.gen_end
            - intron_from.donor.gen_start + 1) // 2
    k = intron_from.gen_intron.start + reducing_range
    current_freq = -1
    if eq_end:
        current_freq = intron_from.gen_intron.burset_frequency
    while cstart <= k:
        freq = get_intron_burset_frequency_start_end(gen_seq, cstart, cend)
        if freq > current_freq:
            cands.append((cstart, cend, freq))
        cstart += 1
    cands = _sort_burset_candidates(cands)
    return try_agreement_to_a_burset_frequency_list(gen_seq, intron_from,
                                                    cands, registry, 2)


def try_agreement_on_single_site(gen_seq: str, intron_from: Intron,
                                 gen_intron_to: GenomicIntron,
                                 registry: List[GenomicIntron]) -> bool:
    start_diff = abs(intron_from.gen_intron.start - gen_intron_to.start)
    end_diff = abs(intron_from.gen_intron.end - gen_intron_to.end)
    reducing_range = 16
    ok = False
    if start_diff < reducing_range:
        ok = try_agreement_on_donor_site(gen_seq, intron_from,
                                         gen_intron_to, registry)
    if not ok and end_diff < reducing_range:
        ok = try_agreement_on_acceptor_site(gen_seq, intron_from,
                                            gen_intron_to, registry)
    return ok


def try_agreement_to_intron_list_on_single_site(gen_seq: str,
                                                intron_from: Intron,
                                                genomic_list,
                                                registry,
                                                index: Optional[_GiIndex]
                                                = None) -> bool:
    if index is not None:
        s = intron_from.gen_intron.start
        e = intron_from.gen_intron.end
        for k in index.window_or(s, e, 16):
            gi = genomic_list[k]
            if gi.supportingESTs > 0:
                if try_agreement_on_single_site(gen_seq, intron_from, gi,
                                                registry):
                    return True
        return False
    for gi in genomic_list:
        if gi.supportingESTs > 0:
            if try_agreement_on_single_site(gen_seq, intron_from, gi,
                                            registry):
                return True
    return False


def find_better_intron(gen_seq: str, intron_from: Intron,
                       registry: List[GenomicIntron]) -> bool:
    """agree-introns.c:258-310."""
    cands = []
    reducing_range = 3
    cstart0 = intron_from.gen_intron.start - reducing_range
    if cstart0 < intron_from.donor.gen_start:
        cstart0 = intron_from.gen_intron.start - (
            intron_from.donor.gen_end
            - intron_from.donor.gen_start + 1) // 2
    init_cend = intron_from.gen_intron.end - reducing_range
    k_start = intron_from.gen_intron.start + reducing_range
    k_end = intron_from.gen_intron.end + reducing_range
    if k_end > intron_from.acceptor.gen_end:
        k_end = intron_from.gen_intron.end + (
            intron_from.acceptor.gen_end
            - intron_from.acceptor.gen_start + 1) // 2
    current_freq = intron_from.gen_intron.burset_frequency
    cstart = cstart0
    while cstart <= k_start:
        cend = init_cend
        while cend <= k_end:
            freq = get_intron_burset_frequency_start_end(gen_seq, cstart,
                                                         cend)
            if freq > current_freq:
                cands.append((cstart, cend, freq))
            cend += 1
        cstart += 1
    cands = _sort_burset_candidates(cands)
    return try_agreement_to_a_burset_frequency_list(gen_seq, intron_from,
                                                    cands, registry, 0)


def get_abs_coord(gen_abs_start: int, gen_abs_end: int, strand: int,
                  coord: int) -> int:
    if strand == 1:
        return gen_abs_start + coord - 1
    return gen_abs_end - coord + 1


def get_abs_region_start_end(gen_abs_start, gen_abs_end, strand, start, end):
    if strand == 1:
        return (get_abs_coord(gen_abs_start, gen_abs_end, strand, start),
                get_abs_coord(gen_abs_start, gen_abs_end, strand, end))
    return (get_abs_coord(gen_abs_start, gen_abs_end, strand, end),
            get_abs_coord(gen_abs_start, gen_abs_end, strand, start))


def get_repeat_sequence(gen_seq: str, intron_left: int,
                        intron_right: int) -> Optional[str]:
    """classify-intron.c:GetRepeatSequence."""
    def g(idx):
        return gen_seq[idx] if 0 <= idx < len(gen_seq) else "\0"

    i = intron_left - 1
    while g(i) == g(intron_right - intron_left + i + 1):
        i -= 1
    five = None
    if intron_left - i - 1 > 0:
        five = real_substring(i + 1, intron_left - i - 1, gen_seq)
    i = intron_right + 1
    while g(i) == g(-intron_right + intron_left + i - 1):
        i += 1
    three = None
    if i - intron_right - 1 > 0:
        three = real_substring(intron_right + 1, i - intron_right - 1,
                               gen_seq)
    if five is None and three is None:
        return None
    return (five or "") + (three or "")




def run_intron_agreement(workdir: str = ".", device="cuda") -> None:
    """The stage entry point (main-intron-agreement.c:58-956).  With a
    torch device the BPS sweep and the edit stats run there (``"cuda"``
    raises when no CUDA device is available, unless the batches go to
    the device service); ``"host"`` runs both on the host."""
    if os.environ.get("PINTRON_DEVICE"):
        raise RuntimeError(
            "PINTRON_DEVICE is set: it is the JAX package's switch.  Unset "
            "it; the port selects its device with the `device` argument")
    if offload.is_host(device):
        _run(workdir, None)
        return
    device = offload.use_device(device)
    stats0 = dict(offload.STATS)
    launches0 = dict(limits.LAUNCHES)
    _run(workdir, device)
    logging.getLogger("pintron").info(
        "intron-agreement device flow: %s", json.dumps(
            {"device": str(offload.service_device() or device),
             "service": offload.service_socket(),
             "stats": {k: offload.STATS[k] - stats0[k] for k in stats0},
             "launches": {k: limits.LAUNCHES[k] - launches0[k]
                          for k in launches0}},
            sort_keys=True))


def _run(workdir: str, device) -> None:
    """The stage (main-intron-agreement.c:58-956), with its two device
    sites on the port's offload when ``device`` is a torch device (None:
    the host path)."""
    on_device = device is not None

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
    classify_genomic_intron_start_end.cache_clear()
    if on_device and registry:
        precompute_bps_device(gen_seq,
                              [(gi.start, gi.end) for gi in registry],
                              device)
    for gi in registry:
        (gi.type, gi.score5, gi.score3, gi.BPS_position, gi.BPS_score) = \
            classify_genomic_intron_start_end(gen_seq, gi.start, gi.end)
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
    # the device computes the host edit_distance's recurrence.
    edit_memo = None
    pairs = []
    for gi in (registry_sorted if on_device else ()):
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
        edit_memo = iter(offload.eval_edit_batch(pairs).tolist())

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
