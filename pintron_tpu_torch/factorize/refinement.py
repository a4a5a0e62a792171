"""Post-DP factorization refinement pass
(factorization-refinement.c:84-1306): validity/duplicate pruning,
lost-affix recovery, false-small-exon removal, new-small-exon discovery,
final cleaning.
"""

from __future__ import annotations

from typing import List, Optional

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.factorize.alignments import (compute_edit_distance,
                                              edit_distance_full)
from pintron_tpu_torch.factorize.burset import get_burset_frequency_adaptor
from pintron_tpu_torch.factorize.classify import (INTRON_ND,
                                            classify_genomic_intron_start_end)
from pintron_tpu_torch.factorize.filters import (add_if_not_exists,
                                           clean_external_exons,
                                           clean_noisy_exons)
from pintron_tpu_torch.factorize.refine import general_refine_borders, refine_borders
from pintron_tpu_torch.factorize.types import Factor, Factorization
import ctypes

from pintron_tpu_torch.native import get_lib

UB_VERY_SMALL_EXON_LENGTH = 2
LB_SMALL_EXON_LENGTH = 6
UB_SMALL_EXON_LENGTH = 23
UB_MED_EXON_LENGTH = 100
AFFIXES_LENGTH = 5
MAX_ERROR_RATE = 0.17
MIN_PERFECT_BORDER_LENGTH = 6
MAX_ERRORS_CONSIDERED_AS_SMALL = 2


def remove_factorizations_with_very_small_exons(
        factorizations: List[Factorization]) -> None:
    k = 0
    while k < len(factorizations):
        if any(f.est_end + 1 - f.est_start <= UB_VERY_SMALL_EXON_LENGTH
               for f in factorizations[k]):
            del factorizations[k]
        else:
            k += 1


def remove_invalid_factorizations(factorizations: List[Factorization]
                                  ) -> None:
    k = 0
    while k < len(factorizations):
        pfact = factorizations[k]
        invalid = False
        prev: Optional[Factor] = None
        for f in pfact:
            if f.est_start > f.est_end or f.gen_start > f.gen_end:
                invalid = True
                break
            if prev is not None and (prev.est_end >= f.est_start
                                     or prev.gen_end >= f.gen_start):
                invalid = True
                break
            prev = f
        if invalid:
            del factorizations[k]
        else:
            k += 1


def _fact_hash(pfact: Factorization) -> int:
    h = 1
    for f in pfact:
        shift = (f.est_start + f.est_end + f.gen_start + f.gen_end) % 32
        h = ((h >> shift) | (h << (32 - shift))) & 0xFFFFFFFF
    return h


def remove_duplicated_factorizations(factorizations: List[Factorization]
                                     ) -> None:
    """factorization-refinement.c:174-240 (rolling-hash prescreen, then a
    full check removing the LATER duplicate)."""
    members = 0
    has_possible = False
    for pfact in factorizations:
        h = _fact_hash(pfact)
        if members & h:
            has_possible = True
            break
        members |= h
    if not has_possible:
        return
    k1 = 0
    while k1 < len(factorizations):
        pf1 = factorizations[k1]
        dup = False
        for k2 in range(len(factorizations)):
            pf2 = factorizations[k2]
            if pf1 is pf2:
                break
            if len(pf1) != len(pf2):
                continue
            equal = all(
                a.est_start == b.est_start and a.est_end == b.est_end
                and a.gen_start == b.gen_start and a.gen_end == b.gen_end
                for a, b in zip(pf1, pf2))
            if equal:
                dup = True
                break
        if dup:
            del factorizations[k1]
        else:
            k1 += 1


import functools


@functools.lru_cache(maxsize=8)
def _enc(s: str) -> bytes:
    """Cached latin-1 encoding for the (large, repeatedly-sliced) genomic
    sequence; the LCF kernel takes (pointer, length), so a prefix is just
    a shorter length over the same bytes."""
    return s.encode("latin1")


def find_longest_common_factor_dp(s1: str, s2: str, s1_b: bytes = None,
                                  l1: int = None):
    """factorization-refinement.c:253-316 (Ns always match).
    Returns (occ1, occ2, length).  ``s1_b``/``l1`` optionally supply a
    pre-encoded buffer whose first ``l1`` bytes are s1 (avoids slicing
    and re-encoding genomic prefixes)."""
    # NOTE: the reference recurses when l2 > l1 but then falls through and
    # re-runs the DP with the original argument order, overwriting the
    # recursion's results — so the answer is always the plain DP below.
    if s1_b is None:
        l1 = len(s1)
        s1_b = None
    l2 = len(s2)
    if l1 == 0 or l2 == 0:
        return 0, 0, 0
    lib = get_lib()
    if lib is not None:
        occ1 = ctypes.c_int64()
        occ2 = ctypes.c_int64()
        if s1_b is None:
            s1_b = s1.encode("latin1")
        plen = lib.lcf_dp(s1_b, l1, s2.encode("latin1"), l2,
                          ctypes.byref(occ1), ctypes.byref(occ2))
        if plen >= 0:
            return int(occ1.value), int(occ2.value), int(plen)
    import numpy as np

    if s1_b is not None:
        a1 = np.frombuffer(s1_b[:l1], dtype=np.uint8)
    else:
        a1 = np.frombuffer(s1.encode("latin1"), dtype=np.uint8)
    a2 = np.frombuffer(s2.encode("latin1"), dtype=np.uint8)
    wild1 = (a1 == ord("n")) | (a1 == ord("N"))
    wild2 = (a2 == ord("n")) | (a2 == ord("N"))
    # match matrix (l1 x l2); one string is always short at call sites
    prev = np.zeros(l2, dtype=np.int32)
    curr = np.zeros(l2, dtype=np.int32)
    plen = 0
    occ1 = occ2 = 0
    for i1 in range(l1):
        m = (a2 == a1[i1]) | wild2 | wild1[i1]
        curr[0] = 1 if m[0] else 0
        curr[1:] = np.where(m[1:], prev[:-1] + 1, 0)
        row_max = int(curr.max()) if l2 else 0
        if row_max > plen:
            # first strictly-greater update in the reference's i1-major
            # scan: earliest i2 in this row achieving the new maximum
            plen = row_max
            i2 = int(np.argmax(curr == row_max))
            occ1 = i1 + 1 - plen
            occ2 = i2 + 1 - plen
        prev, curr = curr, prev
    return occ1, occ2, plen


def is_canonical_intron(gen_seq: str, intron_start: int,
                        intron_end: int) -> bool:
    def g(i):
        return gen_seq[i] if 0 <= i < len(gen_seq) else "\0"

    return ((g(intron_start) == "G" and g(intron_start + 1) == "T"
             and g(intron_end - 1) == "A" and g(intron_end) == "G")
            or (g(intron_start) == "g" and g(intron_start + 1) == "t"
                and g(intron_end - 1) == "a" and g(intron_end) == "g"))


def _classify(gen_seq: str, istart: int, iend: int) -> int:
    itype, _, _, _, _ = classify_genomic_intron_start_end(gen_seq, istart,
                                                          iend)
    return itype


def search_small_exon_at_prefix(p1: Factor, pfact: Factorization,
                                insert_at: int, gen_seq: str, est_seq: str,
                                config: Config) -> bool:
    """factorization-refinement.c:498-606.  Returns True if a new exon was
    inserted before position insert_at."""
    e1len = p1.est_end + 1 - p1.est_start
    g1len = p1.gen_end + 1 - p1.gen_start
    if (e1len + p1.est_start) < (LB_SMALL_EXON_LENGTH
                                 + UB_SMALL_EXON_LENGTH):
        return False
    eplen = min(min(p1.est_start, p1.gen_start), 2 * UB_SMALL_EXON_LENGTH)
    epfact = est_seq[p1.est_start - eplen:p1.est_start]

    e1plen = min(min(e1len, g1len), UB_SMALL_EXON_LENGTH)
    e1pfact = est_seq[p1.est_start:p1.est_start + e1plen]
    g1pfact = gen_seq[p1.gen_start:p1.gen_start + e1plen]

    pg, pe, cflen = find_longest_common_factor_dp(
        "", epfact, s1_b=_enc(gen_seq), l1=p1.gen_start)
    if cflen < LB_SMALL_EXON_LENGTH:
        return False
    edp = compute_edit_distance(e1pfact, g1pfact)
    allelen = min(p1.est_end + 1,
                  p1.est_start + UB_SMALL_EXON_LENGTH) - pe
    allglen = min(p1.gen_end + 1,
                  p1.gen_start + UB_SMALL_EXON_LENGTH) - pg
    ok, offset_p, offset_t1, offset_t2, new_ed = general_refine_borders(
        est_seq[pe:pe + allelen], LB_SMALL_EXON_LENGTH,
        allelen - LB_SMALL_EXON_LENGTH,
        gen_seq[pg:pg + allglen], edp)
    if not ok:
        return False
    if offset_t2 - offset_t1 < config.min_intron_length:
        return False
    if not is_canonical_intron(gen_seq, pg + offset_t1, pg + offset_t2 - 1):
        return False
    if offset_p - pe < LB_SMALL_EXON_LENGTH:
        return False
    pnew = Factor(pe, pe + offset_p - 1, pg, pg + offset_t1 - 1)
    p1.est_start = pe + offset_p
    p1.gen_start = pg + offset_t2
    pfact.insert(insert_at, pnew)
    return True


def search_small_exon(p1: Factor, p2: Factor, pfact: Factorization,
                      insert_at: int, gen_seq: str, est_seq: str,
                      config: Config) -> bool:
    """factorization-refinement.c:639-871.  Returns True if a new exon was
    inserted at insert_at (between p1 and p2)."""
    e1len = p1.est_end + 1 - p1.est_start
    g1len = p1.gen_end + 1 - p1.gen_start
    e2len = p2.est_end + 1 - p2.est_start
    g2len = p2.gen_end + 1 - p2.gen_start
    if (e1len + e2len) < (LB_SMALL_EXON_LENGTH + 2 * UB_SMALL_EXON_LENGTH):
        return False
    e1slen = min(min(e1len, g1len), UB_SMALL_EXON_LENGTH)
    e1sstart = p1.est_end + 1 - e1slen
    e1sfact = est_seq[e1sstart:e1sstart + e1slen]
    g1sstart = p1.gen_end + 1 - e1slen
    g1sfact = gen_seq[g1sstart:g1sstart + e1slen]

    e2plen = min(min(e2len, g2len), UB_SMALL_EXON_LENGTH)
    e2pstart = p2.est_start
    e2pfact = est_seq[e2pstart:e2pstart + e2plen]
    g2pstart = p2.gen_start
    g2pfact = gen_seq[g2pstart:g2pstart + e2plen]

    sed = compute_edit_distance(e1sfact, g1sfact)
    ped = compute_edit_distance(e2pfact, g2pfact)
    prev_ed = sed + ped
    continue_search = False
    orig_classification = _classify(gen_seq, p1.gen_end + 1,
                                    p2.gen_start - 1)
    if prev_ed > MAX_ERRORS_CONSIDERED_AS_SMALL:
        continue_search = True
    if orig_classification == INTRON_ND:
        continue_search = True
    if not continue_search:
        return False

    e1socc = g1socc = 0
    f1slen = e1slen
    if sed > 0:
        e1socc, g1socc, f1slen = find_longest_common_factor_dp(e1sfact,
                                                               g1sfact)
    e2pocc = g2pocc = 0
    f2plen = e2plen
    if ped > 0:
        e2pocc, g2pocc, f2plen = find_longest_common_factor_dp(e2pfact,
                                                               g2pfact)

    if f1slen == e1slen and e2pocc > 0:
        new_f1slen = f1slen + 1
        while ((new_f1slen - f1slen) < e2pocc
               and (est_seq[e1sstart + e1socc + f1slen]
                    if e1sstart + e1socc + f1slen < len(est_seq) else "\0")
               == (gen_seq[g2pstart + new_f1slen - f1slen]
                   if g2pstart + new_f1slen - f1slen < len(gen_seq)
                   else "\0")):
            new_f1slen += 1
        if new_f1slen - 1 > f1slen:
            f1slen = new_f1slen - 1

    elen = (e1slen - e1socc) + (e2pocc + f2plen) \
        - 2 * MIN_PERFECT_BORDER_LENGTH
    estart = e1sstart + e1socc + MIN_PERFECT_BORDER_LENGTH
    allgstart = g1sstart + g1socc + MIN_PERFECT_BORDER_LENGTH
    allglen = (g2pstart + g2pocc + f2plen - MIN_PERFECT_BORDER_LENGTH
               - allgstart)
    MIN_INTRON_LENGTH = max(4, config.min_intron_length)
    if f1slen < MIN_PERFECT_BORDER_LENGTH:
        return False
    if f2plen < MIN_PERFECT_BORDER_LENGTH:
        return False
    if allglen < 2 * MIN_INTRON_LENGTH + LB_SMALL_EXON_LENGTH:
        return False
    if elen < LB_SMALL_EXON_LENGTH:
        return False

    efact = est_seq[estart:estart + elen]
    allgfact = gen_seq[allgstart:allgstart + allglen]

    max_sexon_len = 0
    ecut1 = ecut2 = 0
    gcut1_1 = gcut1_2 = gcut2_1 = gcut2_2 = 0
    max_offstart = min(f1slen + 1 - MIN_PERFECT_BORDER_LENGTH,
                       elen + 1 - LB_SMALL_EXON_LENGTH,
                       allglen + 1 - 2 * MIN_INTRON_LENGTH
                       - LB_SMALL_EXON_LENGTH)
    for offstart in range(max_offstart):
        max_offend = min(f2plen + 1 - MIN_PERFECT_BORDER_LENGTH,
                         elen + 1 - offstart - LB_SMALL_EXON_LENGTH,
                         allglen + 1 - 2 * MIN_INTRON_LENGTH
                         - LB_SMALL_EXON_LENGTH - offstart)
        for offend in range(max_offend):
            needle = efact[offstart:elen - offend]
            hay = allgfact[:allglen - offend - MIN_INTRON_LENGTH]
            search_from = offstart + MIN_INTRON_LENGTH
            pos = hay.find(needle, search_from)
            while pos != -1:
                i1start = allgstart + offstart
                i1end = allgstart + pos - 1
                i2start = i1end + 1 + elen - offstart - offend
                i2end = allgstart + allglen - offend - 1
                i1type = _classify(gen_seq, i1start, i1end)
                i2type = _classify(gen_seq, i2start, i2end)
                if i1type != INTRON_ND and i2type != INTRON_ND:
                    sexon_len = elen - offstart - offend
                    if sexon_len > max_sexon_len:
                        max_sexon_len = sexon_len
                        ecut1 = estart + offstart
                        ecut2 = estart + offstart + sexon_len
                        gcut1_1 = i1start
                        gcut1_2 = i1end + 1
                        gcut2_1 = i2start
                        gcut2_2 = i2end + 1
                pos = hay.find(needle, pos + 1)
    if max_sexon_len >= LB_SMALL_EXON_LENGTH:
        pnew = Factor(ecut1, ecut2 - 1, gcut1_2, gcut2_1 - 1)
        p2.est_start = ecut2
        p2.gen_start = gcut2_2
        p1.est_end = ecut1 - 1
        p1.gen_end = gcut1_1 - 1
        pfact.insert(insert_at, pnew)
        return True
    return False


def search_for_new_small_exons(gen_seq: str, est_seq: str,
                               factorizations: List[Factorization],
                               config: Config) -> None:
    """factorization-refinement.c:873-910."""
    for pfact in factorizations:
        idx = 0
        if not pfact:
            continue
        p1 = pfact[0]
        if p1.est_start > LB_SMALL_EXON_LENGTH:
            if search_small_exon_at_prefix(p1, pfact, 0, gen_seq, est_seq,
                                           config):
                idx = 1  # p1 shifted right by the insertion
        # iterate over consecutive pairs; insertion shifts indices
        i = idx
        while i + 1 < len(pfact):
            p1 = pfact[i]
            p2 = pfact[i + 1]
            if search_small_exon(p1, p2, pfact, i + 1, gen_seq, est_seq,
                                 config):
                i += 2
            else:
                i += 1


def analyze_possibly_small_exon(pfact: Factorization, i: int, gen_seq: str,
                                est_seq: str, config: Config) -> bool:
    """factorization-refinement.c:958-1091 for the factor at index i
    (requires internal factor).  Returns True if removed."""
    pprev = pfact[i - 1]
    pcurr = pfact[i]
    pnext = pfact[i + 1]
    elen = pcurr.est_end + 1 - pcurr.est_start
    glen = pcurr.gen_end + 1 - pcurr.gen_start
    if elen > UB_MED_EXON_LENGTH:
        return False
    efact = est_seq[pcurr.est_start:pcurr.est_start + elen]
    gfact = gen_seq[pcurr.gen_start:pcurr.gen_start + glen]
    orig_ed = compute_edit_distance(efact, gfact)

    estart = max(pprev.est_start + 1, pprev.est_end + 1 - AFFIXES_LENGTH)
    eend = min(pnext.est_end, pnext.est_start + AFFIXES_LENGTH)
    epreflen = pprev.est_end + 1 - estart
    esufflen = eend - pnext.est_start
    allelen = eend - estart
    allefact = est_seq[estart:estart + allelen]
    gstart = max(pprev.gen_start + 1, pprev.gen_end + 1 - AFFIXES_LENGTH)
    gend = min(pnext.gen_end, pnext.gen_start + AFFIXES_LENGTH)
    gpreflen = pprev.gen_end + 1 - gstart
    gsufflen = gend - pnext.gen_start
    allglen = gend - gstart
    allgfact = gen_seq[gstart:gstart + allglen]

    orig_ed_pref = compute_edit_distance(est_seq[estart:estart + epreflen],
                                         gen_seq[gstart:gstart + gpreflen])
    orig_ed_suff = compute_edit_distance(
        est_seq[estart - esufflen:estart],
        gen_seq[gstart - gsufflen:gstart])

    ok, offset_p, offset_t1, offset_t2, new_ed = refine_borders(
        allefact, allgfact, orig_ed + orig_ed_pref + orig_ed_suff)
    if not ok:
        return False
    prev_avg = (get_burset_frequency_adaptor(gen_seq, pprev.gen_end + 1,
                                             pcurr.gen_start)
                + get_burset_frequency_adaptor(gen_seq, pcurr.gen_end + 1,
                                               pnext.gen_start)) / 2.0
    new_freq = get_burset_frequency_adaptor(gen_seq, gstart + offset_t1,
                                            gend - allglen + offset_t2)
    if new_freq >= prev_avg:
        pprev.est_end = estart + offset_p - 1
        pnext.est_start = eend + offset_p - allelen
        pprev.gen_end = gstart + offset_t1 - 1
        pnext.gen_start = gend + offset_t2 - allglen
        del pfact[i]
        return True
    return False


def remove_false_small_exons(gen_seq: str, est_seq: str,
                             factorizations: List[Factorization],
                             config: Config) -> None:
    """factorization-refinement.c:1093-1124.  After a removal the scan
    retries with the merged previous factor as current."""
    for pfact in factorizations:
        i = 1
        while i <= len(pfact) - 2:
            removed = analyze_possibly_small_exon(pfact, i, gen_seq,
                                                  est_seq, config)
            if removed:
                # the merged previous factor is retried as the possibly
                # small exon (reference iterator rewind, c:1077-1083); a
                # now-external factor is skipped by analyze and the scan
                # resumes forward.
                i -= 1
                if i < 1:
                    i = 1
            else:
                i += 1


def find_longest_affix(est: str, genomic: str):
    """factorization-refinement.c:1134-1172.  The reference's running-min
    scan selects the LAST cell (row-major) whose weight equals the overall
    minimum among eligible (matching-char, weight <= rate) cells; weights
    start capped at 1.0."""
    import numpy as np
    estl, genomicl = len(est), len(genomic)
    if estl == 0 or genomicl == 0:
        return False, 0, 0
    lib = get_lib()
    if lib is not None:
        out2 = (ctypes.c_int64 * 2)()
        found = lib.longest_affix(est.encode("latin1"), estl,
                                  genomic.encode("latin1"), genomicl,
                                  MAX_ERROR_RATE, out2)
        if found >= 0:
            if not found:
                return False, 0, 0
            return True, int(out2[0]), int(out2[1])
    matrix = edit_distance_full(genomic, est)  # rows over est
    e = np.frombuffer(est.encode("latin1"), dtype=np.uint8)
    g = np.frombuffer(genomic.encode("latin1"), dtype=np.uint8)
    M = matrix[1:, 1:].astype(np.float64)
    denom = (np.arange(1, estl + 1)[:, None]
             + np.arange(1, genomicl + 1)[None, :])
    w = 2.0 * M / denom
    mask = (e[:, None] == g[None, :]) & (w <= MAX_ERROR_RATE) & (w <= 1.0)
    if not mask.any():
        return False, 0, 0
    wmin = w[mask].min()
    cand = mask & (w == wmin)
    idx = int(np.flatnonzero(cand.ravel())[-1])
    return True, idx // genomicl + 1, idx % genomicl + 1


def recover_lost_prefixes_and_suffixes(gen_seq: str, est_seq: str,
                                       factorizations: List[Factorization],
                                       config: Config) -> None:
    """factorization-refinement.c:1175-1265."""
    totglen = len(gen_seq)
    totelen = len(est_seq)
    for pfact in factorizations:
        if not pfact:
            continue
        pff = pfact[0]
        if pff.est_start > 0 and pff.gen_start > 0:
            flen = min(pff.est_start, pff.gen_start)
            elen = min(pff.est_start, int((1.0 + MAX_ERROR_RATE) * flen))
            glen = min(pff.gen_start, int((1.0 + MAX_ERROR_RATE) * flen))
            efact = est_seq[pff.est_start - elen:pff.est_start][::-1]
            gfact = gen_seq[pff.gen_start - glen:pff.gen_start][::-1]
            if efact[:1] != gfact[:1]:
                valid, ecut, gcut = find_longest_affix(efact, gfact)
                if valid:
                    pff.est_start -= ecut
                    pff.gen_start -= gcut
        pfl = pfact[-1]
        if (totelen - pfl.est_end) > 1 and (totglen - pfl.gen_end) > 1:
            flen = min(totelen - pfl.est_end - 1, totglen - pfl.gen_end - 1)
            # NOTE the reference's (int)(1.0+RATE)*flen truncates the SUM
            # to int(1.17) == 1, so elen = min(remaining, flen)
            elen = min(totelen - pfl.est_end - 1, int(1.0 + MAX_ERROR_RATE) * flen)
            glen = min(totglen - pfl.gen_end - 1, int(1.0 + MAX_ERROR_RATE) * flen)
            efact = est_seq[pfl.est_end:pfl.est_end + elen]
            gfact = gen_seq[pfl.gen_end:pfl.gen_end + glen]
            if efact[:1] != gfact[:1]:
                valid, ecut, gcut = find_longest_affix(efact, gfact)
                if valid:
                    pfl.est_end += ecut
                    pfl.gen_end += gcut


def clean_factorizations(gen_seq: str, original_est_seq: str,
                         factorizations: List[Factorization],
                         config: Config) -> List[Factorization]:
    """factorization-refinement.c:912-949 (uses the UNMASKED est seq)."""
    cleaned: List[Factorization] = []
    k = 0
    while k < len(factorizations):
        pfact = factorizations[k]
        pfact = clean_noisy_exons(pfact, gen_seq, original_est_seq, False)
        pfact = clean_external_exons(pfact, gen_seq, original_est_seq)
        if not pfact:
            del factorizations[k]
            continue
        cleaned, added = add_if_not_exists(pfact, cleaned, config)
        if not added:
            del factorizations[k]
            continue
        k += 1
    return cleaned


def refine_est_factorizations(gen_seq: str, est_seq: str,
                              original_est_seq: str,
                              factorizations: List[Factorization],
                              config: Config) -> List[Factorization]:
    """factorization-refinement.c:1269-1305 driver."""
    remove_invalid_factorizations(factorizations)
    remove_duplicated_factorizations(factorizations)
    recover_lost_prefixes_and_suffixes(gen_seq, est_seq, factorizations,
                                       config)
    remove_false_small_exons(gen_seq, est_seq, factorizations, config)
    remove_duplicated_factorizations(factorizations)
    search_for_new_small_exons(gen_seq, est_seq, factorizations, config)
    return clean_factorizations(gen_seq, original_est_seq, factorizations,
                                config)
