"""Factorization filter cascade (est-factorizations.c:126-594,
1136-1254, 1667-2321; list.c:relaxed_list_contained/compare).

Order and tie-breaking are semantically significant: every selection is
sequential, and removal order feeds into downstream output order.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.factorize.alignments import (
    compute_alignment, edit_distance, k_band_edit_distance)
from pintron_tpu_torch.factorize.dust import dust_score_by_left_and_right
from pintron_tpu_torch.factorize.refine import refine_borders
from pintron_tpu_torch.factorize.seq_util import real_substring
from pintron_tpu_torch.factorize.types import Factor, Factorization


def check_for_not_source_sink_factorization(factorization: Factorization,
                                            est_length: int) -> bool:
    if len(factorization) > 1:
        return True
    head = factorization[0]
    return not (head.est_start < 0 or head.est_start >= est_length)


def check_exon_start_end(factorization: Factorization) -> bool:
    prev_est_end = -1
    prev_gen_end = -1
    for exon in factorization:
        if exon.est_start > exon.est_end or exon.gen_start > exon.gen_end:
            return False
        if exon.est_start < prev_est_end or exon.gen_start < prev_gen_end:
            return False
        prev_est_end = exon.est_end
        prev_gen_end = exon.gen_end
    return True


def handle_endpoints(factorization: Factorization, gen_seq: str,
                     est_seq: str) -> Factorization:
    """est-factorizations.c:2127-2301: trim the first exon until >5
    consecutive matches, re-place the tail cleavage with >10 matches and
    gap sliding."""
    head = factorization[0]
    gen_exon = real_substring(head.gen_start,
                              head.gen_end - head.gen_start + 1, gen_seq)
    est_exon = real_substring(head.est_start,
                              head.est_end - head.est_start + 1, est_seq)
    al = compute_alignment(est_exon, gen_exon)

    j = 0
    matches = 0
    cut_factor = head.est_start
    cut_exon = head.gen_start
    stop = False
    while j < al.dim and not stop:
        if matches > 5:
            stop = True
        else:
            if al.est[j] == al.gen[j]:
                cut_factor += 1
                cut_exon += 1
                matches += 1
            else:
                if al.est[j] != "-":
                    cut_factor += 1
                if al.gen[j] != "-":
                    cut_exon += 1
                matches = 0
            j += 1
    if not stop:
        factorization.pop(0)
    else:
        head.est_start = cut_factor - matches
        head.gen_start = cut_exon - matches

    if not factorization:
        return factorization

    tail = factorization[-1]
    gen_exon = real_substring(tail.gen_start,
                              tail.gen_end - tail.gen_start + 1, gen_seq)
    est_exon = real_substring(tail.est_start,
                              tail.est_end - tail.est_start + 1, est_seq)
    al = compute_alignment(est_exon, gen_exon)
    est_a = list(al.est)
    gen_a = list(al.gen)

    j = al.dim - 1
    matches = 0
    cut_factor = tail.est_end
    cut_exon = tail.gen_end
    stop = False
    while j >= 0 and not stop:
        if matches > 10:
            stop = True
        else:
            if est_a[j] == gen_a[j]:
                cut_factor -= 1
                cut_exon -= 1
                matches += 1
            else:
                if est_a[j] != "-":
                    cut_factor -= 1
                if gen_a[j] != "-":
                    cut_exon -= 1
                matches = 0
            j -= 1

    est_cleavage = cut_factor + matches
    gen_cleavage = cut_exon + matches

    # cleavage correction: slide gaps rightwards when bases match
    cursor = j + matches + 1
    stop2 = False
    dim = al.dim
    while (cursor < dim - 1
           and (est_a[cursor] == "-" or gen_a[cursor] == "-")
           and not stop2):
        if est_a[cursor] == "-":
            t = cursor + 1
            while t < dim and est_a[t] == "-":
                t += 1
            if t < dim:
                if est_a[t] == gen_a[cursor]:
                    est_a[cursor] = est_a[t]
                    est_a[t] = "-"
                    est_cleavage += 1
                    gen_cleavage += 1
                else:
                    stop2 = True
            else:
                stop2 = True
        else:
            t = cursor + 1
            while t < dim and gen_a[t] == "-":
                t += 1
            if t < dim:
                if gen_a[t] == est_a[cursor]:
                    gen_a[cursor] = gen_a[t]
                    gen_a[t] = "-"
                    est_cleavage += 1
                    gen_cleavage += 1
                else:
                    stop2 = True
            else:
                stop2 = True
        cursor += 1

    if gen_cleavage >= tail.gen_start:
        tail.est_end = est_cleavage
        tail.gen_end = gen_cleavage
    else:
        factorization.pop()
    return factorization


def clean_external_exons(factorization: Factorization, gen_seq: str,
                         est_seq: str) -> Factorization:
    """est-factorizations.c:1706-1825."""
    if not factorization:
        return factorization

    def upper_is(c, ch):
        return c == ch or c == ch.lower()

    def gch(idx):
        return gen_seq[idx] if 0 <= idx < len(gen_seq) else "\0"

    head = factorization.pop(0)
    head_length = head.gen_end - head.gen_start + 1
    head_ok = True
    if head_length < 10:
        head_ok = False
    if head_ok and head_length < 20:
        if not upper_is(gch(head.gen_end + 1), "G"):
            head_ok = False
        else:
            c2 = gch(head.gen_end + 2)
            if not (upper_is(c2, "T") or upper_is(c2, "C")):
                head_ok = False
            else:
                if len(factorization) >= 1:
                    nxt = factorization[0]
                    if not upper_is(gch(nxt.gen_start - 2), "A"):
                        head_ok = False
                    elif not upper_is(gch(nxt.gen_start - 1), "G"):
                        head_ok = False
                else:
                    head_ok = False
        if head_ok:
            gen_exon = real_substring(head.gen_start, head_length, gen_seq)
            est_exon = real_substring(head.est_start,
                                      head.est_end - head.est_start + 1,
                                      est_seq)
            if edit_distance(gen_exon, est_exon) > 0:
                head_ok = False
    if head_ok:
        factorization.insert(0, head)

    if not factorization:
        return factorization

    tail = factorization.pop()
    tail_length = tail.gen_end - tail.gen_start + 1
    tail_ok = True
    if tail_length < 10:
        tail_ok = False
    if tail_ok and tail_length < 20:
        if not upper_is(gch(tail.gen_start - 2), "A"):
            tail_ok = False
        elif not upper_is(gch(tail.gen_start - 1), "G"):
            tail_ok = False
        else:
            if len(factorization) >= 1:
                prev = factorization[-1]
                if not upper_is(gch(prev.gen_end + 1), "G"):
                    tail_ok = False
                else:
                    c2 = gch(prev.gen_end + 2)
                    if not (upper_is(c2, "T") or upper_is(c2, "C")):
                        tail_ok = False
            else:
                tail_ok = False
        if tail_ok:
            gen_exon = real_substring(tail.gen_start, tail_length, gen_seq)
            est_exon = real_substring(tail.est_start,
                                      tail.est_end - tail.est_start + 1,
                                      est_seq)
            if edit_distance(gen_exon, est_exon) > 0:
                tail_ok = False
    if tail_ok:
        factorization.append(tail)
    return factorization


def update_with_subfact_with_best_coverage(factorization: Factorization,
                                           split_list: List[int]
                                           ) -> Factorization:
    """est-factorizations.c:1900-1987: keep the split segment (between bad
    exons) with the best EST coverage."""
    if not split_list:
        return factorization

    best_left = -1
    best_right = -1
    best_cover = -1
    size = len(factorization)

    pos = 0  # iterator over factorization (0-based)
    left_index = 1
    for right_index in split_list:
        left_exon = factorization[pos]
        pos += 1
        right_exon = left_exon
        if left_index < right_index:
            times = right_index - left_index - 1
            while times > 0:
                right_exon = factorization[pos]
                pos += 1
                times -= 1
            cover = right_exon.est_end - left_exon.est_start + 1
            if cover > best_cover:
                best_left = left_index
                best_right = right_index - 1
                best_cover = cover
            pos += 1  # skip the bad exon
        left_index = right_index + 1

    if left_index <= size:
        left_exon = factorization[pos]
        pos += 1
        right_exon = left_exon
        times = size - left_index
        while times > 0:
            right_exon = factorization[pos]
            pos += 1
            times -= 1
        cover = right_exon.est_end - left_exon.est_start + 1
        if cover > best_cover:
            best_left = left_index
            best_right = size
            best_cover = cover

    if best_left == -1 or best_right == -1:
        factorization.clear()
    else:
        del factorization[:best_left - 1]
        del factorization[best_right - (best_left - 1):]
    return factorization


def clean_low_complexity_exons_2(factorization: Factorization, gen_seq: str,
                                 est_seq: str, config: Config
                                 ) -> Factorization:
    split = []
    for index, exon in enumerate(factorization, start=1):
        gd = 0.0
        ed = 0.0
        if exon.gen_start <= exon.gen_end:
            gd = dust_score_by_left_and_right(gen_seq, exon.gen_start,
                                              exon.gen_end)
            ed = dust_score_by_left_and_right(est_seq, exon.est_start,
                                              exon.est_end)
        if gd > config.complexity_threshold or ed > config.complexity_threshold:
            split.append(index)
    return update_with_subfact_with_best_coverage(factorization, split)


def compute_max_edit_for_exon(exon_length: int) -> int:
    if exon_length > 100:
        rate = 0.030
    elif exon_length > 50:
        rate = 0.035
    else:
        rate = 0.040
    return int(max(1.0, math.ceil(exon_length * rate)))


def clean_noisy_exons(factorization: Factorization, gen_seq: str,
                      est_seq: str, only_internals: bool) -> Factorization:
    split = []
    size = len(factorization)
    index = 2 if only_internals else 1
    last_index = size - 1 if only_internals else size
    items = factorization[1:] if only_internals else factorization[:]
    for exon in items:
        if index > last_index:
            break
        exon_length = exon.gen_end - exon.gen_start + 1
        max_err = compute_max_edit_for_exon(exon_length)
        ok = False
        if exon.gen_start <= exon.gen_end:
            gen_exon = real_substring(exon.gen_start, exon_length, gen_seq)
            est_exon = real_substring(exon.est_start,
                                      exon.est_end - exon.est_start + 1,
                                      est_seq)
            ok, _ = k_band_edit_distance(gen_exon, est_exon, max_err)
        if not ok:
            split.append(index)
        index += 1
    return update_with_subfact_with_best_coverage(factorization, split)


def check_est_coverage(factorization: Factorization, est_seq: str) -> bool:
    est_length = len(est_seq)
    head = factorization[0]
    tail = factorization[-1]
    coverage = (tail.est_end - head.est_start + 1) / est_length
    return coverage >= 0.35


# ---- relaxed comparisons (add_if_not_exists machinery) --------------------

def relaxed_factor_compare(p1: Factor, p2: Factor, cfr_type: int,
                           allowed_diff: int, l1: Factorization) -> int:
    """est-factorizations.c:1149-1254.  0 == equal under the mode."""
    if p1.gen_start < p2.gen_start and p1.gen_end < p2.gen_start:
        return 1
    if p2.gen_start < p1.gen_start and p2.gen_end < p1.gen_start:
        return 1

    max_unconf_diff = 20

    if cfr_type == 0:
        if abs(p1.gen_end - p2.gen_end) <= allowed_diff:
            if abs(p1.gen_start - p2.gen_start) <= allowed_diff:
                return 0

    if abs(cfr_type) == 2:
        if abs(p1.gen_end - p2.gen_end) <= allowed_diff:
            if cfr_type == 2:
                if p1.gen_start - p2.gen_start > max_unconf_diff:
                    return 1
                if p1.gen_start - p2.gen_start > 0:
                    tot_l = 0
                    stop = False
                    for f in l1:
                        if p1.gen_start == f.gen_start:
                            stop = True
                            break
                        tot_l += f.gen_end - f.gen_start + 1
                    assert stop
                    if abs(p1.gen_start - p2.gen_start - tot_l) < 10:
                        return 1
            return 0

    if abs(cfr_type) == 1:
        if abs(p1.gen_start - p2.gen_start) <= allowed_diff:
            if cfr_type == 1:
                if p2.gen_end - p1.gen_end > max_unconf_diff:
                    return 1
                if p2.gen_end - p1.gen_end > 0:
                    tot_l = 0
                    stop = False
                    for f in reversed(l1):
                        if p1.gen_start == f.gen_start:
                            stop = True
                            break
                        tot_l += f.gen_end - f.gen_start + 1
                    assert stop
                    if abs(p2.gen_end - p1.gen_end - tot_l) < 20:
                        return 1
            return 0

    return 1


def relaxed_list_compare(l1: Factorization, l2: Factorization,
                         allowed_diff: int) -> int:
    """list.c:relaxed_list_compare.  -2 == equal, else 0."""
    if len(l1) != len(l2) or len(l1) == 1:
        return 0
    size = len(l1)
    for k in range(size):
        if allowed_diff == -1:
            cfr_type = 0
            actual = 0
        else:
            actual = allowed_diff
            if k == 0:
                cfr_type = -2
            elif k == size - 1:
                cfr_type = -1
            else:
                cfr_type = 0
        if relaxed_factor_compare(l1[k], l2[k], cfr_type, actual, l1) != 0:
            return 0
    return -2


def relaxed_list_contained(l1: Factorization, l2: Factorization,
                           allowed_diff: int) -> int:
    """list.c:relaxed_list_contained.  -2: equal; -1: l1 contained in l2;
    1: l2 contained in l1; 0: neither."""
    if len(l1) == len(l2):
        return relaxed_list_compare(l1, l2, allowed_diff)
    if len(l1) == 1 or len(l2) == 1:
        return 0

    actual = 0 if allowed_diff == -1 else allowed_diff

    if len(l1) > len(l2):
        longer, shorter = l1, l2
        sign = 1
    else:
        longer, shorter = l2, l1
        sign = -1

    # phase 1: find the element of `longer` matching the first of `shorter`
    cfr_type = 0 if allowed_diff == -1 else -2
    found = False
    count_long = 1
    i_long = 0
    while i_long < len(longer) and not found:
        if relaxed_factor_compare(longer[i_long], shorter[0], cfr_type,
                                  actual, longer) == 0:
            found = True
        else:
            count_long += 1
        i_long += 1
        if cfr_type == -2:
            cfr_type = 2
    if not found:
        return 0

    # phase 2: pairwise containment check for the remainder
    i_short = 1
    count_factors = 1
    stop = False
    while i_long < len(longer) and i_short < len(shorter) and not stop:
        if allowed_diff == -1:
            cfr_type = 0
        else:
            if count_factors + 1 == len(shorter):
                cfr_type = -1 if count_long + 1 == len(longer) else 1
            else:
                cfr_type = 0
        if relaxed_factor_compare(longer[i_long], shorter[i_short],
                                  cfr_type, actual, longer) == 0:
            i_long += 1
            i_short += 1
        else:
            stop = True
        count_factors += 1
        count_long += 1

    if stop:
        return 0
    if count_factors == len(shorter):
        return sign
    return 0


def add_if_not_exists(factorization: Factorization,
                      factorization_list: List[Factorization],
                      config: Config) -> Tuple[List[Factorization], bool]:
    """est-factorizations.c:2041-2109.  Returns (list, added)."""
    found = False
    k = 0
    while k < len(factorization_list) and not found:
        cmp_f = factorization_list[k]
        if len(cmp_f) == len(factorization) == 1:
            h1 = factorization[0]
            h2 = cmp_f[0]
            if h1.gen_start == h2.gen_start and h1.gen_end == h2.gen_end:
                cont_result = -2
            elif h1.gen_start >= h2.gen_start and h1.gen_end <= h2.gen_end:
                cont_result = -1
            elif h1.gen_start <= h2.gen_start and h1.gen_end >= h2.gen_end:
                cont_result = 1
            else:
                cont_result = 0
        else:
            cont_result = relaxed_list_contained(factorization, cmp_f,
                                                 config.max_site_difference)
        if cont_result < 0:
            if cont_result == -2:
                h1 = factorization[0]
                h2 = cmp_f[0]
                if h1.est_start < h2.est_start:
                    h2.est_start = h1.est_start
                    h2.gen_start = h1.gen_start
                t1 = factorization[-1]
                t2 = cmp_f[-1]
                if t1.est_end > t2.est_end:
                    t2.est_end = t1.est_end
                    t2.gen_end = t1.gen_end
            found = True
        else:
            if cont_result == 1:
                del factorization_list[k]
                continue
        k += 1
    if not found:
        factorization_list.append(factorization)
    return factorization_list, not found


def check_gap_errors(factorization: Factorization, est_seq: str,
                     gen_seq: str, config: Config) -> bool:
    """est-factorizations.c:1462-1545 (FILTER 4 + gap filling + <=3nt
    intron merge)."""
    threshold_ed = 20
    tot_ed = 0
    ok = True
    k = 0
    while k < len(factorization) - 1 and ok:
        donor = factorization[k]
        accept = factorization[k + 1]
        gap_p = accept.est_start - donor.est_end - 1
        if gap_p > 0:
            gap_t = accept.gen_start - donor.gen_end - 1
            p = real_substring(donor.est_end + 1, gap_p, est_seq)
            t = real_substring(donor.gen_end + 1, gap_t, gen_seq)
            ok, off_p, off_t1, off_t2, ed = refine_borders(p, t, gap_p)
            if ok:
                tot_ed += ed
                donor.est_end += off_p
                accept.est_start = donor.est_end + 1
                donor.gen_end += off_t1
                accept.gen_start -= gap_t - off_t2
        k += 1

    if ok and tot_ed > threshold_ed:
        ok = False

    if ok:
        k = 0
        while k < len(factorization) - 1:
            d = factorization[k]
            a = factorization[k + 1]
            if a.gen_start - d.gen_end - 1 <= 3:
                d.est_end = a.est_end
                d.gen_end = a.gen_end
                del factorization[k + 1]
            else:
                k += 1
    return ok


def compute_coverage(factorization: Factorization, length: int) -> float:
    head = factorization[0]
    tail = factorization[-1]
    cover = length - (head.est_start + (length - tail.est_end - 1))
    return cover / length


def compute_gap_length(factorization: Factorization) -> int:
    if len(factorization) == 1:
        return 0
    total = 0
    for k in range(len(factorization) - 1):
        total += (factorization[k + 1].est_start
                  - factorization[k].est_end - 1)
    return total
