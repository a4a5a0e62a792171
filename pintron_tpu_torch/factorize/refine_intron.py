"""Intron refinement: splice-site re-placement around a gap alignment
(refine-intron.c:47-265 and helpers).

After the 3-matrix gap alignment places a candidate intron, the donor and
acceptor boundaries are shifted towards canonical GT-AG (then GC-AG)
patterns within small error budgets, falling back to the best Burset
pattern reachable by sliding exact matches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.factorize.alignments import edit_distance
from pintron_tpu_torch.factorize.burset import check_burset_patterns
from pintron_tpu_torch.factorize.gap_align import GapAlignment, compute_gap_alignment
from pintron_tpu_torch.factorize.seq_util import real_substring
from pintron_tpu_torch.factorize.types import Factor

U32 = 1 << 32


def _al_char(s: str, idx: int) -> str:
    """C reads of alignment strings: out-of-range reads the terminator."""
    if 0 <= idx < len(s):
        return s[idx]
    return "\0"


_SCANNERS = None


def _native_scanners():
    global _SCANNERS
    if _SCANNERS is None:
        from pintron_tpu_torch.native import get_lib, get_scratch
        lib = get_lib()
        if lib is None or not hasattr(lib, "scan_ag_after_right"):
            _SCANNERS = (None, None)
        else:
            _SCANNERS = (lib, get_scratch(0)[2])
    return _SCANNERS


def find_AG_after_on_the_right(al: GapAlignment, init: int
                               ) -> Tuple[int, int, int]:
    """refine-intron.c:892-940.  Returns (cut_on_align, genomic_cut_dim,
    est_cut_dim); dims are -1 when no 'AG' is found."""
    lib, out = _native_scanners()
    if lib is not None:
        eb, gb = al.bytes_pair()
        lib.scan_ag_after_right(eb, gb, len(gb),
                                init, al.intron_end_on_align, out)
        return int(out[0]), int(out[1]), int(out[2])
    if init < 2:
        # size_t underflow in the reference skips the loop entirely
        return -1, -1, -1
    index = init - 2
    glen = len(al.gen)
    stop = False
    while not stop and index < glen - 1:
        while _al_char(al.gen, index) == "-":
            index += 1
        first = _al_char(al.gen, index)
        index += 1
        while _al_char(al.gen, index) == "-":
            index += 1
        second = _al_char(al.gen, index)
        stop = (first + second) == "AG"
        if not stop and index >= glen:
            break
    if not stop:
        return -1, -1, -1
    cut_on_align = index + 1
    cut_gen = 0
    cut_est = 0
    i = al.intron_end_on_align + 1
    while i <= index:
        if _al_char(al.gen, i) != "-":
            cut_gen += 1
        if _al_char(al.est, i) != "-":
            cut_est += 1
        i += 1
    return cut_on_align, cut_gen, cut_est


def find_ACCEPTOR_before_on_the_left(al: GapAlignment, init: int,
                                     acceptor_str: str
                                     ) -> Tuple[int, int, int]:
    """refine-intron.c:942-990."""
    lib, out = _native_scanners()
    if lib is not None:
        eb, gb = al.bytes_pair()
        lib.scan_acceptor_before_left(
            eb, gb, len(gb),
            init, ord(acceptor_str[0]), ord(acceptor_str[1]),
            al.intron_start_on_align, out)
        return int(out[0]), int(out[1]), int(out[2])
    index = init + 2
    stop = False
    while not stop and index > 0:
        while _al_char(al.gen, index) == "-":
            index -= 1
        second = _al_char(al.gen, index)
        index -= 1
        while index >= 0 and _al_char(al.gen, index) == "-":
            index -= 1
        first = _al_char(al.gen, index) if index >= 0 else "\0"
        if (first + second) == acceptor_str:
            stop = True
    if not stop:
        return -1, -1, -1
    cut_on_align = index - 1
    cut_gen = 0
    cut_est = 0
    i = al.intron_start_on_align - 1
    while i >= index:
        if _al_char(al.gen, i) != "-":
            cut_gen += 1
        if _al_char(al.est, i) != "-":
            cut_est += 1
        i -= 1
    return cut_on_align, cut_gen, cut_est


def find_ACCEPTOR_after_on_the_left(al: GapAlignment, init: int,
                                    acceptor_str: str) -> int:
    """refine-intron.c:1852-1874.  Returns genomic_substr_dim or -1."""
    lib, _ = _native_scanners()
    if lib is not None:
        return int(lib.scan_acceptor_after_left(
            al.bytes_pair()[1], len(al.gen), init,
            ord(acceptor_str[0]), ord(acceptor_str[1]),
            al.intron_start_on_align, al.intron_end_on_align))
    index = init
    stop = False
    while not stop and index < al.intron_end_on_align:
        first = _al_char(al.gen, index)
        index += 1
        second = _al_char(al.gen, index)
        if (first + second) == acceptor_str:
            stop = True
    if not stop:
        return -1
    return index - al.intron_start_on_align - 1


def find_AG_before_on_the_right(al: GapAlignment, init: int) -> int:
    """refine-intron.c:1950-1973."""
    lib, _ = _native_scanners()
    if lib is not None:
        return int(lib.scan_ag_before_right(
            al.bytes_pair()[1], len(al.gen), init,
            al.intron_start_on_align, al.intron_end_on_align))
    index = init
    stop = False
    while not stop and index > al.intron_start_on_align:
        second = _al_char(al.gen, index)
        index -= 1
        first = _al_char(al.gen, index)
        if (first + second) == "AG":
            stop = True
    if not stop:
        return -1
    return al.intron_end_on_align - index - 1


def get_genomic_substring_from_alignment(al: GapAlignment, init: int,
                                         length: int
                                         ) -> Tuple[Optional[str], Optional[int]]:
    """refine-intron.c:1878-1914.  Returns (substr, error) — error None when
    the function bails out without setting it."""
    if init < 0 or init >= len(al.gen):
        return None, None
    actual = min(len(al.gen) - init, length)
    gsub = []
    err = 0
    for index in range(init, init + actual):
        if al.gen[index] != "-":
            gsub.append(al.gen[index])
        if al.gen[index] != al.est[index]:
            err += 1
    return "".join(gsub), err


def get_est_substring_from_alignment(al: GapAlignment, init: int, length: int
                                     ) -> Tuple[Optional[str], Optional[int]]:
    """refine-intron.c:1918-1948."""
    if init < 0 or init >= len(al.gen):
        return None, None
    actual = min(len(al.est) - init, length)
    esub = []
    err = 0
    for index in range(init, init + actual):
        if al.est[index] != "-":
            esub.append(al.est[index])
        if al.gen[index] != al.est[index]:
            err += 1
    return "".join(esub), err


def _shift_ext_error(al: GapAlignment, right_to_left: bool
                     ) -> Tuple[Optional[str], Optional[str], int]:
    """The 'PKM2' extension substrings + error shared by the Shift_*
    functions.  Returns (ext_est, ext_gen, ext_error) with ext_error = -1
    if never set (C leaves the initial -1)."""
    if right_to_left:
        l_substr = 8
        start = al.intron_start_on_align - l_substr
        if start < 0:
            l_substr = l_substr - start
            start = 0
        ext_est, e1 = get_est_substring_from_alignment(al, start, l_substr)
        ext_gen, e2 = get_genomic_substring_from_alignment(al, start, l_substr)
    else:
        init = al.intron_end_on_align + 1
        ext_est, e1 = get_est_substring_from_alignment(al, init, 8)
        ext_gen, e2 = get_genomic_substring_from_alignment(al, init, 8)
    ext_error = -1
    if e1 is not None:
        ext_error = e1
    if e2 is not None:
        ext_error = e2
    return ext_est, ext_gen, ext_error


def shift_right_to_left_1(estseq: str, genseq: str, cycle: int,
                          al: GapAlignment, acceptor_str: str):
    """refine-intron.c:992-1211 (GT variant: first (i,j) with
    unsigned-error <= 1 wins)."""
    init_right = al.intron_end_on_align + 1
    init_left = al.intron_start_on_align

    gen_cut = [0] * cycle
    est_cut = [0] * cycle
    gen_substr = [0] * cycle
    cut_factor: List[Optional[str]] = [None] * cycle
    match_str: List[Optional[str]] = [None] * cycle
    prev_match: List[Optional[str]] = [None] * cycle
    ext_cut: List[Optional[str]] = [None] * cycle
    ext_match: List[Optional[str]] = [None] * cycle

    ext_est, ext_gen, ext_error = _shift_ext_error(al, right_to_left=True)

    for i in range(cycle):
        cut_on_align, gen_cut[i], est_cut[i] = find_AG_after_on_the_right(
            al, init_right)
        if est_cut[i] > -1:
            prev_match[i] = real_substring(al.new_acceptor_left_on_gen,
                                           gen_cut[i], genseq)
            cut_factor[i] = real_substring(al.new_acceptor_factor_left,
                                           est_cut[i], estseq)
            init_right = cut_on_align + 1
            if ext_error > 0 and ext_est is not None:
                ext_cut[i] = ext_est + cut_factor[i]
        gen_substr[i] = find_ACCEPTOR_after_on_the_left(al, init_left,
                                                        acceptor_str)
        if gen_substr[i] > -1:
            match_str[i] = real_substring(al.new_donor_right_on_gen + 1,
                                          gen_substr[i], genseq)
            init_left = al.intron_start_on_align + gen_substr[i] + 1
            if cut_factor[i] is not None and ext_error > 0 \
                    and ext_gen is not None:
                ext_match[i] = ext_gen + match_str[i]

    error = 1000
    edit_prev = 1000
    stop = False
    out = (0, 0, 0)
    i = 0
    while i < cycle and not stop:
        j = 0
        while j < cycle and not stop:
            if cut_factor[i] is not None and match_str[j] is not None:
                edit_prev = edit_distance(cut_factor[i], prev_match[i])
                if edit_prev <= 5:
                    if ext_cut[i] is not None and ext_match[j] is not None:
                        ed = edit_distance(ext_cut[i], ext_match[j])
                        error = (ed - edit_prev - ext_error) % U32
                    else:
                        ed = edit_distance(cut_factor[i], match_str[j])
                        error = (ed - edit_prev) % U32
            if error <= 1:
                out = (al.new_donor_right_on_gen + gen_substr[j],
                       al.new_acceptor_left_on_gen + gen_cut[i],
                       al.new_acceptor_factor_left + est_cut[i])
                stop = True
            j += 1
        i += 1
    return stop, out


def shift_left_to_right_1(estseq: str, genseq: str, cycle: int,
                          al: GapAlignment, acceptor_str: str):
    """refine-intron.c:1429-1642."""
    init_right = al.intron_end_on_align
    init_left = al.intron_start_on_align - 1

    gen_cut = [0] * cycle
    est_cut = [0] * cycle
    gen_substr = [0] * cycle
    cut_factor: List[Optional[str]] = [None] * cycle
    match_str: List[Optional[str]] = [None] * cycle
    prev_match: List[Optional[str]] = [None] * cycle
    ext_cut: List[Optional[str]] = [None] * cycle
    ext_match: List[Optional[str]] = [None] * cycle

    ext_est, ext_gen, ext_error = _shift_ext_error(al, right_to_left=False)

    for i in range(cycle):
        cut_on_align, gen_cut[i], est_cut[i] = \
            find_ACCEPTOR_before_on_the_left(al, init_left, acceptor_str)
        if est_cut[i] > -1:
            prev_match[i] = real_substring(
                al.new_donor_right_on_gen - gen_cut[i] + 1, gen_cut[i],
                genseq)
            cut_factor[i] = real_substring(
                al.new_acceptor_factor_left - est_cut[i], est_cut[i], estseq)
            init_left = cut_on_align - 1
            if ext_error > 0 and ext_est is not None:
                ext_cut[i] = cut_factor[i] + ext_est
        gen_substr[i] = find_AG_before_on_the_right(al, init_right)
        if gen_substr[i] > -1:
            match_str[i] = real_substring(
                al.new_acceptor_left_on_gen - gen_substr[i], gen_substr[i],
                genseq)
            init_right = al.intron_end_on_align - gen_substr[i] - 1
            if cut_factor[i] is not None and ext_error > 0 \
                    and ext_gen is not None:
                ext_match[i] = match_str[i] + ext_gen

    error = 1000
    edit_prev = 1000
    stop = False
    out = (0, 0, 0)
    i = 0
    while i < cycle and not stop:
        j = 0
        while j < cycle and not stop:
            if cut_factor[i] is not None and match_str[j] is not None:
                edit_prev = edit_distance(cut_factor[i], prev_match[i])
                if edit_prev <= 5:
                    if ext_cut[i] is not None and ext_match[j] is not None:
                        ed = edit_distance(ext_cut[i], ext_match[j])
                        error = (ed - edit_prev - ext_error) % U32
                    else:
                        ed = edit_distance(cut_factor[i], match_str[j])
                        error = (ed - edit_prev) % U32
            if error <= 1:
                out = (al.new_donor_right_on_gen - gen_cut[i],
                       al.new_acceptor_left_on_gen - gen_substr[j],
                       al.new_acceptor_factor_left - est_cut[i])
                stop = True
            j += 1
        i += 1
    return stop, out


def shift_right_to_left_2(estseq: str, genseq: str, cycle: int,
                          al: GapAlignment, acceptor_str: str):
    """refine-intron.c:1214-1427 (GC variant: minimize signed edit; stop
    only at 0)."""
    init_right = al.intron_end_on_align + 1
    init_left = al.intron_start_on_align

    gen_cut = [0] * cycle
    est_cut = [0] * cycle
    gen_substr = [0] * cycle
    cut_factor: List[Optional[str]] = [None] * cycle
    match_str: List[Optional[str]] = [None] * cycle
    ext_cut: List[Optional[str]] = [None] * cycle
    ext_match: List[Optional[str]] = [None] * cycle

    ext_est, ext_gen, ext_error = _shift_ext_error(al, right_to_left=True)

    for i in range(cycle):
        cut_on_align, gen_cut[i], est_cut[i] = find_AG_after_on_the_right(
            al, init_right)
        if est_cut[i] > -1:
            cut_factor[i] = real_substring(al.new_acceptor_factor_left,
                                           est_cut[i], estseq)
            init_right = cut_on_align + 1
            if ext_error > 0 and ext_est is not None:
                ext_cut[i] = ext_est + cut_factor[i]
        gen_substr[i] = find_ACCEPTOR_after_on_the_left(al, init_left,
                                                        acceptor_str)
        if gen_substr[i] > -1:
            match_str[i] = real_substring(al.new_donor_right_on_gen + 1,
                                          gen_substr[i], genseq)
            init_left = al.intron_start_on_align + gen_substr[i] + 1
            if cut_factor[i] is not None and ext_error > 0 \
                    and ext_gen is not None:
                ext_match[i] = ext_gen + match_str[i]

    error = 1000
    stop = False
    out = (0, 0, 0)
    i = 0
    while i < cycle and not stop:
        j = 0
        while j < cycle and not stop:
            if ext_cut[i] is not None and ext_match[j] is not None:
                edit = edit_distance(ext_cut[i], ext_match[j]) - ext_error
            elif cut_factor[i] is not None and match_str[j] is not None:
                edit = edit_distance(cut_factor[i], match_str[j])
            else:
                edit = 1000
            if edit < error:
                error = edit
                out = (al.new_donor_right_on_gen + gen_substr[j],
                       al.new_acceptor_left_on_gen + gen_cut[i],
                       al.new_acceptor_factor_left + est_cut[i])
            if error == 0:
                stop = True
            j += 1
        i += 1
    return stop, out


def shift_left_to_right_2(estseq: str, genseq: str, cycle: int,
                          al: GapAlignment, acceptor_str: str):
    """refine-intron.c:1645-1850."""
    init_right = al.intron_end_on_align
    init_left = al.intron_start_on_align - 1

    gen_cut = [0] * cycle
    est_cut = [0] * cycle
    gen_substr = [0] * cycle
    cut_factor: List[Optional[str]] = [None] * cycle
    match_str: List[Optional[str]] = [None] * cycle
    ext_cut: List[Optional[str]] = [None] * cycle
    ext_match: List[Optional[str]] = [None] * cycle

    ext_est, ext_gen, ext_error = _shift_ext_error(al, right_to_left=False)

    for i in range(cycle):
        cut_on_align, gen_cut[i], est_cut[i] = \
            find_ACCEPTOR_before_on_the_left(al, init_left, acceptor_str)
        if est_cut[i] > -1:
            cut_factor[i] = real_substring(
                al.new_acceptor_factor_left - est_cut[i], est_cut[i], estseq)
            init_left = cut_on_align - 1
            if ext_error > 0 and ext_est is not None:
                ext_cut[i] = cut_factor[i] + ext_est
        gen_substr[i] = find_AG_before_on_the_right(al, init_right)
        if gen_substr[i] > -1:
            match_str[i] = real_substring(
                al.new_acceptor_left_on_gen - gen_substr[i], gen_substr[i],
                genseq)
            init_right = al.intron_end_on_align - gen_substr[i] - 1
            if cut_factor[i] is not None and ext_error > 0 \
                    and ext_gen is not None:
                ext_match[i] = match_str[i] + ext_gen

    error = 1000
    stop = False
    out = (0, 0, 0)
    i = 0
    while i < cycle and not stop:
        j = 0
        while j < cycle and not stop:
            if ext_cut[i] is not None and ext_match[j] is not None:
                edit = edit_distance(ext_cut[i], ext_match[j]) - ext_error
            elif cut_factor[i] is not None and match_str[j] is not None:
                edit = edit_distance(cut_factor[i], match_str[j])
            else:
                edit = 1000
            if edit < error:
                error = edit
                out = (al.new_donor_right_on_gen - gen_cut[i],
                       al.new_acceptor_left_on_gen - gen_substr[j],
                       al.new_acceptor_factor_left - est_cut[i])
            if error == 0:
                stop = True
            j += 1
        i += 1
    return stop, out


def try_burset_after_match(est_sequence: str, genomic_sequence: str,
                           acceptor_factor_left: int, donor_right_on_gen: int,
                           acceptor_left_on_gen: int,
                           shifting_donor_factor_left: int,
                           shifting_acceptor_factor_right: int
                           ) -> Tuple[int, int, int, int]:
    """refine-intron.c:267-343.  Returns (frequency, acceptor_factor_left,
    donor_right_on_gen, acceptor_left_on_gen)."""
    s_afl = acceptor_factor_left
    s_alg = acceptor_left_on_gen
    s_drg = donor_right_on_gen
    upd_afl = s_afl
    upd_alg = s_alg
    upd_drg = s_drg
    frequency = 0
    right_to_left = False

    def echar(idx):
        return est_sequence[idx] if 0 <= idx < len(est_sequence) else "\0"

    def gchar(idx):
        return genomic_sequence[idx] if 0 <= idx < len(genomic_sequence) \
            else "\0"

    stop = False
    while (not stop and echar(s_afl) == gchar(s_alg)
           and s_afl > shifting_donor_factor_left + 1):
        if s_afl == 0 or s_drg == -1:
            stop = True
        else:
            tmp = check_burset_patterns(genomic_sequence, s_drg, s_alg)
            if tmp > frequency:
                frequency = tmp
                upd_afl = s_afl
                upd_alg = s_alg
                upd_drg = s_drg
            s_afl -= 1
            s_drg -= 1
            s_alg -= 1

    s_afl = acceptor_factor_left
    s_alg = acceptor_left_on_gen + 1
    s_drg = donor_right_on_gen + 1

    stop = False
    while (not stop and echar(s_afl) == gchar(s_drg)
           and s_afl < shifting_acceptor_factor_right):
        if s_afl == len(est_sequence) or s_alg == len(genomic_sequence):
            stop = True
        else:
            tmp = check_burset_patterns(genomic_sequence, s_drg, s_alg)
            if tmp > frequency:
                frequency = tmp
                upd_afl = s_afl
                upd_alg = s_alg
                upd_drg = s_drg
                right_to_left = True
            s_afl += 1
            s_drg += 1
            s_alg += 1

    if right_to_left:
        upd_afl += 1

    return frequency, upd_afl, upd_drg, upd_alg


# refine_intron is a pure function of (sequences, factor coords, config
# windows); candidate factorizations of the same EST repeat adjacent
# factor pairs, so memoize the outcome (str hashes are cached by the
# interpreter, so key construction is cheap after the first call).
_RI_CACHE: dict = {}
_RI_CACHE_MAX = 1 << 15


def refine_intron(config: Config, gen_seq: str, est_seq: str,
                  donor: Factor, acceptor: Factor,
                  first_intron: bool) -> bool:
    """refine-intron.c:47-265.  Mutates donor/acceptor on success.
    The whole refinement (windows, gap alignment, splice-site shifts,
    Burset fallback) runs in one native call when available; the python
    body below is the numerically-identical reference implementation."""
    key = (est_seq, gen_seq, donor.est_start, donor.est_end,
           donor.gen_start, donor.gen_end, acceptor.est_start,
           acceptor.est_end, acceptor.gen_start, acceptor.gen_end,
           first_intron, config.suffpref_length_on_est,
           config.suffpref_length_for_intron,
           config.suffpref_length_on_gen, config.min_intron_length)
    hit = _RI_CACHE.get(key)
    if hit is not None:
        (ret, donor.est_start, donor.est_end, donor.gen_start,
         donor.gen_end, acceptor.est_start, acceptor.est_end,
         acceptor.gen_start, acceptor.gen_end) = hit
        return ret
    ret = _refine_intron_dispatch(config, gen_seq, est_seq, donor,
                                  acceptor, first_intron)
    if len(_RI_CACHE) >= _RI_CACHE_MAX:
        _RI_CACHE.clear()
    _RI_CACHE[key] = (ret, donor.est_start, donor.est_end,
                      donor.gen_start, donor.gen_end, acceptor.est_start,
                      acceptor.est_end, acceptor.gen_start,
                      acceptor.gen_end)
    return ret


def _refine_intron_dispatch(config: Config, gen_seq: str, est_seq: str,
                            donor: Factor, acceptor: Factor,
                            first_intron: bool) -> bool:
    lib, out = _native_scanners()
    if lib is not None and hasattr(lib, "refine_intron_core"):
        from pintron_tpu_torch.factorize.refinement import _enc
        gen_b = _enc(gen_seq)
        est_b = _enc(est_seq)
        ret = lib.refine_intron_core(
            gen_b, len(gen_b), est_b, len(est_b),
            donor.est_start, donor.est_end, donor.gen_start, donor.gen_end,
            acceptor.est_start, acceptor.est_end, acceptor.gen_start,
            acceptor.gen_end,
            config.suffpref_length_on_est,
            config.suffpref_length_for_intron,
            config.suffpref_length_on_gen,
            config.min_intron_length, 1 if first_intron else 0, out)
        if ret >= 0:
            if ret == 0:
                return False
            if ret == 1:
                acceptor.est_start = int(out[2])
                acceptor.gen_start = int(out[1])
                return True
            donor.gen_end = int(out[0])
            acceptor.gen_start = int(out[1])
            acceptor.est_start = int(out[2])
            donor.est_end = acceptor.est_start - 1
            return True
    return _refine_intron_py(config, gen_seq, est_seq, donor, acceptor,
                             first_intron)


def _refine_intron_py(config: Config, gen_seq: str, est_seq: str,
                      donor: Factor, acceptor: Factor,
                      first_intron: bool) -> bool:
    """refine-intron.c:47-265 (host reference path)."""
    sp_est = config.suffpref_length_on_est
    sp_intron = config.suffpref_length_for_intron
    sp_gen = config.suffpref_length_on_gen

    donor_suffix_left_on_gen = donor.gen_start
    if donor.gen_end - sp_gen + 1 >= donor_suffix_left_on_gen:
        donor_suffix_left_on_gen = donor.gen_end - sp_gen + 1
    donor_suffix_on_gen = real_substring(
        donor_suffix_left_on_gen,
        donor.gen_end - donor_suffix_left_on_gen + 1, gen_seq)

    donor_suffix_left_on_est = donor.est_start
    if donor.est_end - sp_est + 1 >= donor_suffix_left_on_est:
        donor_suffix_left_on_est = donor.est_end - sp_est + 1
    donor_suffix_on_est = real_substring(
        donor_suffix_left_on_est,
        donor.est_end - donor_suffix_left_on_est + 1, est_seq)

    acceptor_prefix_right_on_gen = acceptor.gen_end
    if acceptor.gen_start + sp_gen - 1 <= acceptor_prefix_right_on_gen:
        acceptor_prefix_right_on_gen = acceptor.gen_start + sp_gen - 1
    acceptor_prefix_on_gen = real_substring(
        acceptor.gen_start,
        acceptor_prefix_right_on_gen - acceptor.gen_start + 1, gen_seq)

    acceptor_prefix_right_on_est = acceptor.est_end
    if acceptor.est_start + sp_est - 1 <= acceptor_prefix_right_on_est:
        acceptor_prefix_right_on_est = acceptor.est_start + sp_est - 1
    acceptor_prefix_on_est = real_substring(
        acceptor.est_start,
        acceptor_prefix_right_on_est - acceptor.est_start + 1, est_seq)

    gap_on_est = ""
    if donor.est_end != acceptor.est_start - 1:
        gap_on_est = real_substring(donor.est_end + 1,
                                    acceptor.est_start - donor.est_end - 1,
                                    est_seq)

    sequence_on_est = donor_suffix_on_est + gap_on_est + acceptor_prefix_on_est

    intron_prefix = real_substring(donor.gen_end + 1, sp_intron, gen_seq)
    intron_suffix = real_substring(acceptor.gen_start - sp_intron, sp_intron,
                                   gen_seq)
    sequence_on_gen = (donor_suffix_on_gen + intron_prefix + intron_suffix
                       + acceptor_prefix_on_gen)

    deleted_intron_dim = (acceptor.gen_start - donor.gen_end - 1
                          - 2 * sp_intron)

    al = compute_gap_alignment(sequence_on_est, sequence_on_gen)

    al.new_acceptor_factor_left = donor_suffix_left_on_est + al.factor_cut
    al.new_donor_right_on_gen = donor_suffix_left_on_gen + al.intron_start - 1
    al.new_acceptor_left_on_gen = (donor_suffix_left_on_gen + al.intron_end
                                   + deleted_intron_dim + 1)

    if al.new_acceptor_factor_left == donor.est_start:
        if first_intron:
            acceptor.est_start = al.new_acceptor_factor_left
            acceptor.gen_start = al.new_acceptor_left_on_gen
            return True
        return False

    if al.new_acceptor_left_on_gen - al.new_donor_right_on_gen \
            < config.min_intron_length:
        return False

    donor_right_shift = abs(al.new_donor_right_on_gen - donor.gen_end)
    acceptor_left_shift = abs(al.new_acceptor_left_on_gen - acceptor.gen_start)
    if donor_right_shift > 20 or acceptor_left_shift > 20:
        return False

    _, left_gcd, _ = find_ACCEPTOR_before_on_the_left(
        al, al.intron_start_on_align - 1, "GT")
    _, right_gcd, _ = find_AG_after_on_the_right(
        al, al.intron_end_on_align + 1)

    if left_gcd == 0 and right_gcd == 0:
        final = (al.new_donor_right_on_gen, al.new_acceptor_left_on_gen,
                 al.new_acceptor_factor_left)
    else:
        ok, out = shift_right_to_left_1(est_seq, gen_seq, 2, al, "GT")
        if not ok:
            ok, out = shift_left_to_right_1(est_seq, gen_seq, 2, al, "GT")
        if not ok:
            ok, out = shift_right_to_left_2(est_seq, gen_seq, 2, al, "GC")
        if not ok:
            ok, out = shift_left_to_right_2(est_seq, gen_seq, 2, al, "GC")
        if not ok:
            _, afl, drg, alg = try_burset_after_match(
                est_seq, gen_seq,
                al.new_acceptor_factor_left,
                al.new_donor_right_on_gen,
                al.new_acceptor_left_on_gen,
                donor.est_start, acceptor.est_end)
            out = (drg, alg, afl)
        final = out
        if final[1] > acceptor.gen_end or final[0] < donor.gen_start:
            return False

    donor.gen_end = final[0]
    acceptor.gen_start = final[1]
    acceptor.est_start = final[2]
    donor.est_end = acceptor.est_start - 1
    return True
