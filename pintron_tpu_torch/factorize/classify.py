"""Intron classification via position-weight matrices
(classify-intron.c:95-663).

MatInspector-style scoring against hardcoded U12/U2 splice-site and
branch-point matrices; the decision tree labels introns U12 (0), U2 (1)
or unclassified (2).

The port's copy of ``pintron_tpu.factorize.classify``.  Its device site
is ``precompute_bps_device``: every registry intron's branch-point
windows in one batch per matrix (``offload.pwm_scores_batched``:
``pwm_kernel`` on a GPU, its plain version on the CPU, or the service),
then an exact finish on the host, so that consuming the overrides is
bit-identical to the host path.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from pintron_tpu_torch.factorize.pwm_data import (CV, MAXV, PWM, _BASE,
                                                  pwm_tables)
from pintron_tpu_torch.factorize.seq_util import real_substring
from pintron_tpu_torch.ops import offload

INTRON_U12 = 0
INTRON_U2 = 1
INTRON_ND = 2

_BASE_INDEX = {"A": 0, "a": 0, "C": 1, "c": 1, "G": 2, "g": 2,
               "T": 3, "t": 3, "N": 0, "n": 0}


def mat_inspector_score(sequence: str, name: str) -> float:
    """classify-intron.c:620-663.  Out-of-range reads (short sequence)
    behave like the C's '\\0' bytes: index stays -1 -> my_assert disabled
    in production, reads pwm[-L+i]... we instead treat missing chars as
    'A' only when the C would have: in practice windows are always full
    because real_substring clamps earlier; assert to catch violations."""
    pwm = PWM[name]
    cv = CV[name]
    maxv = MAXV[name]
    L = len(cv)
    num = 0.0
    den = 0.0
    for i in range(L):
        ch = sequence[i] if i < len(sequence) else "\0"
        idx = _BASE_INDEX.get(ch)
        if idx is None:
            # The reference would read out of bounds here (index stays -1
            # with NDEBUG); real inputs never hit this.
            idx = 3  # pwm[-1*L + i] == row3[i] for the previous row layout
        num += cv[i] * pwm[idx][i]
        den += cv[i] * maxv[i]
    return num / den


def search_bps(intron_sequence: str, name: str, range_start: int,
               range_end: int) -> Tuple[int, float]:
    """classify-intron.c:575-618.  Returns (position, score)."""
    length = len(intron_sequence)
    if length < range_start:
        return -1, 0.0
    start_w = length - range_end
    end_w = length - range_start
    if start_w < 0:
        start_w = 0
    from pintron_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        wpwm, cv_arr, den = _native_pwm_tables(name)
        out = ctypes.c_double()
        pos = lib.bps_search(intron_sequence.encode("latin1"),
                             len(intron_sequence), wpwm.ctypes.data,
                             wpwm.shape[1], cv_arr.ctypes.data, den,
                             start_w, end_w, ctypes.byref(out))
        return int(pos), float(out.value)
    score = 0.0
    start_bps = -1
    first = True
    i = start_w
    while i <= end_w:
        bps = real_substring(i, 12, intron_sequence)
        sb = mat_inspector_score(bps, name)
        if first or sb >= score:
            score = sb
            start_bps = i
            first = False
        i += 1
    return start_bps, score


_NATIVE_PWM_CACHE = {}


def _native_pwm_tables(name: str):
    """(cv-weighted pwm rows, cv, denominator) with the accumulation
    order of mat_inspector_score preserved for bit-identical doubles."""
    cached = _NATIVE_PWM_CACHE.get(name)
    if cached is not None:
        return cached
    import numpy as np
    pwm = PWM[name]
    cv = CV[name]
    maxv = MAXV[name]
    L = len(cv)
    wpwm = np.empty((4, L), dtype=np.float64)
    for r in range(4):
        for i in range(L):
            wpwm[r, i] = cv[i] * pwm[r][i]
    den = 0.0
    for i in range(L):
        den += cv[i] * maxv[i]
    cv_arr = np.asarray(cv, dtype=np.float64)
    _NATIVE_PWM_CACHE[name] = (wpwm, cv_arr, den)
    return _NATIVE_PWM_CACHE[name]


# Device-offload override: combined exists_good_bps results
# precomputed by the batched device sweep (precompute_bps_device), keyed by
# (intron_start, intron_end, range_start, range_end).  Values are EXACT
# — the device does the f32 argmax sweep, the host re-scores the
# epsilon-neighborhood of the maximum in f64 and applies the reference's
# tie rule — so consuming an override is bit-identical to the host path.
# _BPS_OVERRIDE_GEN pins the overrides to the locus they were computed
# for: precompute clears the table and records the gen object, and the
# classify call site only passes a key while its gen IS that object —
# coordinates alone must never leak results across loci.
_BPS_OVERRIDE: dict = {}
_BPS_OVERRIDE_GEN = None


def exists_good_bps(intron_sequence: str, range_start: int, range_end: int,
                    key: "Tuple[int, int]" = None) -> Tuple[int, float]:
    """classify-intron.c:535-573.  Returns (position, score) with score 0
    when rejected."""
    if range_end > len(intron_sequence):
        return -1, 0.0
    if key is not None and _BPS_OVERRIDE:
        hit = _BPS_OVERRIDE.get((key[0], key[1], range_start, range_end))
        if hit is not None:
            return hit
    bps_9, score_9 = search_bps(intron_sequence, "BPS_9", range_start,
                                range_end)
    bps_10, score_10 = search_bps(intron_sequence, "BPS_10", range_start,
                                  range_end)
    return _combine_bps(bps_9, score_9, bps_10, score_10)


def _combine_bps(bps_9: int, score_9: float, bps_10: int, score_10: float
                 ) -> Tuple[int, float]:
    if score_9 > score_10:
        if score_9 > 0.75:
            return bps_9, score_9
    else:
        if score_10 > 0.75:
            return bps_10, score_10
    return -1, 0.0


# the BPS sweep's matrices and search ranges, and how close to the
# float32 maximum a window must score to be re-scored in float64
EPS = 1e-5
MATRICES = ("BPS_9", "BPS_10")
RANGES = ((14, 30), (30, 200))


def precompute_bps_device(gen: str, pairs: Iterable[Tuple[int, int]],
                          device="cuda") -> int:
    """Batched device sweep for the registry's BPS searches
    (classify-intron.c:575-618 over every intron at once): fill the BPS
    overrides for the introns ``pairs`` of the locus ``gen``, scoring
    on the torch ``device`` (``"cuda"`` raises when no CUDA device is
    available, unless the batches go to the device service).

    For every (start, end) intron and both search ranges ([14, 30] and
    [30, 200]), every candidate window is scored in one batch per
    matrix.  The winner is then made exact on the host: every position
    whose float32 score is within 1e-5 of the float32 maximum is scored
    again with the float64 ``mat_inspector_score``, and the reference's
    scan rule (``>=`` keeps the later position) picks among the exact
    maxima.  Returns the number of windows scored on the device; a
    failed or timed-out batch raises."""
    offload.use_device(device)
    # overrides are per locus: wipe a previous locus's and pin the
    # table to this gen object
    global _BPS_OVERRIDE_GEN
    _BPS_OVERRIDE.clear()
    _BPS_OVERRIDE_GEN = gen

    gen_len = len(gen)
    tables = {name: pwm_tables(name) for name in MATRICES}
    # the locus encoded once, with the host scorer's base mapping, and
    # one zero column past its end: a window running off the genome is
    # padded with code 0, as the reference's zero-initialised rows
    codes = _BASE[np.frombuffer(gen.encode("latin1"), dtype=np.uint8)]
    codes = np.append(np.where(codes >= 0, codes, 3), 0).astype(np.int8)

    batches = {name: [] for name in MATRICES}
    for (start, end) in pairs:
        L = end - start + 1
        if L <= 0:
            continue
        if end >= gen_len:
            # the consumer cuts intron_sequence with real_substring,
            # which truncates at the genome end: let the key miss, so
            # the host path (which clamps) answers
            continue
        for (rs, re) in RANGES:
            if re > L or L < rs:
                continue   # the host path answers trivially
            positions = np.arange(max(0, L - re), L - rs + 1)
            for name in MATRICES:
                wl = tables[name][0].shape[1]
                idx = start + positions[:, None] + np.arange(wl)[None, :]
                rows = codes[np.minimum(idx, gen_len)]
                batches[name].append(((start, end, rs, re), positions, rows))

    n_windows = 0
    sweep = {}   # (key, name) -> (positions, f32 scores)
    for name, items in batches.items():
        if not items:
            continue
        wpwm, den = tables[name]
        allrows = np.concatenate([rows for _, _, rows in items], axis=0)
        scores = offload.pwm_scores_batched(allrows, wpwm, den)
        n_windows += allrows.shape[0]
        pos = 0
        for key, positions, _rows in items:
            sweep[(key, name)] = (positions,
                                  scores[pos:pos + len(positions)])
            pos += len(positions)

    def exact_search(key, name):
        positions, f32s = sweep[(key, name)]
        m = float(np.max(f32s))
        best_pos, best, first = -1, 0.0, True
        iseq = gen[key[0]:key[1] + 1]
        for r, i in enumerate(positions.tolist()):
            if f32s[r] < m - EPS:
                continue
            sb = mat_inspector_score(real_substring(i, 12, iseq), name)
            if first or sb >= best:
                best, best_pos, first = sb, i, False
        return best_pos, best

    for key in dict.fromkeys(k for k, _name in sweep):
        b9, s9 = exact_search(key, "BPS_9")
        b10, s10 = exact_search(key, "BPS_10")
        _BPS_OVERRIDE[key] = _combine_bps(b9, s9, b10, s10)
    return n_windows


def _score5(gen: str, start: int, name: str, length: int) -> float:
    return mat_inspector_score(real_substring(start - 3, length, gen), name)


def _score3(gen: str, end: int, name: str, length: int) -> float:
    return mat_inspector_score(real_substring(end - 14 + 1, length, gen),
                               name)


import functools


@functools.lru_cache(maxsize=200_000)
def classify_genomic_intron_start_end(gen: str, start: int, end: int
                                      ) -> Tuple[int, float, float, int, float]:
    """classify-intron.c:95-229.  Returns (type, score5, score3,
    BPS_position, BPS_score)."""
    intron_sequence = real_substring(start, end - start + 1, gen)
    # device overrides are only valid for the locus they were computed
    # for; coordinates alone must not cross loci
    bkey = (start, end) if gen is _BPS_OVERRIDE_GEN else None
    bps_position, bps_score = exists_good_bps(intron_sequence, 14, 30,
                                              key=bkey)

    pt_5 = real_substring(0, 2, intron_sequence)
    pt_3 = real_substring(len(intron_sequence) - 2, 2, intron_sequence)

    scoreU12_5 = scoreU2_5 = 0.0
    scoreU12_3 = scoreU2_3 = 0.0
    pt_type = 1
    u5 = pt_5.upper() if len(pt_5) == 2 else ""
    u3 = pt_3.upper() if len(pt_3) == 2 else ""
    # strcmp comparisons accept only all-lower or all-upper forms
    is5 = lambda p: pt_5 == p.lower() or pt_5 == p.upper()
    is3 = lambda p: pt_3 == p.lower() or pt_3 == p.upper()

    if is5("gt") and is3("ag"):
        pt_type = 0
        scoreU12_5 = _score5(gen, start, "P5_GTAG_U12", 14)
        scoreU2_5 = _score5(gen, start, "P5_GTAG_U2", 13)
        scoreU12_3 = _score3(gen, end, "P3_GTAG_U12", 18)
        scoreU2_3 = _score3(gen, end, "P3_GTAG_U2", 17)
    elif is5("gc") and is3("ag"):
        pt_type = 0
        scoreU2_5 = _score5(gen, start, "P5_GCAG_U2", 14)
        scoreU2_3 = _score3(gen, end, "P3_GCAG_U2", 18)
        scoreU12_5 = _score5(gen, start, "P5_GTAG_U12", 14)
        s2 = _score5(gen, start, "P5_ATAC_U12", 14)
        if s2 > scoreU12_5:
            scoreU12_5 = s2
        scoreU12_3 = _score3(gen, end, "P3_GTAG_U12", 18)
        s2 = _score3(gen, end, "P3_ATAC_U12", 17)
        if s2 > scoreU12_3:
            scoreU12_3 = s2
    elif is5("at") and is3("ac"):
        scoreU12_5 = _score5(gen, start, "P5_ATAC_U12", 14)
        scoreU12_3 = _score3(gen, end, "P3_ATAC_U12", 17)
        scoreU2_5 = _score5(gen, start, "P5_GTAG_U2", 13)
        s2 = _score5(gen, start, "P5_GCAG_U2", 14)
        if s2 > scoreU2_5:
            scoreU2_5 = s2
        scoreU2_3 = _score3(gen, end, "P3_GTAG_U2", 17)
        s2 = _score3(gen, end, "P3_GCAG_U2", 18)
        if s2 > scoreU2_3:
            scoreU2_3 = s2
    else:
        scoreU12_5 = _score5(gen, start, "P5_GTAG_U12", 14)
        s2 = _score5(gen, start, "P5_ATAC_U12", 14)
        if s2 > scoreU12_5:
            scoreU12_5 = s2
        scoreU2_5 = _score5(gen, start, "P5_GTAG_U2", 13)
        s2 = _score5(gen, start, "P5_GCAG_U2", 14)
        if s2 > scoreU2_5:
            scoreU2_5 = s2
        scoreU12_3 = _score3(gen, end, "P3_GTAG_U12", 18)
        s2 = _score3(gen, end, "P3_ATAC_U12", 17)
        if s2 > scoreU12_3:
            scoreU12_3 = s2
        scoreU2_3 = _score3(gen, end, "P3_GTAG_U2", 17)
        s2 = _score3(gen, end, "P3_GCAG_U2", 18)
        if s2 > scoreU2_3:
            scoreU2_3 = s2

    itype = 2
    if bps_position != -1:
        itype = 0 if scoreU12_5 > scoreU2_5 else 1
    else:
        if pt_type == 0:
            itype = 1
            bps_position, bps_score = exists_good_bps(
                intron_sequence, 30, 200, key=bkey)
        else:
            if scoreU12_5 - scoreU2_5 > 0.25 and scoreU12_5 >= 0.75:
                itype = 0
                bps_position, bps_score = exists_good_bps(
                    intron_sequence, 30, 200, key=bkey)

    if itype == 0:
        score5, score3 = scoreU12_5, scoreU12_3
    else:
        score5, score3 = scoreU2_5, scoreU2_3
    return itype, score5, score3, bps_position, bps_score
