"""Alignment primitives.

Behavior-exact rebuild of the reference's alignment layer
(src/compute-alignments.c, src/refine.c:edit_distance): global alignment
with N-wildcards and deterministic tie-breaking, unit-cost edit distance
matrices, best prefix/suffix cuts, and banded (K-band) edit distance.

These are the pipeline's hottest inner loops; the batched TPU kernels in
``pintron_tpu_torch.ops`` compute the same recurrences over padded problem
batches, with these host versions as the numerically-identical reference.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pintron_tpu_torch.native import get_lib as _get_native_lib


def _is_wild(c: str) -> bool:
    return c in ("n", "N")


class Alignment:
    __slots__ = ("est", "gen", "score")

    def __init__(self, est: str, gen: str, score: int = 0):
        self.est = est  # aligned EST string with '-' gaps
        self.gen = gen
        self.score = score

    @property
    def dim(self) -> int:
        return len(self.est)


# Pure function of its inputs; candidate factorizations repeat exon
# windows, so memoize (fresh Alignment per call — callers own the object).
_NW_CACHE: dict = {}
_NW_CACHE_MAX = 1 << 16


def compute_alignment(est_seq: str, gen_seq: str) -> Alignment:
    key = (est_seq, gen_seq)
    cached = _NW_CACHE.get(key)
    if cached is not None:
        return Alignment(cached[0], cached[1], cached[2])
    al = _compute_alignment_uncached(est_seq, gen_seq)
    if len(_NW_CACHE) >= _NW_CACHE_MAX:
        _NW_CACHE.clear()
    _NW_CACHE[key] = (al.est, al.gen, al.score)
    return al


def _compute_alignment_uncached(est_seq: str, gen_seq: str) -> Alignment:
    """Needleman-Wunsch with unit costs, N-wildcard matches and the
    reference's direction preference diag > up(gap in GEN) > left(gap in
    EST) (compute-alignments.c:85-207)."""
    n = len(est_seq)
    m = len(gen_seq)
    if est_seq == gen_seq:
        return Alignment(est_seq, gen_seq, 0)

    lib = _get_native_lib()
    if lib is not None:
        from pintron_tpu_torch.native import get_scratch
        est_buf, gen_buf, out = get_scratch(n + m)
        score = lib.nw_align_run(est_seq.encode("latin1"), n,
                                 gen_seq.encode("latin1"), m,
                                 est_buf, gen_buf, out)
        if score >= 0:
            total = out[0]
            return Alignment(est_buf.raw[:total].decode("latin1"),
                             gen_buf.raw[:total].decode("latin1"),
                             int(score))

    e = np.frombuffer(est_seq.encode("latin1"), dtype=np.uint8)
    g = np.frombuffer(gen_seq.encode("latin1"), dtype=np.uint8)
    wild_e = (e == ord("n")) | (e == ord("N"))
    wild_g = (g == ord("n")) | (g == ord("N"))

    # Mdir[i, j] for i in 1..n, j in 1..m
    Mdir = np.zeros((n + 1, m + 1), dtype=np.int8)
    M1 = np.arange(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        match = (e[i - 1] == g) | wild_e[i - 1] | wild_g
        diag = M1[:-1] + np.where(match, 0, 1)
        up = M1[1:] + 1
        # candidate before the in-row (left) dependency
        cand = np.minimum(diag, up)
        # vals[j] = min(cand[j], min_{k<j}(cand[k] + (j-k)), i + j)
        idx = np.arange(m)
        vals = np.empty(m + 1, dtype=np.int64)
        vals[0] = i
        vals[1:] = np.minimum(np.minimum.accumulate(cand - idx) + idx,
                              i + 1 + idx)
        # direction with the reference's preference: diag unless strictly
        # beaten by up, unless strictly beaten by left
        left = vals[:-1] + 1
        dirs = np.zeros(m, dtype=np.int8)
        dirs[(up < diag) & (left >= up)] = 1
        dirs[left < np.minimum(diag, up)] = 2
        Mdir[i, 1:] = dirs
        M1 = vals

    score = int(M1[m])
    return _traceback(est_seq, gen_seq, Mdir, score)


def _traceback(est_seq: str, gen_seq: str, Mdir: np.ndarray,
               score: int) -> Alignment:
    n, m = len(est_seq), len(gen_seq)
    est_al: List[str] = []
    gen_al: List[str] = []
    i, j = n, m
    while i > 0 and j > 0:
        d = Mdir[i, j]
        if d == 0:
            est_al.append(est_seq[i - 1])
            gen_al.append(gen_seq[j - 1])
            i -= 1
            j -= 1
        elif d == 1:
            est_al.append(est_seq[i - 1])
            gen_al.append("-")
            i -= 1
        else:
            est_al.append("-")
            gen_al.append(gen_seq[j - 1])
            j -= 1
    while i > 0:
        est_al.append(est_seq[i - 1])
        gen_al.append("-")
        i -= 1
    while j > 0:
        est_al.append("-")
        gen_al.append(gen_seq[j - 1])
        j -= 1
    return Alignment("".join(reversed(est_al)), "".join(reversed(gen_al)),
                     score)


def edit_distance_full(s1: str, s2: str) -> np.ndarray:
    """Unit-cost edit distance matrix, rows over s2 (refine.c:50-83:
    ``edit_distance(s1, ls1, s2, ls2)`` fills an (ls2+1)x(ls1+1) matrix).
    Returns the matrix with shape (len(s2)+1, len(s1)+1)."""
    l1 = len(s1)
    l2 = len(s2)
    lib = _get_native_lib()
    if lib is not None:
        M = np.empty((l2 + 1, l1 + 1), dtype=np.int64)
        lib.edit_matrix(s1.encode("latin1"), l1, s2.encode("latin1"), l2,
                        M.ctypes.data)
        return M
    a1 = np.frombuffer(s1.encode("latin1"), dtype=np.uint8)
    a2 = np.frombuffer(s2.encode("latin1"), dtype=np.uint8)
    M = np.empty((l2 + 1, l1 + 1), dtype=np.int64)
    M[0, :] = np.arange(l1 + 1)
    M[:, 0] = np.arange(l2 + 1)
    for i2 in range(l2):
        prev = M[i2]
        sub = prev[:-1] + (a1 != a2[i2])
        up = prev[1:] + 1
        cand = np.minimum(sub, up)
        idx = np.arange(l1)
        M[i2 + 1, 1:] = np.minimum.accumulate(cand - idx) + idx
        # account for the left border (M[i2+1,0] = i2+1) feeding rightwards
        border = (i2 + 1) + 1 + idx
        M[i2 + 1, 1:] = np.minimum(M[i2 + 1, 1:], border)
    return M


def edit_distance(s1: str, s2: str) -> int:
    """Final cell of edit_distance_full (used like the reference's
    M[(l1+1)*(l2+1)-1])."""
    lib = _get_native_lib()
    if lib is not None:
        return int(lib.edit_total(s1.encode("latin1"), len(s1),
                                  s2.encode("latin1"), len(s2)))
    return int(edit_distance_full(s1, s2)[len(s2), len(s1)])


def edit_distance_matrix(s1: str, s2: str) -> np.ndarray:
    """compute-alignments.c:210-236: matrix with rows over s1.
    Shape (len(s1)+1, len(s2)+1)."""
    return edit_distance_full(s2, s1)


def compute_edit_distance(s1: str, s2: str) -> int:
    if s1 == s2:
        return 0
    return edit_distance(s1, s2)


def compute_best_suffix_cut(s1: str, s2: str) -> Tuple[int, int, int]:
    """compute-alignments.c:251-292.  Returns (cut1, cut2, ed)."""
    l1, l2 = len(s1), len(s2)
    if s1 == s2:
        return l1, l2, 0
    matrix = edit_distance_matrix(s1, s2)
    mincol = int(matrix[l1, l2])
    minrow = int(matrix[l1, l2])
    mincolpos = l1
    minrowpos = l2
    for i in range(l1):
        if mincol >= matrix[i, l2]:
            mincol = int(matrix[i, l2])
            mincolpos = i
    for i in range(l2):
        if minrow >= matrix[l1, i]:
            minrow = int(matrix[l1, i])
            minrowpos = i
    if minrow < mincol:
        return l1, minrowpos, minrow
    return mincolpos, l2, mincol


def compute_best_prefix_cut(s1: str, s2: str) -> Tuple[int, int, int]:
    l1, l2 = len(s1), len(s2)
    if s1 == s2:
        return 0, 0, 0
    c1, c2, ed = compute_best_suffix_cut(s1[::-1], s2[::-1])
    return l1 - c1, l2 - c2, ed


import functools


@functools.lru_cache(maxsize=1 << 16)
def k_band_edit_distance(seq1: str, seq2: str, upper_bound: int
                         ) -> Tuple[bool, int]:
    """compute-alignments.c:319-453.  Returns (ok, edit)."""
    length1 = len(seq1)
    length2 = len(seq2)
    if length1 == length2 and seq1 == seq2:
        return True, 0
    if upper_bound == 0:
        return False, 1
    if length1 < length2:
        seq1, seq2 = seq2, seq1
        length1, length2 = length2, length1
    n, m = length1, length2
    if n - m > upper_bound:
        return False, n - m
    k = upper_bound
    if 2 * k + 1 >= n:
        edit = compute_edit_distance(seq1, seq2)
        return edit <= upper_bound, edit

    lib = _get_native_lib()
    if lib is not None:
        result = int(lib.kband_core(seq1.encode("latin1"), n,
                                    seq2.encode("latin1"), m, k))
        if result >= 0:
            return result <= upper_bound, result

    BIG = 1 << 60
    M1 = [BIG] * (2 * k + 1)
    M2 = [BIG] * (2 * k + 1)
    for c in range(k + 1):
        M1[k + c] = c
    for c in range(2 * k + 1):
        M2[c] = k + 1

    for r in range(1, k + 1):
        M2[k - r] = r
        for c in range(1, r + k):
            d = M1[k - r + c]
            if seq1[c - 1] != seq2[r - 1]:
                d += 1
            d = min(d, M2[k - r + c - 1] + 1)
            d = min(d, M1[k - r + c + 1] + 1)
            M2[k - r + c] = d
        d = M1[2 * k]
        if seq1[r + k - 1] != seq2[r - 1]:
            d += 1
        d = min(d, M2[2 * k - 1] + 1)
        M2[2 * k] = d
        M1, M2 = M2, M1

    for r in range(k + 1, n - k + 1):
        M2[0] = M1[0]
        if seq1[r - k - 1] != seq2[r - 1]:
            M2[0] += 1
        M2[0] = min(M2[0], M1[1] + 1)
        for c in range(r + 1 - k, r + k):
            d = M1[c + k - r]
            if seq1[c - 1] != seq2[r - 1]:
                d += 1
            d = min(d, M2[c + k - r - 1] + 1)
            d = min(d, M1[c + k - r + 1] + 1)
            M2[c + k - r] = d
        d = M1[2 * k]
        if seq1[r + k - 1] != seq2[r - 1]:
            d += 1
        d = min(d, M2[2 * k - 1] + 1)
        M2[2 * k] = d
        M1, M2 = M2, M1

    for r in range(n + 1 - k, m + 1):
        M2[0] = M1[0]
        if seq1[r - k - 1] != seq2[r - 1]:
            M2[0] += 1
        M2[0] = min(M2[0], M1[1] + 1)
        for c in range(r + 1 - k, n + 1):
            d = M1[c + k - r]
            if seq1[c - 1] != seq2[r - 1]:
                d += 1
            d = min(d, M2[c + k - r - 1] + 1)
            d = min(d, M1[c + k - r + 1] + 1)
            M2[c + k - r] = d
        M1, M2 = M2, M1

    result = M1[n + k - m]
    return result <= upper_bound, result
