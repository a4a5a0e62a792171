"""Three-matrix gap alignment for intron placement
(refine-intron.c:560-890).

State machine L (left exon) / G (intron gap, zero-cost on genomic) /
R (right exon): maximizes match score; the traceback records where the
genomic "intron" gap opens and closes both in genomic coordinates and in
alignment-string coordinates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from pintron_tpu_torch.native import get_lib, get_scratch


class GapAlignment:
    __slots__ = ("est", "gen", "factor_cut", "intron_start", "intron_end",
                 "intron_start_on_align", "intron_end_on_align",
                 "new_acceptor_factor_left", "new_donor_right_on_gen",
                 "new_acceptor_left_on_gen", "_est_b", "_gen_b")

    def __init__(self):
        self.est = ""
        self.gen = ""
        self.factor_cut = 0
        self.intron_start = 0
        self.intron_end = 0
        self.intron_start_on_align = 0
        self.intron_end_on_align = 0
        self.new_acceptor_factor_left = 0
        self.new_donor_right_on_gen = 0
        self.new_acceptor_left_on_gen = 0
        self._est_b = None
        self._gen_b = None

    def bytes_pair(self):
        """Cached latin-1 encodings of (est, gen); the alignment strings
        are never mutated after construction (callers only touch the
        new_* fields), so the cache is safe."""
        if self._est_b is None:
            self._est_b = self.est.encode("latin1")
            self._gen_b = self.gen.encode("latin1")
        return self._est_b, self._gen_b

    def copy(self) -> "GapAlignment":
        c = GapAlignment()
        for f in GapAlignment.__slots__:
            setattr(c, f, getattr(self, f))
        return c


# The alignment is a pure function of its two windows; candidate
# factorizations of the same EST (and neighbouring ESTs of the same
# locus) repeat windows, so memoize.  Callers mutate only the new_*
# fields, hence the copy-on-return.
_GAP_CACHE: dict = {}
_GAP_CACHE_MAX = 1 << 16


def compute_gap_alignment(est_seq: str, gen_seq: str) -> GapAlignment:
    key = (est_seq, gen_seq)
    cached = _GAP_CACHE.get(key)
    if cached is not None:
        return cached.copy()
    al = _compute_gap_alignment_uncached(est_seq, gen_seq)
    if len(_GAP_CACHE) >= _GAP_CACHE_MAX:
        _GAP_CACHE.clear()
    _GAP_CACHE[key] = al.copy()
    return al


def _compute_gap_alignment_uncached(est_seq: str, gen_seq: str
                                    ) -> GapAlignment:
    n = len(est_seq)
    m = len(gen_seq)

    lib = get_lib()
    if lib is not None:
        cap = n + m
        est_buf, gen_buf, out = get_scratch(cap)
        lib.gap_align_run(est_seq.encode("latin1"), n,
                          gen_seq.encode("latin1"), m,
                          est_buf, gen_buf, out)
        if out[0] >= 0:
            total = int(out[0])
            al = GapAlignment()
            al.est = est_buf.raw[:total].decode("latin1")
            al.gen = gen_buf.raw[:total].decode("latin1")
            al.factor_cut = int(out[1])
            al.intron_start = int(out[2])
            al.intron_end = int(out[3])
            al.intron_start_on_align = int(out[4])
            al.intron_end_on_align = int(out[5])
            return al

    e = np.frombuffer(est_seq.encode("latin1"), dtype=np.uint8)
    g = np.frombuffer(gen_seq.encode("latin1"), dtype=np.uint8)
    wild_e = (e == ord("n")) | (e == ord("N"))
    wild_g = (g == ord("n")) | (g == ord("N"))

    NEG = -(1 << 40)
    L = np.zeros((n + 1, m + 1), dtype=np.int64)
    G = np.zeros((n + 1, m + 1), dtype=np.int64)
    R = np.zeros((n + 1, m + 1), dtype=np.int64)
    Ldir = np.zeros((n + 1, m + 1), dtype=np.int8)
    Gdir = np.zeros((n + 1, m + 1), dtype=np.int8)
    Rdir = np.zeros((n + 1, m + 1), dtype=np.int8)

    # L matrix (refine-intron.c:666-712): row-wise with in-row left
    # dependency L[i,j] = max(diag +/- 1, L[i-1,j]-1, L[i,j-1]-1).
    for i in range(1, n + 1):
        match = (e[i - 1] == g) | wild_e[i - 1] | wild_g
        diag = L[i - 1, :-1] + np.where(match, 1, -1)
        up = L[i - 1, 1:] - 1
        cand = np.maximum(diag, up)
        # prefix-scan for the left dependency: val[j] = max(cand[j],
        # max_{k<j}(cand[k]-(j-k)), L[i,0]-j)
        idx = np.arange(m)
        vals = np.empty(m + 1, dtype=np.int64)
        vals[0] = 0  # L[i,0] stays 0 (C leaves column 0 as initialized)
        vals[1:] = np.maximum(np.maximum.accumulate(cand + idx) - idx,
                              -1 - idx)
        L[i, 1:] = vals[1:]
        # dirs with the reference's update order: start diag(0); replace
        # with up(1) if strictly greater; then left(2) if strictly greater.
        left = vals[:-1] - 1
        dirs = np.zeros(m, dtype=np.int8)
        dirs[(up > diag) & (left <= up)] = 1
        dirs[left > np.maximum(diag, up)] = 2
        Ldir[i, 1:] = dirs

    # G matrix (refine-intron.c:714-738): G[i,j] = max(G[i,j-1],
    # L[i,j-1]); dir 2 for stay-in-G, -2 for jump-to-L.
    for i in range(1, n + 1):
        lrow = L[i, :-1]
        # prefix max over L[i, 0..j-1]; G[i,0]=0
        run = np.maximum.accumulate(np.concatenate(([np.int64(0)], lrow)))
        G[i, 1:] = run[1:]
        # dir: -2 iff G[i,j-1] < L[i,j-1] (strict), else 2
        gprev = np.concatenate(([np.int64(0)], run[1:-1])) if m > 0 else run[:0]
        Gdir[i, 1:] = np.where(gprev < lrow, -2, 2).astype(np.int8)

    # R matrix (refine-intron.c:740-806): R[i,j] = max(diag+/-1,
    # R[i,j-1]-1 (or -0 on last row), G[i,j-1], R[i-1,j]-1) with the
    # reference's exact update order for directions.
    for i in range(1, n + 1):
        match = (e[i - 1] == g) | wild_e[i - 1] | wild_g
        diag = R[i - 1, :-1] + np.where(match, 1, -1)
        up = R[i - 1, 1:] - 1
        grow = G[i, :-1]
        horiz_cost = 0 if i == n else 1
        # candidates independent of in-row R: diag, grow, up (order matters
        # only for dir, value is max)
        cand = np.maximum(np.maximum(diag, grow), up)
        idx = np.arange(m)
        vals = np.empty(m + 1, dtype=np.int64)
        vals[0] = 0
        if horiz_cost == 1:
            vals[1:] = np.maximum(np.maximum.accumulate(cand + idx) - idx,
                                  -1 - idx)
        else:
            # zero-cost horizontal moves on the last row
            vals[1:] = np.maximum(np.maximum.accumulate(cand), 0)
        R[i, 1:] = vals[1:]
        # direction per the C update chain:
        #   start diag(0); if i_del (= R[i,j-1]-cost) strictly greater ->
        #   2; if G[i,j-1] strictly greater than current -> -2; if
        #   R[i-1,j]-1 strictly greater than current -> 1
        i_del = vals[:-1] - horiz_cost
        v1 = diag.copy()
        dirs = np.zeros(m, dtype=np.int8)
        upd = i_del > v1
        v1 = np.where(upd, i_del, v1)
        dirs = np.where(upd, 2, dirs).astype(np.int8)
        upd = grow > v1
        v1 = np.where(upd, grow, v1)
        dirs = np.where(upd, -2, dirs).astype(np.int8)
        upd = up > v1
        dirs = np.where(upd, 1, dirs).astype(np.int8)
        Rdir[i, 1:] = dirs

    return _gap_traceback(est_seq, gen_seq, Ldir, Gdir, Rdir,
                          int(L[n, m]), int(G[n, m]), int(R[n, m]))


def _gap_traceback(est_seq: str, gen_seq: str, Ldir, Gdir, Rdir,
                   Lnm: int, Gnm: int, Rnm: int) -> GapAlignment:
    n = len(est_seq)
    m = len(gen_seq)
    # start matrix selection (refine-intron.c:808-819)
    if Rnm >= Gnm:
        start_matrix = 2 if Rnm >= Lnm else 0
    else:
        start_matrix = 1 if Gnm >= Lnm else 0

    al = GapAlignment()
    est_al = []
    gen_al = []
    # iterative traceback equivalent to the recursive
    # TracebackGapAlignment (refine-intron.c:828-890): collect moves from
    # (n, m) down, then emit in forward order.
    moves = []  # (kind, i, j, jump_flag) kind: 'diag','up','left'
    i, j = n, m
    sm = start_matrix
    while i > 0 and j > 0:
        if sm == 2:
            d = Rdir[i, j]
        elif sm == 1:
            d = Gdir[i, j]
        else:
            d = Ldir[i, j]
        if d == 0:
            moves.append(("diag", i, j, False))
            i -= 1
            j -= 1
        elif d == 1:
            moves.append(("up", i, j, False))
            i -= 1
        else:
            jump = d == -2
            if jump:
                if sm == 2:
                    al.intron_end = j - 1
                    al.factor_cut = i
                else:
                    al.intron_start = j - 1
                sm -= 1
            moves.append(("left", i, j, jump))
            j -= 1
    while i > 0:
        moves.append(("up", i, j, False))
        i -= 1
    while j > 0:
        moves.append(("left", i, j, False))
        j -= 1

    # forward emission; record alignment-string positions of the jumps.
    # In the reference the jump flag refers to the move that *followed*
    # the recursive call: the '-' emitted at that step gets the position.
    # sm at emission time determines whether it closes (R->G: sm became 1)
    # or opens (G->L: sm became 0) the intron.
    dim = 0
    jump_positions = []  # (post_jump_sm, dim)
    sm = start_matrix
    for kind, mi, mj, jump in reversed(moves):
        if kind == "diag":
            est_al.append(est_seq[mi - 1])
            gen_al.append(gen_seq[mj - 1])
        elif kind == "up":
            est_al.append(est_seq[mi - 1])
            gen_al.append("-")
        else:
            est_al.append("-")
            gen_al.append(gen_seq[mj - 1])
            if jump:
                # note: reference decrements start_matrix before the
                # recursive call, so at emission the flag checks the
                # decremented value
                pass
        dim += 1
    # Recompute jump alignment positions: walk moves backward order =
    # emission order reversed; simpler: emit again tracking jumps.
    al.est = "".join(est_al)
    al.gen = "".join(gen_al)
    # jumps in traceback order (moves list): the LAST appended jump is the
    # earliest in the alignment.  Emission index of each move:
    total = len(moves)
    for k, (kind, mi, mj, jump) in enumerate(moves):
        if jump:
            pos = total - 1 - k  # index of this move in forward emission
            # sm transitions: first jump found walking backward from the
            # end is R->G (intron_end), second is G->L (intron_start)
            # (matching the reference's start_matrix bookkeeping).
            # Identify by which matrix we were in: recompute via counts.
            jump_positions.append(pos)
    if start_matrix == 2:
        if len(jump_positions) >= 1:
            al.intron_end_on_align = jump_positions[0]
        if len(jump_positions) >= 2:
            al.intron_start_on_align = jump_positions[1]
    elif start_matrix == 1:
        if len(jump_positions) >= 1:
            al.intron_start_on_align = jump_positions[0]
    return al
