"""Stage 6: maximal transcript assembly (TRANSCRIPTS1_*.txt).

Rebuild of src/MaximalTranscripts.c (reference): transcripts are exon-index
chains read from build-ests.txt; pairwise extension/inclusion predicates
build a DAG whose maximal paths are the full-length isoforms, followed by
containment filtering and an intron-support filter against
predicted-introns.txt.

Output identity requires reproducing several reference quirks exactly:

* ``Remove_Node_from_a_node_list`` (MaximalTranscripts.c:5247) empties the
  ENTIRE list when the node to remove is at the head (``next_one`` stays
  NULL); graph reduction then behaves as if the remaining in-neighbours
  were all handled.
* ``Set_Path_Transcripts_for_Source`` (2571, 2613) tests
  ``is_internal[x.right_ext == -2]`` — indexing with a boolean — instead
  of ``is_internal[x.right_ext] == -2``.
* ``Overlap`` with ``filt_phase`` (3789-3837) mutates the shared exon
  coordinate/sequence/polyA tables in place, so comparison order is
  semantically significant.
* first-exon left extensions append the donor prefix to the END of the
  exon sequence (3828-3830, ``strcat``).

Active reference build flags: STRONG_FIRST_LAST_MATCH, DONT_EXTEND_REFSEQ,
PRUNE_EXON_COMP, FILTER_BY_INTRONS, MULTI_FASTA_FORMAT, READ_ABS_COORD;
MERGE_POLYA and UPDATE_EXON disabled.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional

MAX_DIFF_FOR_REDUCING = 20   # MaximalTranscripts.c:65
MIN_POLYA_DIFF = 24          # :80
FIRST_MIN_EXONS = 1          # FIRST_MIN_EXONS_ACCEPTED_OUTPUT, :98
SECOND_MIN_EXONS = 4         # SECOND_MIN_EXONS_ACCEPTED_OUTPUT, :100
MIN_CONFIRMED_EST_INPUT = 1  # :102


def _min_dim_for_strength(_length: int) -> int:
    return 20  # MIN_DIM_FOR_STRENGTH, :71


def _min_dim_for_strength2(length: int) -> int:
    return 20 * length // 100  # MIN_DIM_FOR_STRENGTH2, :74 (C int division)


class Transcript:
    __slots__ = ("exons", "exon_list", "left_ext", "right_ext", "ESTs",
                 "type", "RefSeq")

    def __init__(self):
        self.exons = 0
        self.exon_list: List[int] = []
        self.left_ext = -1
        self.right_ext = -1
        self.ESTs = 0
        self.type = 0
        self.RefSeq = ""

    def copy(self) -> "Transcript":
        t = Transcript()
        t.exons = self.exons
        t.exon_list = self.exon_list[: self.exons - 2] if self.exons >= 2 else []
        t.left_ext = self.left_ext
        t.right_ext = self.right_ext
        t.type = self.type
        t.RefSeq = self.RefSeq
        # NB: Copy_transcript (:2364) does NOT copy ESTs
        return t


class Node:
    """C `struct node` for the graph-reduction linked lists."""
    __slots__ = ("index", "next")

    def __init__(self, index: int, nxt: "Optional[Node]" = None):
        self.index = index
        self.next = nxt


class Path:
    __slots__ = ("nodes", "end", "tr", "L", "visit")

    def __init__(self):
        self.nodes: List[int] = []
        self.end = -1
        self.tr: Optional[Transcript] = None
        self.L = 0
        self.visit = 0


def _substring(string: str, left: int, right: int) -> str:
    """Substring(:3455): inclusive [left, right]; empty when left > right."""
    if left > right:
        return ""
    if left < 0:
        raise RuntimeError("Substring with negative left (UB in reference)")
    return string[left:right + 1]


class _TxIndex:
    """Exact candidate index for the O(T^2) pairwise phases.

    overlap(t1, t2) can only be nonzero when check_L_suffix(t1.left_ext,
    e2) holds for some exon e2 of t2 — and every found-branch of
    check_L_suffix requires |R[e2]-R[e1]| <= 2 or |L[e2]-L[e1]| <= 2
    (MaximalTranscripts.c:3959 branch structure; the direct exon1 ==
    exon2 match has both gaps 0).  So the transcripts a given t1 can
    interact with are exactly those holding an exon within a +-2
    coordinate window of t1's first exon (direction 1), plus those whose
    first exon falls in a +-2 window of any exon of t1 (direction 2).
    The maps are updated by the _set_* mutation helpers whenever a
    phase's in-place exon-table repairs move coordinates or reassign a
    transcript's external exons, so candidate queries stay exact while
    the phase runs; `mutations` lets the phase loops re-query after any
    repair.  Failing pairs are side-effect-free in overlap/extends, so
    skipping non-candidates is output-identical to the full scan."""

    __slots__ = ("mt", "tl", "occ", "rmap", "lmap", "ler", "lel",
                 "left_of", "mutations")

    def __init__(self, mt: "MaximalTranscripts", tl: List["Transcript"]):
        self.mt = mt
        self.tl = tl
        self.occ: dict = {}      # exon -> {t_idx: count}
        self.rmap: dict = {}     # R coord -> set(exon)
        self.lmap: dict = {}     # L coord -> set(exon)
        self.ler: dict = {}      # R[left_ext] -> set(t_idx)
        self.lel: dict = {}      # L[left_ext] -> set(t_idx)
        self.left_of: dict = {}  # exon -> set(t_idx with left_ext == e)
        self.mutations = 0
        R, L = mt.right, mt.left
        for ti, t in enumerate(tl):
            for k in range(t.exons):
                e = _tx_exon_at(t, k)
                cnt = self.occ.setdefault(e, {})
                cnt[ti] = cnt.get(ti, 0) + 1
                self.rmap.setdefault(R[e], set()).add(e)
                self.lmap.setdefault(L[e], set()).add(e)
            e = t.left_ext
            self.ler.setdefault(R[e], set()).add(ti)
            self.lel.setdefault(L[e], set()).add(ti)
            self.left_of.setdefault(e, set()).add(ti)

    def candidates(self, i: int) -> List[int]:
        mt, tl = self.mt, self.tl
        R, L = mt.right, mt.left
        t = tl[i]
        out: set = set()
        e1 = t.left_ext
        for dv in (-2, -1, 0, 1, 2):
            for e2 in self.rmap.get(R[e1] + dv, ()):
                out.update(self.occ.get(e2, ()))
            for e2 in self.lmap.get(L[e1] + dv, ()):
                out.update(self.occ.get(e2, ()))
        for k in range(t.exons):
            e = _tx_exon_at(t, k)
            for dv in (-2, -1, 0, 1, 2):
                out.update(self.ler.get(R[e] + dv, ()))
                out.update(self.lel.get(L[e] + dv, ()))
        out.discard(i)
        return sorted(out)

    # -- mutation hooks ----------------------------------------------

    def exon_r_changed(self, e: int, old: int, new: int) -> None:
        if old == new:
            return
        s = self.rmap.get(old)
        if s is not None:
            s.discard(e)
        self.rmap.setdefault(new, set()).add(e)
        for ti in self.left_of.get(e, ()):
            s = self.ler.get(old)
            if s is not None:
                s.discard(ti)
            self.ler.setdefault(new, set()).add(ti)
        self.mutations += 1

    def exon_l_changed(self, e: int, old: int, new: int) -> None:
        if old == new:
            return
        s = self.lmap.get(old)
        if s is not None:
            s.discard(e)
        self.lmap.setdefault(new, set()).add(e)
        for ti in self.left_of.get(e, ()):
            s = self.lel.get(old)
            if s is not None:
                s.discard(ti)
            self.lel.setdefault(new, set()).add(ti)
        self.mutations += 1

    def _occ_del(self, e: int, ti: int) -> None:
        cnt = self.occ.get(e)
        if cnt is None:
            return
        c = cnt.get(ti, 0)
        if c <= 1:
            cnt.pop(ti, None)
        else:
            cnt[ti] = c - 1

    def _occ_add(self, e: int, ti: int) -> None:
        cnt = self.occ.setdefault(e, {})
        cnt[ti] = cnt.get(ti, 0) + 1
        R, L = self.mt.right, self.mt.left
        self.rmap.setdefault(R[e], set()).add(e)
        self.lmap.setdefault(L[e], set()).add(e)

    def left_ext_changed(self, ti: int, old: int, new: int) -> None:
        if old == new:
            return
        R, L = self.mt.right, self.mt.left
        self._occ_del(old, ti)
        self._occ_add(new, ti)
        s = self.left_of.get(old)
        if s is not None:
            s.discard(ti)
        self.left_of.setdefault(new, set()).add(ti)
        s = self.ler.get(R[old])
        if s is not None:
            s.discard(ti)
        self.ler.setdefault(R[new], set()).add(ti)
        s = self.lel.get(L[old])
        if s is not None:
            s.discard(ti)
        self.lel.setdefault(L[new], set()).add(ti)
        self.mutations += 1

    def right_ext_changed(self, ti: int, old: int, new: int) -> None:
        if old == new:
            return
        self._occ_del(old, ti)
        self._occ_add(new, ti)
        self.mutations += 1


def _tx_exon_at(t: "Transcript", k: int) -> int:
    if k == 0:
        return t.left_ext
    if k == t.exons - 1:
        return t.right_ext
    return t.exon_list[k - 1]


class MaximalTranscripts:
    def __init__(self):
        self.gen_start = 0
        self.gen_end = 0
        self.strand = 0
        self.boundary = 0
        self.number_of_exons = 0
        self.left: List[int] = []      # list_of_exon_left
        self.right: List[int] = []     # list_of_exon_right
        self.old_left: List[int] = []
        self.old_right: List[int] = []
        self.polya: List[int] = []
        self.sequences: List[Optional[str]] = []
        self.is_internal: List[int] = []
        self.init_reading = ""
        self.init_reading2 = ""
        self.transcripts: List[Transcript] = []
        self.matrix: List[List[int]] = []
        self.in_degree: List[int] = []
        self.out_degree: List[int] = []
        self.source_list: List[int] = []
        # path enumeration state
        self.path_transcripts: List[Transcript] = []
        self.transcript_paths: List[List[Path]] = []
        self.source_path_transcripts: List[Transcript] = []
        self.source_paths: List[List[Path]] = []
        self.source_total_paths = 0
        self.total_paths = 0
        self.filtered: List[int] = []
        self._ix: Optional[_TxIndex] = None

    # -- candidate index plumbing --------------------------------------

    def _index_for(self, tl: List["Transcript"]) -> Optional[_TxIndex]:
        import os
        if os.environ.get("PINTRON_NO_TX_INDEX"):
            return None
        self._ix = _TxIndex(self, tl)
        return self._ix

    def _set_r(self, e: int, new: int) -> None:
        old = self.right[e]
        self.right[e] = new
        if self._ix is not None:
            self._ix.exon_r_changed(e, old, new)

    def _set_l(self, e: int, new: int) -> None:
        old = self.left[e]
        self.left[e] = new
        if self._ix is not None:
            self._ix.exon_l_changed(e, old, new)

    def _set_left_ext(self, tl, ti: int, new: int) -> None:
        old = tl[ti].left_ext
        tl[ti].left_ext = new
        if self._ix is not None and self._ix.tl is tl:
            self._ix.left_ext_changed(ti, old, new)

    def _set_right_ext(self, tl, ti: int, new: int) -> None:
        old = tl[ti].right_ext
        tl[ti].right_ext = new
        if self._ix is not None and self._ix.tl is tl:
            self._ix.right_ext_changed(ti, old, new)

    # ------------------------------------------------------------------
    # Input (Get_Transcripts_from_File, :1233)
    # ------------------------------------------------------------------

    def read_input(self, tokens: List[str]) -> None:
        it = iter(tokens)

        def nx() -> str:
            return next(it)

        self.gen_start = int(nx())
        self.gen_end = int(nx())
        self.strand = int(nx())
        self.boundary = int(nx())

        first3 = [nx(), nx(), nx()]
        self.number_of_exons = int(first3[1])
        # init_reading: only line i==2 under MULTI_FASTA_FORMAT (:1282-1289)
        self.init_reading = first3[2] + "\n"
        self.init_reading2 = first3[1] + "\n" + first3[2] + "\n"

        n = self.number_of_exons
        self.left = [0] * n
        self.right = [0] * n
        self.old_left = [0] * n
        self.old_right = [0] * n
        self.polya = [0] * n
        self.sequences = [None] * n
        self.is_internal = [0] * n

        tok = ""
        if n > 0:
            count = 0
            while True:
                tok = nx()
                if tok.startswith("."):
                    break
                parts = tok.split(":")
                self.left[count] = int(parts[0])
                self.old_left[count] = self.left[count]
                self.right[count] = int(parts[1])
                self.old_right[count] = self.right[count]
                if len(parts) > 2:
                    self.polya[count] = int(parts[2])
                count += 1

        # transcripts (:1554-1751)
        if n == 0:
            return
        while True:
            header = tok  # starts with '.'
            body = header[1:]
            dot = body.find(".")
            if dot == -1:
                confirming = int(body)
                refseq = ""
            else:
                confirming = int(body[:dot])
                refseq = body[dot + 1:]
            ttype = 1 if refseq else 0

            chain = [int(x) for x in nx().split(".") if x != ""]
            exons1 = len(chain)

            exons2 = 0
            while True:
                tok = nx()
                if tok.startswith(".") or tok.startswith("#"):
                    break
                if self.sequences[chain[exons2]] is None:
                    self.sequences[chain[exons2]] = tok
                exons2 += 1

            if exons1 == 0 or exons2 == 0 or exons1 != exons2:
                raise ValueError("Invalid transcript in input file")

            if (exons1 >= 1 and confirming >= MIN_CONFIRMED_EST_INPUT) \
                    and not (exons1 == 1 and ttype != 1):
                t = Transcript()
                t.exons = exons1
                t.ESTs = confirming
                t.type = ttype
                t.RefSeq = refseq
                t.left_ext = chain[0]
                if self.polya[t.left_ext] == 1:
                    self.polya[t.left_ext] = 0
                # is_internal state machine for the first exon (:1690-1715)
                ii = self.is_internal
                e0 = chain[0]
                if ii[e0] != 1:
                    if ii[e0] == 0:
                        ii[e0] = -3 if exons1 == 1 else -1
                    elif ii[e0] == -2:
                        if exons1 > 1:
                            ii[e0] = 1
                    else:
                        if ii[e0] != -1 and exons1 > 1:
                            ii[e0] = -1
                for k in range(1, exons1 - 1):
                    ii[chain[k]] = 1
                    t.exon_list.append(chain[k])
                    if self.polya[chain[k]] == 1:
                        self.polya[chain[k]] = 0
                t.right_ext = chain[exons1 - 1]
                elast = chain[exons1 - 1]
                if exons1 > 1 and ii[elast] != 1:
                    if ii[elast] == 0:
                        ii[elast] = 1 if self.polya[elast] == 1 else -2
                    elif ii[elast] == -1:
                        ii[elast] = 1
                self.transcripts.append(t)

            if tok.startswith("#"):
                break

    # ------------------------------------------------------------------
    # Matching predicates (Check_*, Overlap, Extends)
    # ------------------------------------------------------------------

    def check_L_suffix(self, exon1: int, exon2: int) -> "tuple[int, int]":
        """Check_L_suffix (:3959). Returns (found, matching_strength)."""
        ii, L, R = self.is_internal, self.left, self.right
        if ii[exon1] == -2:
            raise RuntimeError("Problem in Check_L_suffix!")
        strength = 1
        right_gap = R[exon2] - R[exon1]
        left_gap = L[exon2] - L[exon1]
        if ii[exon1] == 1 and ii[exon2] == 1:
            if right_gap > 2 or right_gap < -2:
                return 0, strength
            if left_gap > 2 or left_gap < -2:
                return 0, strength
            return 1, strength
        if ii[exon2] == 1:
            if right_gap > 2 or right_gap < -2:
                return 0, strength
            if left_gap > MAX_DIFF_FOR_REDUCING:
                return 0, strength
            ref_length = R[exon2] - L[exon2] + 1
            if R[exon1] - L[exon1] + 1 < _min_dim_for_strength2(ref_length):
                return 0, strength
            return 1, strength
        if ii[exon1] == 1:
            if ii[exon2] == -1:
                if right_gap > 2 or right_gap < -2:
                    return 0, strength
                if left_gap < -MAX_DIFF_FOR_REDUCING \
                        or left_gap > MAX_DIFF_FOR_REDUCING:
                    return 0, strength
                ref_length = R[exon1] - L[exon1] + 1
                if R[exon2] - L[exon2] + 1 < _min_dim_for_strength(ref_length):
                    return 0, strength
                return 1, strength
            else:
                if left_gap > 2 or left_gap < -2:
                    return 0, strength
                if right_gap > MAX_DIFF_FOR_REDUCING \
                        or right_gap < -MAX_DIFF_FOR_REDUCING:
                    return 0, strength
                ref_length = R[exon1] - L[exon1] + 1
                if R[exon2] - L[exon2] + 1 < _min_dim_for_strength(ref_length):
                    return 0, strength
                return 1, strength
        if ii[exon2] == -1:
            # both left-externals
            if right_gap > 2 or right_gap < -2:
                return 0, strength
            if L[exon2] < L[exon1]:
                ref_length = R[exon2] - L[exon2] + 1
                if R[exon1] - L[exon1] + 1 < _min_dim_for_strength(ref_length):
                    strength = 0
            else:
                ref_length = R[exon1] - L[exon1] + 1
                if R[exon2] - L[exon2] + 1 < _min_dim_for_strength(ref_length):
                    strength = 0
        else:
            # exon2 is a right-external (STRONG_FIRST_LAST_MATCH branch)
            if left_gap > 2 or left_gap < -2:
                return 0, strength
            if right_gap > 2 or right_gap < -2:
                return 0, strength
            ref_length = 0  # reference leaves ref_length at 0 here (:3965)
            if L[exon2] < L[exon1]:
                if R[exon2] < R[exon1]:
                    if R[exon2] - L[exon1] + 1 < _min_dim_for_strength(ref_length):
                        return 0, strength
                else:
                    if R[exon1] - L[exon1] + 1 < _min_dim_for_strength(ref_length):
                        return 0, strength
            else:
                if R[exon2] < R[exon1]:
                    if R[exon2] - L[exon2] + 1 < _min_dim_for_strength(ref_length):
                        return 0, strength
                else:
                    if R[exon1] - L[exon2] + 1 < _min_dim_for_strength(ref_length):
                        return 0, strength
            strength = 0
        return 1, strength

    def check_R_prefix(self, exon1: int, exon2: int) -> "tuple[int, int]":
        """Check_R_prefix (:4244). Returns (found, matching_strength)."""
        ii, L, R = self.is_internal, self.left, self.right
        if ii[exon1] == -1 or ii[exon2] == -1:
            raise RuntimeError("Problem in Check_R_prefix!")
        strength = 1
        left_gap = L[exon2] - L[exon1]
        if left_gap > 2 or left_gap < -2:
            return 0, strength
        right_gap = R[exon2] - R[exon1]
        if ii[exon1] == 1 and ii[exon2] == 1:
            threshold = MIN_POLYA_DIFF \
                if (self.polya[exon1] == 1 and self.polya[exon2]) else 2
            if right_gap > threshold or right_gap < -threshold:
                return 0, strength
            return 1, strength
        if ii[exon2] == 1:
            if right_gap < -MAX_DIFF_FOR_REDUCING:
                return 0, strength
            ref_length = R[exon2] - L[exon2] + 1
            if R[exon1] - L[exon1] + 1 < _min_dim_for_strength(ref_length):
                return 0, strength
            return 1, strength
        if ii[exon1] == 1:
            if right_gap > MAX_DIFF_FOR_REDUCING \
                    or right_gap < -MAX_DIFF_FOR_REDUCING:
                return 0, strength
            ref_length = R[exon1] - L[exon1] + 1
            if R[exon2] - L[exon2] + 1 < _min_dim_for_strength(ref_length):
                return 0, strength
            return 1, strength
        # both right-externals
        if R[exon2] > R[exon1]:
            ref_length = R[exon2] - L[exon2] + 1
            if R[exon1] - L[exon1] + 1 < _min_dim_for_strength(ref_length):
                strength = 0
        else:
            ref_length = R[exon1] - L[exon1] + 1
            if R[exon2] - L[exon2] + 1 < _min_dim_for_strength(ref_length):
                strength = 0
        return 1, strength

    def check_exons(self, exon1: int, exon2: int) -> int:
        L, R = self.left, self.right
        left_gap = L[exon2] - L[exon1]
        if left_gap > 2 or left_gap < -2:
            return 0
        right_gap = R[exon2] - R[exon1]
        if right_gap > 2 or right_gap < -2:
            return 0
        return 1

    def overlap(self, t1: Transcript, t2: Transcript, for_ext: int,
                force_polya: int, filt_phase: int) -> "tuple[int, int]":
        """Overlap (:3638). Returns (result, L)."""
        L_, R_, ii, seqs = self.left, self.right, self.is_internal, self.sequences
        if force_polya and (self.polya[t2.right_ext] == 1 and for_ext):
            return 0, 0

        def exon_at(t: Transcript, k: int) -> int:
            if k == 0:
                return t.left_ext
            if k == t.exons - 1:
                return t.right_ext
            return t.exon_list[k - 1]

        first_exon1 = t1.left_ext
        found = 0
        strength_l = 0
        k = 0
        current_exon2 = -1
        while not found and k < t2.exons:
            current_exon2 = exon_at(t2, k)
            if first_exon1 == current_exon2:
                found = 1
                strength_l = 1
            else:
                found, strength_l = self.check_L_suffix(first_exon1,
                                                        current_exon2)
            if not found:
                k += 1
        if not found:
            return 0, 0
        if t1.exons == 1:
            return 2, k
        if t2.exons == 1:
            return 0, 0
        l = k + 1
        j = 1
        if l == t2.exons:
            return 0, 0  # STRONG_FIRST_LAST_MATCH (:3719-3720)
        int_match = 0
        stop = 0
        while l < t2.exons - 1 and j < t1.exons - 1 and not stop:
            int_match = 1 if t1.exon_list[j - 1] == t2.exon_list[l - 1] else 0
            if not int_match:
                int_match = self.check_exons(t1.exon_list[j - 1],
                                             t2.exon_list[l - 1])
            if int_match:
                l += 1
                j += 1
            else:
                stop = 1
        if stop:
            return 0, 0
        if l == t2.exons - 1 and j == t1.exons - 1:
            last1, last2 = t1.right_ext, t2.right_ext
            if last1 == last2:
                match, strength_r = 1, 1
            else:
                match, strength_r = self.check_R_prefix(last1, last2)
            if match and (int_match or (strength_l == 1 and strength_r == 1)):
                if filt_phase:
                    # in-place exon table mutations (:3789-3837)
                    if self.polya[last1] == 1 or self.polya[last2] == 1:
                        if not (ii[last2] == 1 and self.polya[last2] == 0) \
                                and R_[last1] > R_[last2] and t2.type != 1:
                            s1 = seqs[last1]
                            idx = len(s1) - R_[last1] + R_[last2] \
                                + (L_[last1] - L_[last2])
                            seqs[last2] = seqs[last2] \
                                + _substring(s1, idx, len(s1) - 1)
                            self._set_r(last2, R_[last1])
                        if not (ii[last2] == 1 and self.polya[last2] == 0):
                            self.polya[last2] = 1
                    else:
                        if ii[last2] != 1 and t2.type != 1:
                            if R_[last1] > R_[last2] \
                                    and R_[last1] - R_[last2] <= 50:
                                s1 = seqs[last1]
                                idx = len(s1) - R_[last1] + R_[last2] \
                                    + (L_[last1] - L_[last2])
                                seqs[last2] = seqs[last2] \
                                    + _substring(s1, idx, len(s1) - 1)
                                self._set_r(last2, R_[last1])
                    if k == 0:
                        if ii[current_exon2] != 1 and t2.type != 1:
                            if L_[first_exon1] < L_[current_exon2] \
                                    and L_[current_exon2] - L_[first_exon1] <= 50:
                                s1 = seqs[first_exon1]
                                # reference appends the recovered prefix to
                                # the END of the sequence (:3828-3830)
                                seqs[current_exon2] = seqs[current_exon2] \
                                    + _substring(
                                        s1, 0,
                                        L_[current_exon2] - L_[first_exon1] - 1)
                                self._set_l(current_exon2, L_[first_exon1])
                return 2, k
            return 0, 0
        if l == t2.exons - 1:
            last1 = t1.exon_list[j - 1]
            last2 = t2.right_ext
            if last1 == last2:
                match, strength_r = 1, 1
            else:
                match, strength_r = self.check_R_prefix(last1, last2)
            if match:
                if k == 0:
                    return 0, 0
                if int_match or (strength_l == 1 and strength_r == 1):
                    return 1, k
                return 0, 0
            return 0, 0
        if j == t1.exons - 1:
            last1 = t1.right_ext
            last2 = t2.exon_list[l - 1]
            if last1 == last2:
                match, strength_r = 1, 1
            else:
                match, strength_r = self.check_R_prefix(last1, last2)
            if match:
                if (self.polya[last1] == 0 or not force_polya) \
                        and (int_match or (strength_l == 1 and strength_r == 1)):
                    if filt_phase and k == 0:
                        if ii[current_exon2] != 1 and t2.type != 1:
                            if L_[first_exon1] < L_[current_exon2] \
                                    and L_[current_exon2] - L_[first_exon1] <= 50:
                                s1 = seqs[first_exon1]
                                seqs[current_exon2] = seqs[current_exon2] \
                                    + _substring(
                                        s1, 0,
                                        L_[current_exon2] - L_[first_exon1] - 1)
                                self._set_l(current_exon2, L_[first_exon1])
                    return 2, k
                return 0, 0
            return 0, 0
        raise RuntimeError("An impossible thing has happened!")

    def extends(self, t1: Transcript, t2: Transcript, for_ext: int,
                force_polya: int, filt_phase: int) -> "tuple[int, int]":
        """Extends (:3582). Returns (result, L)."""
        r, L = self.overlap(t1, t2, for_ext, force_polya, filt_phase)
        if r == 1:
            return -1, L
        if r == 2:
            return -2, L
        r, L2 = self.overlap(t2, t1, for_ext, force_polya, filt_phase)
        if r == 1:
            return 1, L2
        if r == 2:
            return 2, L2
        return 0, L

    # ------------------------------------------------------------------
    # First_Filtering (:5274)
    # ------------------------------------------------------------------

    def _scan_pairs(self, n: int, body, skip_i=None) -> None:
        """Run ``body(i, j)`` over ordered pairs i < j in ascending j,
        ending i's scan when body returns truthy — either the plain
        O(n^2) scan, or (when the candidate index is active) only over
        pairs the index proves can interact, re-querying after any
        exon-table mutation so candidacy stays exact."""
        ix = self._ix
        if ix is None:
            i = 0
            while i < n:
                if skip_i is not None and skip_i(i):
                    i += 1
                    continue
                j = i + 1
                stop = 0
                while j < n and not stop:
                    stop = body(i, j)
                    j += 1
                i += 1
            return
        i = 0
        while i < n:
            if skip_i is not None and skip_i(i):
                i += 1
                continue
            jj = i + 1
            stop = 0
            while jj < n and not stop:
                cands = [c for c in ix.candidates(i) if jj <= c < n]
                if not cands:
                    break
                mut0 = ix.mutations
                exhausted = True
                for j in cands:
                    stop = body(i, j)
                    if stop:
                        break
                    if ix.mutations != mut0:
                        jj = j + 1
                        exhausted = False
                        break
                if exhausted or stop:
                    break
            i += 1

    def first_filtering(self) -> None:
        tl = self.transcripts
        n = len(tl)
        contained = [0] * n
        ii, L_, R_ = self.is_internal, self.left, self.right
        self._index_for(tl)

        def body(i: int, j: int) -> int:
            stop = 0
            if tl[i].type == 1:
                if tl[j].type == 0:
                    inclusion, limit = self.overlap(tl[j], tl[i], 0, 1, 1)
                else:
                    inclusion, limit = 0, 0
            else:
                if tl[j].type == 1:
                    inclusion, limit = self.overlap(tl[i], tl[j], 0, 1, 1)
                    if inclusion == 2:
                        inclusion = -2
                else:
                    inclusion, limit = self.extends(tl[i], tl[j], 0, 1, 1)
            if inclusion in (-2, 2):
                if limit == 0 and tl[i].exons == tl[j].exons:
                    if inclusion == -2:
                        if tl[j].type != 1:
                            if R_[tl[j].left_ext] == R_[tl[i].left_ext] \
                                    and limit == 0:
                                if ii[tl[j].left_ext] == -1:
                                    if ii[tl[i].left_ext] == 1:
                                        self._set_left_ext(tl, j, tl[i].left_ext)
                                    elif ii[tl[i].left_ext] == -1 and \
                                            L_[tl[i].left_ext] < L_[tl[j].left_ext]:
                                        self._set_left_ext(tl, j, tl[i].left_ext)
                            if L_[tl[j].right_ext] == L_[tl[i].right_ext] \
                                    and limit + tl[i].exons == tl[j].exons:
                                if ii[tl[j].right_ext] == -2:
                                    if ii[tl[i].right_ext] == 1:
                                        self._set_right_ext(tl, j, tl[i].right_ext)
                                    elif ii[tl[i].right_ext] == -2 and \
                                            R_[tl[i].right_ext] > R_[tl[j].right_ext]:
                                        self._set_right_ext(tl, j, tl[i].right_ext)
                        contained[i] = 1
                        tl[j].ESTs += tl[i].ESTs
                        stop = 1
                    else:
                        if tl[i].type != 1:
                            if R_[tl[j].left_ext] == R_[tl[i].left_ext] \
                                    and limit == 0:
                                if ii[tl[i].left_ext] == -1:
                                    if ii[tl[j].left_ext] == 1:
                                        self._set_left_ext(tl, i, tl[j].left_ext)
                                    elif ii[tl[j].left_ext] == -1 and \
                                            L_[tl[j].left_ext] < L_[tl[i].left_ext]:
                                        self._set_left_ext(tl, i, tl[j].left_ext)
                            if L_[tl[j].right_ext] == L_[tl[i].right_ext] \
                                    and limit + tl[j].exons == tl[i].exons:
                                if ii[tl[i].right_ext] == -2:
                                    if ii[tl[j].right_ext] == 1:
                                        self._set_right_ext(tl, i, tl[j].right_ext)
                                    elif ii[tl[j].right_ext] == -2 and \
                                            R_[tl[j].right_ext] > R_[tl[i].right_ext]:
                                        self._set_right_ext(tl, i, tl[j].right_ext)
                        contained[j] = 1
                        tl[i].ESTs += tl[j].ESTs
            return stop

        self._scan_pairs(n, body, skip_i=lambda i: contained[i])
        self._ix = None
        self.transcripts = [tl[i] for i in range(n) if not contained[i]]

    # ------------------------------------------------------------------
    # Build_Extension_Matrix (:1756) + Graph_reduction (:4886)
    # ------------------------------------------------------------------

    def build_extension_matrix(self) -> None:
        tl = self.transcripts
        n = len(tl)
        # sparse extension matrix: rows map j -> limit (nonzero edges
        # only; overlap result 1 always has limit >= 1), plus column
        # sets for the in-neighbour scans.  All scans iterate sorted
        # keys, reproducing the dense ascending-index order.
        self.matrix = [dict() for _ in range(n)]
        self.matrix_cols = [set() for _ in range(n)]
        self.in_degree = [0] * n
        self.out_degree = [0] * n
        self._index_for(tl)

        def body(i: int, j: int) -> int:
            if tl[i].type == 1 or tl[j].type == 1:
                ext, limit = 0, 0
            else:
                ext, limit = self.extends(tl[i], tl[j], 1, 1, 0)
            if ext == 1:
                if limit != 0:
                    self.matrix[i][j] = limit
                    self.matrix_cols[j].add(i)
                self.out_degree[i] += 1
                self.in_degree[j] += 1
            elif ext == -1:
                if limit != 0:
                    self.matrix[j][i] = limit
                    self.matrix_cols[i].add(j)
                self.out_degree[j] += 1
                self.in_degree[i] += 1
            return 0

        self._scan_pairs(n, body)
        self._ix = None

    def _remove_node(self, head: Optional[Node], node: int) -> Optional[Node]:
        """Remove_Node_from_a_node_list (:5247), including the head-removal
        truncation: removing the head element empties the whole list."""
        nds = head
        prev = None
        next_one = None
        stop = False
        while nds is not None and not stop:
            if nds.index == node:
                stop = True
            else:
                prev = nds
                nds = nds.next
                next_one = nds.next if nds is not None else None
        if prev is None:
            return next_one  # head match -> next_one is still None -> []
        prev.next = next_one
        return head

    def _mzero(self, i: int, j: int) -> None:
        self.matrix[i].pop(j, None)
        self.matrix_cols[j].discard(i)

    def _partial_reduction_for_node(self, a: int, b: int, c: int) -> None:
        m = self.matrix
        out_node_list: Optional[Node] = None
        node_list: Optional[Node] = None
        no_outcoming = 1
        for i in sorted(m[c]):
            if i != b:
                no_outcoming = 0
                out_node_list = Node(i, out_node_list)
        for i in sorted(self.matrix_cols[c]):
            if i != a:
                node_list = Node(i, node_list)

        help_node_list: Optional[Node] = None
        head = node_list
        while head is not None:
            nxt = head.next
            if a in m[head.index]:
                self._mzero(head.index, c)
                self.out_degree[head.index] -= 1
                self.in_degree[c] -= 1
                help_node_list = Node(head.index, help_node_list)
                node_list = self._remove_node(node_list, head.index)
            elif b in m[head.index]:
                if no_outcoming:
                    self._mzero(head.index, c)
                    self.out_degree[head.index] -= 1
                    self.in_degree[c] -= 1
                    help_node_list = Node(head.index, help_node_list)
                    node_list = self._remove_node(node_list, head.index)
                else:
                    attached = 1
                    oh = out_node_list
                    while oh is not None and attached:
                        if oh.index not in m[head.index]:
                            attached = 0
                        oh = oh.next
                    if attached:
                        self._mzero(head.index, c)
                        self.out_degree[head.index] -= 1
                        self.in_degree[c] -= 1
                        help_node_list = Node(head.index, help_node_list)
                        node_list = self._remove_node(node_list, head.index)
            head = nxt

        changed = True
        while changed:
            changed = False
            head = node_list
            while head is not None:
                stop = False
                hh = help_node_list
                while hh is not None and not stop:
                    if hh.index in m[head.index]:
                        stop = True
                        changed = True
                        self._mzero(head.index, c)
                        self.out_degree[head.index] -= 1
                        self.in_degree[c] -= 1
                        help_node_list = Node(head.index, help_node_list)
                        nxt = head.next
                        node_list = self._remove_node(node_list, head.index)
                        head = nxt
                    else:
                        hh = hh.next
                if not stop:
                    head = head.next

        if node_list is None:
            self._mzero(c, b)
            self.out_degree[c] -= 1
            self.in_degree[b] -= 1

    def graph_reduction(self) -> None:
        n = len(self.transcripts)
        m = self.matrix
        for i in range(n):
            for j in sorted(m[i]):
                if j in m[i]:
                    # Partial_Graph_reduction_for_arc (:5027)
                    initial = 0
                    while True:
                        c = -1
                        if j in m[i]:
                            for cand in sorted(m[i]):
                                if cand >= initial and j in m[cand]:
                                    c = cand
                                    break
                        if c == -1:
                            break
                        self._partial_reduction_for_node(i, j, c)
                        initial = c + 1

    # ------------------------------------------------------------------
    # Path enumeration (Set_Paths, :2054)
    # ------------------------------------------------------------------

    def _build_extension(self, t1: Transcript, t2: Transcript,
                         L: int) -> Transcript:
        """Build_extension (:2282)."""
        ext = Transcript()
        ext.exons = t2.exons + L
        ext.left_ext = t1.left_ext
        ext.exon_list = [0] * (ext.exons - 2)
        i = 0
        for i in range(t1.exons - 2):
            ext.exon_list[i] = t1.exon_list[i]
        i = t1.exons - 2
        if i - L < 0:
            if self.is_internal[t1.right_ext] == 1 \
                    or self.is_internal[t2.left_ext] != 1:
                ext.exon_list[i] = t1.right_ext
            else:
                ext.exon_list[i] = t2.left_ext
            i += 1
        while i < ext.exons - 2:
            ext.exon_list[i] = t2.exon_list[i - L]
            i += 1
        ext.right_ext = t2.right_ext
        ext.type = 0
        ext.RefSeq = ""
        return ext

    @staticmethod
    def _equals_transcripts(t1: Transcript, t2: Transcript) -> bool:
        if t1.exons != t2.exons:
            return False
        if t1.left_ext != t2.left_ext or t1.right_ext != t2.right_ext:
            return False
        return t1.exon_list[:t1.exons - 2] == t2.exon_list[:t2.exons - 2]

    def _copy_path(self, p: Path) -> Path:
        c = Path()
        c.nodes = list(p.nodes)
        c.end = p.end
        c.tr = p.tr.copy()
        c.L = p.L
        c.visit = p.visit
        return c

    def _add_path(self, path_list: List[Path], p: Path) -> None:
        """Add_Path (:4791): dedup by node sequence, then prepend."""
        copy = self._copy_path(p)
        for q in path_list:
            if q.nodes == copy.nodes:
                return
        path_list.insert(0, copy)

    def _set_path_transcripts_for_source(self, path: Path) -> None:
        """Set_Path_Transcripts_for_Source (:2458)."""
        ii, L_, R_ = self.is_internal, self.left, self.right
        spt = self.source_path_transcripts
        i = 0
        stop = False
        while i < self.source_total_paths and not stop:
            included, typ = self.extends(spt[i], path.tr, 0, 1, 0)
            if included in (2, -2):
                if included == 2:
                    if R_[spt[i].left_ext] == R_[path.tr.left_ext] and typ == 0:
                        if ii[spt[i].left_ext] == -1:
                            if ii[path.tr.left_ext] == 1:
                                spt[i].left_ext = path.tr.left_ext
                            elif ii[path.tr.left_ext] == -1 and \
                                    L_[path.tr.left_ext] < L_[spt[i].left_ext]:
                                spt[i].left_ext = path.tr.left_ext
                    if L_[spt[i].right_ext] == L_[path.tr.right_ext] \
                            and typ + path.tr.exons == spt[i].exons:
                        # reference bug: is_internal[x.right_ext == -2]
                        # (:2571) indexes with the boolean
                        if ii[1 if spt[i].right_ext == -2 else 0]:
                            if ii[path.tr.right_ext] == 1:
                                spt[i].right_ext = path.tr.right_ext
                            elif ii[path.tr.right_ext] == -2 and \
                                    R_[path.tr.right_ext] > R_[spt[i].right_ext]:
                                spt[i].right_ext = path.tr.right_ext
                else:
                    if R_[spt[i].left_ext] == R_[path.tr.left_ext] and typ == 0:
                        if ii[path.tr.left_ext] == -1:
                            if ii[spt[i].left_ext] == 1:
                                path.tr.left_ext = spt[i].left_ext
                            elif ii[spt[i].left_ext] == -1 and \
                                    L_[spt[i].left_ext] < L_[path.tr.left_ext]:
                                path.tr.left_ext = spt[i].left_ext
                    if L_[spt[i].right_ext] == L_[path.tr.right_ext] \
                            and typ + spt[i].exons == path.tr.exons:
                        # reference bug (:2613), same boolean-index form
                        if ii[1 if path.tr.right_ext == -2 else 0]:
                            if ii[spt[i].right_ext] == 1:
                                path.tr.right_ext = spt[i].right_ext
                            elif ii[spt[i].right_ext] == -2 and \
                                    R_[spt[i].right_ext] > R_[path.tr.right_ext]:
                                path.tr.right_ext = spt[i].right_ext
                stop = True
                if included == -2:
                    self.source_path_transcripts[i] = path.tr.copy()
                    self._add_path(self.source_paths[i], path)
            else:
                i += 1
        if not stop:
            self.source_path_transcripts.append(path.tr.copy())
            self.source_paths.append([])
            self._add_path(self.source_paths[self.source_total_paths], path)
            self.source_total_paths += 1

    def _set_paths_for_source(self, source_index: int) -> None:
        """Set_Paths_for_Source (:2078): BFS over the extension DAG.

        The reference's PRUNE_EXON_COMP scans every live queue entry for
        a transcript equal to the new path's; here the live entries are
        indexed by the exact equality key (exons, left_ext, right_ext,
        exon chain), so the first live match is found in O(1) with
        identical semantics (dequeued entries leave the window lazily).
        """
        import collections

        self.source_paths = []
        self.source_path_transcripts = []
        self.source_total_paths = 0
        queue: List[Path] = []
        qhead = 0

        def tr_key(tr: Transcript):
            return (tr.exons, tr.left_ext, tr.right_ext,
                    tuple(tr.exon_list[:tr.exons - 2]))

        live = {}

        def live_first(k):
            dq = live.get(k)
            if not dq:
                return None
            while dq and dq[0] < qhead:
                dq.popleft()
            return queue[dq[0]] if dq else None

        def live_add(k, idx):
            dq = live.get(k)
            if dq is None:
                dq = collections.deque()
                live[k] = dq
            dq.append(idx)

        src = self.source_list[source_index]
        sp = Path()
        sp.nodes = [src]
        sp.end = src
        sp.L = 0
        sp.tr = self.transcripts[src].copy()
        sp.visit = 1
        live_add(tr_key(sp.tr), 0)
        queue.append(sp)

        if self._adjacency is None:
            n = len(self.transcripts)
            self._adjacency = [sorted(self.matrix[r])
                               for r in range(n)]
        adjacency = self._adjacency
        while qhead < len(queue):
            enq = queue[qhead]
            qhead += 1
            if enq.visit != 1:
                continue
            no_edge = 1
            for i in adjacency[enq.end]:
                    no_edge = 0
                    copy = self._copy_path(enq)
                    # Add_Node with upd_tr (:1991)
                    if i in copy.nodes:
                        raise RuntimeError("Cycle detected!")
                    if len(copy.nodes) == 40:
                        raise RuntimeError("Too many nodes!")
                    copy.L += self.matrix[copy.end][i]
                    copy.tr = self._build_extension(copy.tr,
                                                    self.transcripts[i],
                                                    copy.L)
                    copy.nodes.append(i)
                    copy.end = i
                    # PRUNE_EXON_COMP (:2146-2159): first live equal entry
                    k = tr_key(copy.tr)
                    same = live_first(k)
                    if same is not None:
                        if self.out_degree[copy.end] > self.out_degree[same.end]:
                            same.visit = 0
                            live_add(k, len(queue))
                            queue.append(copy)
                    else:
                        live_add(k, len(queue))
                        queue.append(copy)
            if no_edge:
                self._set_path_transcripts_for_source(enq)

    def set_paths(self) -> None:
        self.total_paths = 0
        self.path_transcripts = []
        self.transcript_paths = []
        self._adjacency = None  # matrix is fixed for the whole walk
        for si in range(len(self.source_list)):
            self._set_paths_for_source(si)
            self.total_paths += self.source_total_paths
            # Set_Path_Transcripts (:2689)
            for i in range(self.source_total_paths):
                self.path_transcripts.append(
                    self.source_path_transcripts[i].copy())
                dest: List[Path] = []
                # Add_Path_List prepends each in order (:4781)
                for p in self.source_paths[i]:
                    self._add_path(dest, p)
                self.transcript_paths.append(dest)
        self.filtered = [0] * self.total_paths

    # ------------------------------------------------------------------
    # Filter_Path_Transcripts (:2718)
    # ------------------------------------------------------------------

    def filter_path_transcripts(self) -> None:
        ptl = self.path_transcripts
        ii, L_, R_ = self.is_internal, self.left, self.right
        self._index_for(ptl)

        def body(i: int, j: int) -> int:
            stop = 0
            if not self.filtered[j]:
                if ptl[i].type == 1:
                    if ptl[j].type == 0:
                        included, typ = self.overlap(ptl[j], ptl[i],
                                                     0, 1, 1)
                    else:
                        _r, typ = self.overlap(ptl[i], ptl[j], 0, 1, 1)
                        included = 0
                else:
                    if ptl[j].type == 1:
                        included, typ = self.overlap(ptl[i], ptl[j],
                                                     0, 1, 1)
                        if included == 2:
                            included = -2
                    else:
                        included, typ = self.extends(ptl[i], ptl[j],
                                                     0, 1, 1)
                if included in (2, -2):
                    if included == 2:
                        if ptl[i].type != 1:
                            if R_[ptl[i].left_ext] == R_[ptl[j].left_ext] \
                                    and typ == 0:
                                if ii[ptl[i].left_ext] == -1:
                                    if ii[ptl[j].left_ext] == 1:
                                        self._set_left_ext(ptl, i, ptl[j].left_ext)
                                    elif ii[ptl[j].left_ext] == -1 and \
                                            L_[ptl[j].left_ext] < L_[ptl[i].left_ext]:
                                        self._set_left_ext(ptl, i, ptl[j].left_ext)
                            if L_[ptl[i].right_ext] == L_[ptl[j].right_ext] \
                                    and typ + ptl[j].exons == ptl[i].exons:
                                if ii[ptl[i].right_ext] == -2:
                                    if ii[ptl[j].right_ext] == 1:
                                        self._set_right_ext(ptl, i, ptl[j].right_ext)
                                    elif ii[ptl[j].right_ext] == -2 and \
                                            R_[ptl[j].right_ext] > R_[ptl[i].right_ext]:
                                        self._set_right_ext(ptl, i, ptl[j].right_ext)
                        self.filtered[j] = 1
                        for p in self.transcript_paths[j]:
                            self._add_path(self.transcript_paths[i], p)
                    else:
                        if ptl[j].type != 1:
                            if R_[ptl[i].left_ext] == R_[ptl[j].left_ext] \
                                    and typ == 0:
                                if ii[ptl[j].left_ext] == -1:
                                    if ii[ptl[i].left_ext] == 1:
                                        self._set_left_ext(ptl, j, ptl[i].left_ext)
                                    elif ii[ptl[i].left_ext] == -1 and \
                                            L_[ptl[i].left_ext] < L_[ptl[j].left_ext]:
                                        self._set_left_ext(ptl, j, ptl[i].left_ext)
                            if L_[ptl[i].right_ext] == L_[ptl[j].right_ext] \
                                    and typ + ptl[i].exons == ptl[j].exons:
                                if ii[ptl[j].right_ext] == -2:
                                    if ii[ptl[i].right_ext] == 1:
                                        self._set_right_ext(ptl, j, ptl[i].right_ext)
                                    elif ii[ptl[i].right_ext] == -2 and \
                                            R_[ptl[i].right_ext] > R_[ptl[j].right_ext]:
                                        self._set_right_ext(ptl, j, ptl[i].right_ext)
                        self.filtered[i] = 1
                        for p in self.transcript_paths[i]:
                            self._add_path(self.transcript_paths[j], p)
                        stop = 1
            return stop

        self._scan_pairs(self.total_paths, body,
                         skip_i=lambda i: self.filtered[i])
        self._ix = None

    # ------------------------------------------------------------------
    # Filter_Path_Transcripts_by_Introns (:3034)
    # ------------------------------------------------------------------

    def filter_by_introns(self, predicted_introns_path: str) -> None:
        introns = []  # (left, right, conf, est_ids, derr, aerr, pt5, pt3)
        with open(predicted_introns_path) as f:
            for line in f:
                if not line.strip():
                    continue
                fl = line.split()
                left = int(fl[0])
                right = int(fl[1])
                conf = int(fl[5])
                est_ids = fl[6][:-1]  # strip trailing comma
                derr = float(fl[7])
                aerr = float(fl[8])
                pt = fl[14]
                introns.append((left, right, conf, est_ids, derr, aerr,
                                pt[0:2], pt[2:4]))

        def is_refseq_supported(ids: str) -> bool:
            q = 0
            while q < len(ids) - 1:
                if ids[q] == "N" and ids[q + 1] in ("M", "R"):
                    if q == 0 or ids[q - 1] == ",":
                        if q < len(ids) - 2 and ids[q + 2] == "_":
                            return True
                q += 1
            return False

        # first record with given (left, right) wins, like the linear scan
        first_by_coords = {}
        for rec in introns:
            first_by_coords.setdefault((rec[0], rec[1]), rec)

        ptl = self.path_transcripts
        for i in range(self.total_paths):
            if self.filtered[i]:
                continue
            for j in range(ptl[i].exons - 1):
                donor = ptl[i].left_ext if j == 0 else ptl[i].exon_list[j - 1]
                accept = ptl[i].right_ext if j == ptl[i].exons - 2 \
                    else ptl[i].exon_list[j]
                istart = self.right[donor] + 1
                iend = self.left[accept] - 1
                found = first_by_coords.get((istart, iend))
                if found is not None:
                    if found[2] < 2 and not is_refseq_supported(found[3]):
                        if (found[6].lower() != "gt"
                                or found[7].lower() != "ag") \
                                or (found[4] + found[5] > 10.00):
                            self.filtered[i] = 1
                else:
                    sys.stderr.write("Intron not found!\n")
                    self.filtered[i] = 1

    # ------------------------------------------------------------------
    # Output (main, :754-1052)
    # ------------------------------------------------------------------

    def get_absolute_start(self, left: int, right: int) -> int:
        if self.strand == 1:
            return self.gen_start + left - (self.boundary + 1)
        return self.gen_end - right + (self.boundary + 1)

    def get_absolute_end(self, left: int, right: int) -> int:
        if self.strand == 1:
            return self.gen_start + right - (self.boundary + 1)
        return self.gen_end - left + (self.boundary + 1)

    def write_outputs(self, outdir: str) -> None:
        # finish init_reading2 with current (post-mutation) exon tables
        init2 = self.init_reading2
        for i in range(self.number_of_exons):
            init2 += f"{self.left[i]}:{self.right[i]}" \
                     f";{self.old_left[i]}:{self.old_right[i]}" \
                     f":{self.polya[i]}\n"

        counts = {}
        for p in range(FIRST_MIN_EXONS, SECOND_MIN_EXONS + 1):
            counts[p] = sum(1 for i in range(self.total_paths)
                            if not self.filtered[i]
                            and self.path_transcripts[i].exons >= p)

        tr_out = {}
        comp_out = {}
        for p in range(FIRST_MIN_EXONS, SECOND_MIN_EXONS + 1):
            tr_out[p] = open(os.path.join(
                outdir, f"TRANSCRIPTS{MIN_CONFIRMED_EST_INPUT}_{p}.txt"), "w")
            comp_out[p] = open(os.path.join(
                outdir,
                f"TEMP_COMPOSITION_TRANS{MIN_CONFIRMED_EST_INPUT}_{p}.txt"),
                "w")
            tr_out[p].write(f"{counts[p]}\n{self.init_reading}")
            comp_out[p].write(f"{counts[p]}\n{init2}")

        trans_order = {p: 0 for p in counts}
        for i in range(self.total_paths):
            t = self.path_transcripts[i]
            for p in range(FIRST_MIN_EXONS, SECOND_MIN_EXONS + 1):
                if self.filtered[i] or t.exons < p:
                    continue
                trans_order[p] += 1
                to, co = tr_out[p], comp_out[p]
                hdr = f">{trans_order[p]}:{t.exons}"
                if t.type == 1:
                    hdr += f":{t.RefSeq}"
                to.write(hdr + "\n")
                co.write("..\n")

                chain = [t.left_ext] + t.exon_list[:t.exons - 2] \
                    + ([t.right_ext] if t.exons >= 2 else [])
                for e in chain:
                    to.write(f"{self.get_absolute_start(self.left[e], self.right[e])}"
                             f":{self.get_absolute_end(self.left[e], self.right[e])}"
                             f":{self.left[e]}:{self.right[e]}:{self.polya[e]}\n")
                    to.write(f"{self.sequences[e]}\n")

                co.write(".".join(str(e) for e in chain) + "\n")
                co.write("".join(self.sequences[e] for e in chain) + "\n")
                for path in self.transcript_paths[i]:
                    for node in path.nodes:
                        nt = self.transcripts[node]
                        co.write(f".{nt.ESTs}\n")
                        nchain = [nt.left_ext] + nt.exon_list[:nt.exons - 2] \
                            + ([nt.right_ext] if nt.exons >= 2 else [])
                        co.write(".".join(str(e) for e in nchain) + "\n")
                    co.write("*\n")

        for p in range(FIRST_MIN_EXONS, SECOND_MIN_EXONS + 1):
            tr_out[p].write("#\n")
            comp_out[p].write("#\n")
            tr_out[p].close()
            comp_out[p].close()


def run_maximal_transcripts(workdir: str,
                            build_ests: str = "build-ests.txt",
                            predicted_introns: str = "predicted-introns.txt"
                            ) -> None:
    """Full stage: build-ests.txt -> TRANSCRIPTS1_{1..4}.txt +
    TEMP_COMPOSITION_TRANS1_{1..4}.txt in `workdir`."""
    with open(os.path.join(workdir, build_ests)) as f:
        tokens = f.read().split()
    mt = MaximalTranscripts()
    mt.read_input(tokens)
    mt.first_filtering()
    mt.build_extension_matrix()
    mt.graph_reduction()
    n = len(mt.transcripts)
    mt.source_list = [i for i in range(n) if mt.in_degree[i] == 0]
    mt.set_paths()
    mt.filter_path_transcripts()
    mt.filter_by_introns(os.path.join(workdir, predicted_introns))
    mt.write_outputs(workdir)
