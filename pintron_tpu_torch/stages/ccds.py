"""Stage 7: CDS annotation (CCDS_transcripts.txt + VariantGTF.txt).

Rebuild of src/CCDS.c (reference): reads isoforms.txt (FASTA-format
transcripts), predicted-introns.txt, genomic-exonforCCDS.txt, genomic.txt
and the optional `cds` RefSeq annotation file; aligns RefSeq exons to
genomic exons, marks intron types, annotates per-transcript CDSs (RefSeq
annotation when available, else longest context-scored ORF >= 100nt),
elects a reference transcript, classifies alternative-splicing events
(competing 5'/3' sites, intron retention, init/term/new/skip exons), and
emits CCDS_transcripts.txt + VariantGTF.txt.

Faithfully reproduced reference quirks:

* GetIntronList (CCDS.c:860-947) over-counts by one line via the
  feof idiom, duplicating the final intron record;
* getEXInitTermSkipNewLabels (:2062) registers the FIRST exon's
  coordinates when labelling the terminal variant;
* PrintTABOutput (:1479) prints "(null)" for a reference transcript
  without a RefSeq id (glibc %s-NULL behaviour);
* VariantGTF.txt has no trailing newline after the last record.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

from pintron_tpu_torch.runtime import timing

TCDS_DEFAULT = 100  # minimum ORF length, CCDS.c:382


class Exon:
    __slots__ = ("left", "right", "rel_left", "rel_right", "polyA", "is_int",
                 "sequence", "pos_flag_from", "pos_flag_to", "matrix_index",
                 "covered_exon", "cover_index")

    def __init__(self, left, right, rel_left, rel_right, polyA, sequence):
        self.left = left
        self.right = right
        self.rel_left = rel_left
        self.rel_right = rel_right
        self.polyA = polyA
        self.sequence = sequence
        self.is_int = 0
        self.pos_flag_from = 0
        self.pos_flag_to = 0
        self.matrix_index = -1
        self.covered_exon = 0
        self.cover_index = -1


class Transcript:
    __slots__ = ("exons", "exon_index", "length", "type", "RefSeq",
                 "is_annotated", "ORF_start", "ORF_end", "abs_ORF_start",
                 "abs_ORF_end", "first_ORF_index", "second_ORF_index",
                 "start_cons", "end_cons", "start_c", "stop_c", "has_stop",
                 "no_ATG", "EST_aln", "GEN_aln")

    def __init__(self):
        self.exons = 0
        self.exon_index: List[int] = []
        self.length = 0
        self.type = -1
        self.RefSeq: Optional[str] = None
        self.is_annotated = 0
        self.ORF_start = -1
        self.ORF_end = -1
        self.abs_ORF_start = -1
        self.abs_ORF_end = -1
        self.first_ORF_index = -1
        self.second_ORF_index = -1
        self.start_cons = 0
        self.end_cons = 0
        self.start_c = ""
        self.stop_c = ""
        self.has_stop = 0
        self.no_ATG = 0
        self.EST_aln: Optional[List[str]] = None
        self.GEN_aln: Optional[List[str]] = None


def int2alpha(num: int) -> str:
    """int2alpha (CCDS.c:3550): 0->'a' .. 25->'z', 26->'aa', ..."""
    n_digits = 0
    drift = 0
    while (drift + 1) * 26 <= num:
        drift = (drift + 1) * 26
        n_digits += 1
    n_digits += 1
    quotient = num - drift
    out = [""] * n_digits
    i = n_digits
    while True:
        out[i - 1] = chr(ord("a") + quotient % 26)
        quotient //= 26
        i -= 1
        if i <= 0:
            break
    return "".join(out)


def _is_start(seq: str, pos: int) -> bool:
    c = seq[pos:pos + 3]
    return c == "atg" or c == "ATG"


def _is_stop(seq: str, pos: int) -> bool:
    c = seq[pos:pos + 3]
    return c in ("taa", "TAA", "tag", "TAG", "tga", "TGA")


def _compute_alignment(est: str, gen: str) -> Tuple[str, str]:
    """Unit-cost global alignment with N wildcards (ComputeAlignMatrix,
    CCDS.c:3337): tie preference diagonal > EST-gap-in-genomic > EST-gap."""
    n, m = len(est), len(gen)
    INF = 1 << 30
    prev = list(range(m + 1))
    dirs = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ei = est[i - 1]
        drow = dirs[i]
        prow = prev
        for j in range(1, m + 1):
            gj = gen[j - 1]
            v = prow[j - 1]
            if not (ei == gj or ei in "nN" or gj in "nN"):
                v += 1
            d = 0
            up = prow[j] + 1
            if v > up:
                v = up
                d = 1
            lf = cur[j - 1] + 1
            if v > lf:
                v = lf
                d = 2
            cur[j] = v
            drow[j] = d
        prev = cur
    # traceback (CCDS.c:3403)
    a_est: List[str] = []
    a_gen: List[str] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            d = dirs[i][j]
            if d == 0:
                a_est.append(est[i - 1])
                a_gen.append(gen[j - 1])
                i -= 1
                j -= 1
            elif d == 1:
                a_est.append(est[i - 1])
                a_gen.append("-")
                i -= 1
            else:
                a_est.append("-")
                a_gen.append(gen[j - 1])
                j -= 1
        elif i > 0:
            a_est.append(est[i - 1])
            a_gen.append("-")
            i -= 1
        else:
            a_est.append("-")
            a_gen.append(gen[j - 1])
            j -= 1
    return "".join(reversed(a_est)), "".join(reversed(a_gen))


class CCDSAnnotator:
    def __init__(self):
        self.exons: List[Exon] = []
        self.trs: List[Transcript] = []
        self.strand = 1
        self.gen_length_str = ""
        self.introns: List[dict] = []
        self.a_cds: List[dict] = []
        self.gen_exons: List[Tuple[int, int, str]] = []  # sorted list
        self.Tcds = TCDS_DEFAULT
        self.order_index: List[int] = []
        self.new_labels: List[List[Tuple[int, int, str]]] = []

    # -- input ---------------------------------------------------------

    def read_cds_annotations(self, path: str) -> None:
        if not os.path.exists(path):
            sys.stderr.write(
                f"WARNING: CDS annotation {path} file does not exist!\n")
            return
        with open(path) as f:
            tokens = f.read().split("\n")
        idx = 0

        def next_nonempty():
            nonlocal idx
            while idx < len(tokens):
                t = tokens[idx]
                idx += 1
                if t.strip():
                    return t
            return None

        first = next_nonempty()
        if first is None:
            return
        _number_of_cds = int(first.strip())
        while True:
            lt = next_nonempty()
            if lt is None:
                break
            length = int(lt.strip())
            rec = next_nonempty()
            if rec is None:
                break
            parts = rec.split()
            if length > 0:
                self.a_cds.append({
                    "RefSeq": parts[0],
                    "rel_start": int(parts[1]),
                    "rel_end": int(parts[2]),
                    "exons": int(parts[3]),
                    "seq": parts[4],
                })

    def _insert_exon(self, left, right, rel_left, rel_right, polyA,
                     sequence) -> None:
        """Insert_exon_into_a_exon_list (CCDS.c:2495): sorted by
        (left asc, right desc), dedup by (left, right, sequence)."""
        lst = self.exons
        pos = 0
        while pos < len(lst) and not (left <= lst[pos].left):
            pos += 1
        if pos < len(lst) and left == lst[pos].left:
            while pos < len(lst) and left == lst[pos].left \
                    and right < lst[pos].right:
                pos += 1
            while pos < len(lst) and left == lst[pos].left \
                    and right == lst[pos].right:
                if sequence == lst[pos].sequence:
                    return
                pos += 1
        lst.insert(pos, Exon(left, right, rel_left, rel_right, polyA,
                             sequence))

    def read_transcripts(self, isoforms_path: str, genomic_path: str) -> None:
        with open(isoforms_path) as f:
            tokens = [t for t in f.read().split() if t]
        it = iter(tokens)
        n_trs = int(next(it))
        self.gen_length_str = next(it)
        raw = []  # per transcript: (refseq, [(l, r, rl, rr, pA, seq), ...])
        for _ in range(n_trs):
            hdr = next(it)
            assert hdr.startswith(">")
            parts = hdr[1:].split(":")
            nexons = int(parts[1])
            refseq = parts[2] if len(parts) > 2 else ""
            ex = []
            for _j in range(nexons):
                coords = next(it).split(":")
                seq = next(it)
                ex.append((int(coords[0]), int(coords[1]), int(coords[2]),
                           int(coords[3]), int(coords[4]), seq))
                self._insert_exon(int(coords[0]), int(coords[1]),
                                  int(coords[2]), int(coords[3]),
                                  int(coords[4]), seq)
            raw.append((refseq, ex))

        # strand from genomic header (CCDS.c:697-728)
        self.strand = 1
        try:
            with open(genomic_path) as g:
                line = g.readline().rstrip("\n")
            ci = line.rfind(":")
            if ci != -1:
                try:
                    self.strand = int(line[ci + 1:])
                except ValueError:
                    self.strand = 0  # atoi of garbage
        except OSError:
            raise RuntimeError("Error genomic file!")

        for refseq, ex in raw:
            t = Transcript()
            t.exons = len(ex)
            if refseq:
                t.type = 0
                t.RefSeq = refseq
            order = range(len(ex) - 1, -1, -1) if self.strand == -1 \
                else range(len(ex))
            for p in order:
                left, right, _rl, _rr, _pA, seq = ex[p]
                z = None
                for zi, e in enumerate(self.exons):
                    if e.left == left and e.right == right \
                            and e.sequence == seq:
                        z = zi
                        break
                if z is None:
                    raise RuntimeError(
                        "Problem in exon in Get_Transcripts_from_File!")
                t.exon_index.append(z)
                if self.exons[z].polyA == 1:
                    is_int = 1
                else:
                    is_int = 1 if (p != 0 and p != len(ex) - 1) \
                        else (3 if p == 0 else 2)
                self.exons[z].is_int = is_int
            self.trs.append(t)

    def read_introns(self, path: str) -> None:
        recs = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                fl = line.split()
                ids = [x for x in fl[6].split(",") if x]
                recs.append({"left": int(fl[2]), "right": int(fl[3]),
                             "ESTs": int(fl[5]), "IDs": ids,
                             "type": 0, "RefSeqNum": 0, "RefSeq": []})
        if recs:
            # feof off-by-one duplicates the last record (CCDS.c:905-944)
            last = recs[-1]
            recs.append({"left": last["left"], "right": last["right"],
                         "ESTs": last["ESTs"], "IDs": list(last["IDs"]),
                         "type": 0, "RefSeqNum": 0, "RefSeq": []})
        self.introns = recs

    def read_genomic_exons(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                fl = line.split()
                if len(fl) < 3:
                    continue
                rel_left, rel_right, seq = int(fl[0]), int(fl[1]), fl[2]
                # Insert_genexon (:2585): sorted, dedup by coords
                pos = 0
                lst = self.gen_exons
                while pos < len(lst) and not (rel_left <= lst[pos][0]):
                    pos += 1
                if pos < len(lst) and rel_left == lst[pos][0]:
                    while pos < len(lst) and rel_left == lst[pos][0] \
                            and rel_right < lst[pos][1]:
                        pos += 1
                    if pos < len(lst) and rel_left == lst[pos][0] \
                            and rel_right == lst[pos][1]:
                        continue
                lst.insert(pos, (rel_left, rel_right, seq))

    def get_gen_exon_sequence(self, rel_left: int,
                              rel_right: int) -> Optional[str]:
        for gl, gr, seq in self.gen_exons:
            if rel_left <= gl:
                if rel_left == gl:
                    if rel_right == gr:
                        return seq
                    if rel_right < gr:
                        continue
                return None
        return None

    # -- alignments, types ---------------------------------------------

    def get_exon_alignments(self) -> None:
        for t in self.trs:
            if t.type != 0:
                continue
            t.EST_aln = []
            t.GEN_aln = []
            for z in t.exon_index:
                e = self.exons[z]
                gen_seq = self.get_gen_exon_sequence(e.rel_left, e.rel_right)
                if gen_seq is None:
                    raise RuntimeError("genomic exon not found "
                                       f"({e.rel_left}-{e.rel_right})")
                if e.sequence != gen_seq:
                    a, g = _compute_alignment(e.sequence, gen_seq)
                else:
                    a = g = e.sequence
                t.EST_aln.append(a)
                t.GEN_aln.append(g)

    def mark_intron_types(self) -> None:
        for rec in self.introns:
            refs = [x for x in rec["IDs"]
                    if len(x) >= 3 and x[0] == "N" and x[2] == "_"
                    and x[1] in ("M", "R")]
            rec["RefSeqNum"] = len(refs)
            rec["RefSeq"] = refs
            if refs:
                rec["type"] = 0
            elif rec["ESTs"] > 1:
                rec["type"] = 1
            else:
                rec["type"] = 2

    def mark_transcript_type(self, t: Transcript) -> None:
        if t.type != -1:
            return
        il = self.exons[t.exon_index[0]].right + 1
        ir = self.exons[t.exon_index[1]].left - 1
        conf2 = 1
        for rec in self.introns:
            if rec["left"] == il and rec["right"] == ir:
                if rec["type"] != 1:
                    conf2 = 0
                break
        t.type = 1 if conf2 else 2

    # -- ORF annotation ------------------------------------------------

    def _tr_seq(self, t: Transcript) -> str:
        if self.strand == 1:
            return "".join(self.exons[z].sequence for z in t.exon_index)
        return "".join(self.exons[z].sequence
                       for z in reversed(t.exon_index))

    def _abs_pos_from_mrna(self, t: Transcript, tmp_pos: int,
                           is_start: bool) -> Tuple[int, int]:
        """Map an mRNA-relative position to (exon index, absolute coord)
        via the exon alignments (GetCDSAnnotationForRefSeq_2 /
        GetLongestORF shared logic)."""
        p = 0
        length = 0
        while p < t.exons:
            cfr = len(self.exons[t.exon_index[p]].sequence)
            if tmp_pos <= length + cfr:
                break
            length += cfr
            p += 1
        est = t.EST_aln[p]
        gen = t.GEN_aln[p]
        if self.strand == 1:
            k = 0
            ai = 0
            while k < tmp_pos - length:
                if est[ai] != "-":
                    k += 1
                ai += 1
            ai -= 1
            k = 0
            while ai >= 0:
                if gen[ai] != "-":
                    k += 1
                ai -= 1
        else:
            k = 0
            ai = len(est) - 1
            while k < tmp_pos - length:
                if est[ai] != "-":
                    k += 1
                ai -= 1
            ai += 1
            k = 0
            while ai < len(gen):
                if gen[ai] != "-":
                    k += 1
                ai += 1
        return p, self.exons[t.exon_index[p]].left + k - 1

    def _orf_indices_no_align(self, t: Transcript,
                              tmp_pos: int) -> Tuple[int, int, int]:
        p = 0
        length = 0
        while p < t.exons:
            cfr = self.exons[t.exon_index[p]].right \
                - self.exons[t.exon_index[p]].left + 1
            if tmp_pos <= length + cfr:
                break
            length += cfr
            p += 1
        return p, length, tmp_pos - length \
            + self.exons[t.exon_index[p]].left - 1

    def get_cds_annotation_for_refseq(self, i: int) -> int:
        """GetCDSAnnotationForRefSeq_2 (CCDS.c:1036)."""
        t = self.trs[i]
        if t.type != 0:
            return 0
        rec = None
        for r in self.a_cds:
            if r["RefSeq"] == t.RefSeq:
                rec = r
                break
        if rec is None:
            return 0
        t.ORF_start = -1
        t.ORF_end = -1
        tr_seq = self._tr_seq(t)
        t.no_ATG = 0
        ann = rec["seq"].lower()
        needle = ann[rec["rel_start"] - 1:rec["rel_end"]]
        z = tr_seq.lower().find(needle)
        if z == -1 or not needle:
            if not needle:
                pass
            return 0
        p = z + len(needle)
        t.ORF_start = z + 1
        t.ORF_end = p
        if (t.ORF_end - t.ORF_start + 1) % 3 != 0:
            return 0
        if self.Tcds > t.ORF_end - t.ORF_start + 1:
            self.Tcds = t.ORF_end - t.ORF_start + 1
        t.start_c = tr_seq[t.ORF_start - 1:t.ORF_start + 2]
        if t.start_c not in ("atg", "ATG"):
            t.no_ATG = 1
        t.stop_c = tr_seq[t.ORF_end - 3:t.ORF_end]
        if t.stop_c.upper() in ("TGA", "TAG", "TAA"):
            t.has_stop = 1
        if self.strand == -1:
            tmp_start = t.length - t.ORF_end + 1
            tmp_end = t.length - t.ORF_start + 1
        else:
            tmp_start = t.ORF_start
            tmp_end = t.ORF_end
        t.first_ORF_index, t.abs_ORF_start = \
            self._abs_pos_from_mrna(t, tmp_start, True)
        t.second_ORF_index, t.abs_ORF_end = \
            self._abs_pos_from_mrna(t, tmp_end, False)
        return 1

    def get_longest_orf(self, i: int, min_length: int) -> None:
        """GetLongestORF (CCDS.c:2188)."""
        t = self.trs[i]
        tr_seq = self._tr_seq(t)
        t.has_stop = 0
        t.no_ATG = 0
        t.ORF_start = -1
        t.ORF_end = -1
        ccds_end = len(tr_seq) - 3
        orf_found = False
        orf_length = 0
        noncoding = (t.RefSeq is not None and len(t.RefSeq) >= 3
                     and t.RefSeq[0] == "N" and t.RefSeq[1] == "R"
                     and t.RefSeq[2] == "_")
        if not noncoding:
            for frame in range(3):
                z = frame
                while z <= ccds_end:
                    if _is_start(tr_seq, z):
                        j = z + 3
                        while j <= ccds_end and not _is_stop(tr_seq, j):
                            j += 3
                        if j <= ccds_end:
                            this_len = j - z + 3
                            if this_len >= min_length:
                                # Kozak-like context (getContext, :2458)
                                context = 2
                                if z - 3 < 0 or tr_seq[z - 3] not in "agAG":
                                    context -= 1
                                if z + 3 >= len(tr_seq) \
                                        or tr_seq[z + 3] not in "agAG":
                                    context -= 1
                                has_context = context > 0
                                if (not orf_found and has_context) or \
                                        (this_len > orf_length and
                                         (not orf_found or has_context)):
                                    orf_length = this_len
                                    t.ORF_start = z + 1
                                    t.ORF_end = j + 3
                                    orf_found = has_context
                        z = j + 3
                    else:
                        z += 3

        if t.ORF_start != -1 and t.ORF_end != -1:
            t.start_c = tr_seq[t.ORF_start - 1:t.ORF_start + 2]
            t.stop_c = tr_seq[t.ORF_end - 3:t.ORF_end]
            if t.stop_c.upper() in ("TGA", "TAG", "TAA"):
                t.has_stop = 1
            else:
                raise RuntimeError("Stop problem")
            if self.strand == -1:
                tmp_start = t.length - t.ORF_end + 1
                tmp_end = t.length - t.ORF_start + 1
            else:
                tmp_start = t.ORF_start
                tmp_end = t.ORF_end
            if t.type == 0:
                t.first_ORF_index, t.abs_ORF_start = \
                    self._abs_pos_from_mrna(t, tmp_start, True)
                t.second_ORF_index, t.abs_ORF_end = \
                    self._abs_pos_from_mrna(t, tmp_end, False)
            else:
                t.first_ORF_index, _l, t.abs_ORF_start = \
                    self._orf_indices_no_align(t, tmp_start)
                t.second_ORF_index, _l, t.abs_ORF_end = \
                    self._orf_indices_no_align(t, tmp_end)
        else:
            t.abs_ORF_start = -1
            t.first_ORF_index = -1
            t.abs_ORF_end = -1
            t.second_ORF_index = -1

    # -- reference election --------------------------------------------

    def set_ref_to_longest_transcript(self) -> int:
        """SetREFToLongestTranscript (CCDS.c:2957), product variant."""
        n = len(self.trs)
        min_E = [0] * n
        for i, t in enumerate(self.trs):
            if t.abs_ORF_start == -1 or t.abs_ORF_end == -1:
                continue
            first = True
            for j in range(t.exons - 1):
                il = self.exons[t.exon_index[j]].right + 1
                ir = self.exons[t.exon_index[j + 1]].left - 1
                found = None
                for rec in self.introns:
                    if rec["left"] == il and rec["right"] == ir:
                        found = rec
                        break
                if found is None:
                    raise RuntimeError("intron not found in "
                                       "SetREFToLongestTranscript")
                if first:
                    first = False
                    min_E[i] = found["ESTs"]
                elif found["ESTs"] < min_E[i]:
                    min_E[i] = found["ESTs"]

        index = -1
        # pass 1 & 2 use the same product criterion over type==0
        # (EXON_LONGEST_REF not defined; both passes are identical)
        for _pass in range(2):
            product = 0
            for i, t in enumerate(self.trs):
                if t.abs_ORF_start != -1 and t.abs_ORF_end != -1:
                    if t.type == 0 and t.exons * min_E[i] > product:
                        product = t.exons * min_E[i]
                        index = i
            if index != -1:
                return index
        product = 0
        for i, t in enumerate(self.trs):
            if t.abs_ORF_start != -1 and t.abs_ORF_end != -1:
                if t.type == 1 and t.exons * min_E[i] > product:
                    product = t.exons * min_E[i]
                    index = i
        if index != -1:
            return index
        product = 0
        for i, t in enumerate(self.trs):
            if t.abs_ORF_start != -1 and t.abs_ORF_end != -1:
                if t.exons * min_E[i] > product:
                    product = t.exons * min_E[i]
                    index = i
        if index != -1:
            return index
        # 30nov10 fallback: longest by (exons, length), preferring RefSeq
        trs_exons = 0
        trs_length = 0
        current_type = -1
        for i, t in enumerate(self.trs):
            if t.abs_ORF_start != -1 and t.abs_ORF_end != -1:
                if current_type != 0:
                    if t.exons >= trs_exons and t.length >= trs_length:
                        trs_exons = t.exons
                        trs_length = t.length
                        current_type = t.type
                        index = i
                else:
                    if t.type == 0 and t.exons >= trs_exons \
                            and t.length >= trs_length:
                        trs_exons = t.exons
                        trs_length = t.length
                        current_type = t.type
                        index = i
        if index == -1 and self.trs:
            raise RuntimeError("no reference transcript electable")
        return index

    def check_start_end_wrt_ref(self, ref: int, i: int) -> None:
        if ref == -1:
            return
        t = self.trs[i]
        t.start_cons = 0
        t.end_cons = 0
        rt = self.trs[ref]
        if rt.abs_ORF_start != -1 and rt.abs_ORF_end != -1:
            if i == ref:
                t.start_cons = 1
                t.end_cons = 1
            else:
                if t.abs_ORF_start == rt.abs_ORF_start:
                    if self.strand == 1:
                        t.start_cons = 1
                    else:
                        t.end_cons = 1
                if t.abs_ORF_end == rt.abs_ORF_end:
                    if self.strand == 1:
                        t.end_cons = 1
                    else:
                        t.start_cons = 1

    def get_cds_for_gene(self, ref: int) -> Tuple[List[int], List[int]]:
        t = self.trs[ref]
        if t.abs_ORF_start == -1 or t.abs_ORF_end == -1:
            raise RuntimeError("ERROR: CCDS not set 2!")
        cds_from = []
        cds_to = []
        for j in range(t.first_ORF_index, t.second_ORF_index + 1):
            cds_from.append(t.abs_ORF_start if j == t.first_ORF_index
                            else self.exons[t.exon_index[j]].left)
            cds_to.append(t.abs_ORF_end if j == t.second_ORF_index
                          else self.exons[t.exon_index[j]].right)
        return cds_from, cds_to

    def mark_exon_endpoints(self, cds_from: List[int],
                            cds_to: List[int]) -> None:
        if not cds_from:
            raise RuntimeError("ERROR: CCDS not set 1!")
        cds_start = cds_from[0]
        cds_end = cds_to[-1]
        for e in self.exons:
            if cds_start <= e.left <= cds_end:
                e.pos_flag_from = 0
            elif e.left < cds_start:
                e.pos_flag_from = 1
            else:
                e.pos_flag_from = 2
            if cds_start <= e.right <= cds_end:
                e.pos_flag_to = 0
            elif e.right < cds_start:
                e.pos_flag_to = 1
            else:
                e.pos_flag_to = 2

    def set_cover_exons(self) -> None:
        ex = self.exons
        n = len(ex)
        for e in ex:
            e.covered_exon = 0
            e.cover_index = -1
        for i in range(n):
            if ex[i].covered_exon == 0:
                stop = False
                j = i + 1
                while j < n and not stop:
                    if ex[i].left >= ex[j].left and ex[i].right <= ex[j].right:
                        ex[i].covered_exon = 1
                        ex[i].cover_index = j
                        stop = True
                    elif ex[j].left >= ex[i].left \
                            and ex[j].right <= ex[i].right:
                        ex[j].covered_exon = 1
                        ex[j].cover_index = i
                    j += 1
        for i in range(n):
            if ex[i].covered_exon:
                k = i
                while True:
                    j = ex[k].cover_index
                    k = j
                    if ex[j].covered_exon == 0:
                        break
                ex[i].cover_index = j
        index = 0
        for e in ex:
            if e.covered_exon == 0:
                e.matrix_index = index
                index += 1
        for e in ex:
            if e.covered_exon == 1:
                e.matrix_index = ex[e.cover_index].matrix_index

    def set_print_order(self, ref: int) -> None:
        n = len(self.trs)
        order = []
        start = 0
        if ref != -1:
            order.append(ref)
            start = 1
        for i in range(n):
            if i != ref:
                order.append(i)
        # insertion sort desc by exons from start+1 (SetPrintOrder, :2946)
        for i in range(start + 1, n):
            help_ = order[i]
            j = i - 1
            while j >= start and self.trs[help_].exons \
                    > self.trs[order[j]].exons:
                order[j + 1] = order[j]
                j -= 1
            order[j + 1] = help_
        self.order_index = order

    # -- variant labels ------------------------------------------------

    def _localization(self, ref: int, exon: int) -> str:
        e = self.exons[self.trs[ref].exon_index[exon]]
        if e.pos_flag_from == 1:
            if e.pos_flag_to == 1:
                return "5UTR" if self.strand == 1 else "3UTR"
            if e.pos_flag_to == 0:
                return "5UTR_CDS" if self.strand == 1 else "CDS_3UTR"
            return "5UTR_3UTR"
        if e.pos_flag_from == 2:
            return "3UTR" if self.strand == 1 else "5UTR"
        if e.pos_flag_to == 0:
            return "CDS"
        return "CDS_3UTR" if self.strand == 1 else "5UTR_CDS"

    def _insert_newlabel(self, slot: int, left: int, right: int) -> str:
        lst = self.new_labels[slot]
        for (l, r, rep) in lst:
            if l == left and r == right:
                return rep
        rep = int2alpha(len(lst))
        lst.append((left, right, rep))
        return rep

    def _competing_labels(self, index: int, ref: int) -> str:
        if ref == -1:
            return ""
        ex = self.exons
        ti = self.trs[index]
        tr = self.trs[ref]
        label = []

        def to_flag_label(ref_flag, idx_flag, is_to):
            # shared UTR/CDS classification for competing sites
            if ref_flag == 0:
                if idx_flag == 0:
                    return "CDS"
                if idx_flag == 1:
                    return "5UTR_CDS" if self.strand == 1 else "CDS_3UTR"
                return ("CDS_3UTR" if self.strand == 1 else "5UTR_CDS") \
                    if is_to else "CDS"
            if ref_flag == 1:
                if idx_flag == 1:
                    return "5UTR" if self.strand == 1 else "3UTR"
                if idx_flag == 0:
                    return "5UTR_CDS" if self.strand == 1 else "CDS_3UTR"
                return "5UTR_3UTR"
            if idx_flag == 2:
                return "3UTR" if self.strand == 1 else "5UTR"
            if idx_flag == 0:
                return "CDS_3UTR" if self.strand == 1 else "5UTR_CDS"
            return "5UTR_3UTR"

        for i in range(ti.exons - 1):
            j = 0
            while j < tr.exons and ex[ti.exon_index[i]].matrix_index \
                    != ex[tr.exon_index[j]].matrix_index:
                j += 1
            while True:
                if j + 1 < tr.exons and ex[ti.exon_index[i + 1]].matrix_index \
                        == ex[tr.exon_index[j + 1]].matrix_index:
                    overlap = 1
                    if ex[ti.exon_index[i]].left > ex[tr.exon_index[j]].right \
                            or ex[ti.exon_index[i]].right \
                            < ex[tr.exon_index[j]].left:
                        overlap = 0
                    if ex[ti.exon_index[i + 1]].left \
                            > ex[tr.exon_index[j + 1]].right \
                            or ex[ti.exon_index[i + 1]].right \
                            < ex[tr.exon_index[j + 1]].left:
                        overlap = 0
                    if ex[ti.exon_index[i]].right \
                            != ex[tr.exon_index[j]].right and overlap:
                        if self.strand == 1:
                            label.append(f"A5E (I{j + 1}, ")
                        else:
                            label.append(f"A3E (I{tr.exons - j - 1}, ")
                        d = ex[tr.exon_index[j]].right \
                            - ex[ti.exon_index[i]].right
                        label.append(f"{'' if d < 0 else '+'}{d} nt), ")
                        label.append(to_flag_label(
                            ex[tr.exon_index[j]].pos_flag_to,
                            ex[ti.exon_index[i]].pos_flag_to, True))
                        label.append("; ")
                    if ex[ti.exon_index[i + 1]].left \
                            != ex[tr.exon_index[j + 1]].left and overlap:
                        if self.strand == 1:
                            label.append(f"A3E (I{j + 1}, ")
                        else:
                            label.append(f"A5E (I{tr.exons - j - 1}, ")
                        d = ex[ti.exon_index[i + 1]].left \
                            - ex[tr.exon_index[j + 1]].left
                        label.append(f"{'' if d < 0 else '+'}{d} nt), ")
                        label.append(to_flag_label(
                            ex[tr.exon_index[j + 1]].pos_flag_from,
                            ex[ti.exon_index[i + 1]].pos_flag_from, False))
                        label.append("; ")
                j += 1
                if not (j < tr.exons and ex[ti.exon_index[i]].matrix_index
                        == ex[tr.exon_index[j]].matrix_index):
                    break
        return "".join(label)

    def _ir_labels(self, index: int, ref: int) -> str:
        if ref == -1:
            return ""
        ex = self.exons
        ti = self.trs[index]
        tr = self.trs[ref]
        label = []
        # IR+ : reference intron retained in this transcript's exon
        i = 0
        j = 0
        while i < ti.exons:
            while j < tr.exons - 1 and ex[tr.exon_index[j]].right \
                    < ex[ti.exon_index[i]].left:
                j += 1
            while j < tr.exons - 1 and ex[tr.exon_index[j]].right \
                    <= ex[ti.exon_index[i]].right:
                if ex[tr.exon_index[j + 1]].left \
                        <= ex[ti.exon_index[i]].right:
                    if self.strand == 1:
                        label.append(f"IR+(I{j + 1}),")
                    else:
                        label.append(f"IR+(I{tr.exons - j - 1}),")
                    label.append(self._localization(ref, j))
                    label.append("; ")
                j += 1
            i += 1
        # IR- : this transcript's intron inside a reference exon
        i = 0
        j = 0
        while i < tr.exons:
            while j < ti.exons - 1 and ex[ti.exon_index[j]].right \
                    < ex[tr.exon_index[i]].left:
                j += 1
            while j < ti.exons - 1 and ex[ti.exon_index[j]].right \
                    <= ex[tr.exon_index[i]].right:
                if ex[ti.exon_index[j + 1]].left \
                        <= ex[tr.exon_index[i]].right:
                    if self.strand == 1:
                        label.append(f"IR-(E{i + 1}),")
                    else:
                        label.append(f"IR-(E{tr.exons - i}),")
                    label.append(self._localization(ref, i))
                    label.append("; ")
                j += 1
            i += 1
        return "".join(label)

    def _init_term_skip_new_labels(self, index: int, ref: int) -> str:
        if ref == -1:
            return ""
        ex = self.exons
        ti = self.trs[index]
        tr = self.trs[ref]
        label = []

        # INIT (strand 1) / TERM variant on the first exon
        extr_variant = 1
        r0 = ex[tr.exon_index[0]]
        i0 = ex[ti.exon_index[0]]
        if r0.right == i0.right:
            if r0.left == i0.left:
                extr_variant = 0
            elif r0.left > i0.left:
                if r0.polyA != 1 or r0.left - i0.left <= 20:
                    extr_variant = 0
            else:
                if i0.polyA != 1 or i0.left - r0.left <= 20:
                    extr_variant = 0
        if extr_variant == 1 and i0.polyA != 1:
            for p in range(1, tr.exons):
                e = ex[tr.exon_index[p]]
                if e.left == i0.left and e.right == i0.right:
                    extr_variant = 0
                    break
        i = 1
        if extr_variant == 1:
            localize = self._localization(ref, 0)
            r_index = 1
            if i0.left < r0.left:
                r_index = 0
            rep = self._insert_newlabel(r_index, i0.left, i0.right)
            if self.strand == 1:
                label.append(f"init(E{r_index}{rep}),")
            else:
                if r_index == 1:
                    label.append(f"term(E{tr.exons}{rep}),")
                else:
                    label.append(f"term({tr.exons}a{rep}),")
            label.append(localize)
            label.append("; ")
            while i < ti.exons and ex[ti.exon_index[i]].right < r0.left:
                e = ex[ti.exon_index[i]]
                rep = self._insert_newlabel(0, e.left, e.right)
                if self.strand == 1:
                    label.append(f"init(E0{rep}),")
                else:
                    label.append(f"term({tr.exons}a{rep}),")
                label.append(localize)
                label.append("; ")
                i += 1

        # TERM (strand 1) / INIT variant on the last exon
        extr_variant = 1
        rl = ex[tr.exon_index[tr.exons - 1]]
        il = ex[ti.exon_index[ti.exons - 1]]
        if rl.left == il.left:
            if rl.right == il.right:
                extr_variant = 0
            elif rl.right < il.right:
                if rl.polyA != 1 or il.right - rl.right <= 20:
                    extr_variant = 0
            else:
                if il.polyA != 1 or rl.right - il.right <= 20:
                    extr_variant = 0
        if extr_variant == 1 and il.polyA != 1:
            for p in range(tr.exons - 2, -1, -1):
                e = ex[tr.exon_index[p]]
                if e.left == il.left and e.right == il.right:
                    extr_variant = 0
                    break
        j = ti.exons - 2
        if extr_variant == 1:
            localize = self._localization(ref, tr.exons - 1)
            r_index = tr.exons
            if il.right > rl.right:
                r_index = tr.exons + 1
            # reference registers the FIRST exon's coords here (:2062)
            rep = self._insert_newlabel(r_index, i0.left, i0.right)
            if self.strand == 1:
                if r_index == tr.exons:
                    label.append(f"term(E{tr.exons}{rep}),")
                else:
                    label.append(f"term({tr.exons}a{rep}),")
            else:
                label.append(f"init(E{tr.exons - r_index + 1}{rep}),")
            label.append(localize)
            label.append("; ")
            while j >= 0 and ex[ti.exon_index[j]].left > rl.right:
                e = ex[ti.exon_index[j]]
                rep = self._insert_newlabel(tr.exons + 1, e.left, e.right)
                if self.strand == 1:
                    label.append(f"term({tr.exons}a{rep}),")
                else:
                    label.append(f"init(E0{rep}),")
                label.append(localize)
                label.append("; ")
                j -= 1

        # NEW exons between i and j
        q = 0
        k = i
        while k <= j:
            while q < tr.exons and ex[tr.exon_index[q]].right \
                    < ex[ti.exon_index[k]].left:
                q += 1
            if q < tr.exons and ex[tr.exon_index[q]].left \
                    > ex[ti.exon_index[k]].right:
                localize = self._localization(ref, q - 1)
                e = ex[ti.exon_index[k]]
                rep = self._insert_newlabel(q - 1, e.left, e.right)
                nr = q if self.strand == 1 else tr.exons - q
                label.append(f"new(E{nr}{rep}),")
                label.append(localize)
                label.append("; ")
            k += 1

        # SKIP of reference exons
        i = 1
        while i < tr.exons - 1 and ex[tr.exon_index[i]].left <= i0.right:
            i += 1
        q = 0
        while i < tr.exons - 1:
            while q < ti.exons and ex[ti.exon_index[q]].right \
                    < ex[tr.exon_index[i]].left:
                q += 1
            if q < ti.exons and ex[ti.exon_index[q]].left \
                    > ex[tr.exon_index[i]].right:
                localize = self._localization(ref, i)
                nr = i + 1 if self.strand == 1 else tr.exons - i
                label.append(f"skip(E{nr}),")
                label.append(localize)
                label.append("; ")
            i += 1
        return "".join(label)

    def is_in_frame(self, index: int, ref: int) -> int:
        """isInFrame (CCDS.c:2656)."""
        if ref == -1:
            return 2
        t = self.trs[index]
        rt = self.trs[ref]
        if t.abs_ORF_start == -1:
            return 0
        if t.no_ATG or not t.has_stop:
            return 0
        if rt.abs_ORF_end < t.abs_ORF_start \
                or t.abs_ORF_end < rt.abs_ORF_start:
            return 0
        ex = self.exons
        f_cds_i = rt.first_ORF_index
        s_cds_i = rt.second_ORF_index
        region_length = 0
        ref_partial = 0
        stop = False

        if self.strand == -1:
            def r_bounds(i):
                e = ex[rt.exon_index[i]]
                lo = e.rel_left + (e.right - rt.abs_ORF_end) \
                    if i == s_cds_i else e.rel_left
                hi = e.rel_right - (rt.abs_ORF_start - e.left) \
                    if i == f_cds_i else e.rel_right
                return lo, hi

            def t_bounds(j):
                e = ex[t.exon_index[j]]
                lo = e.rel_left + (e.right - t.abs_ORF_end) \
                    if j == t.second_ORF_index else e.rel_left
                hi = e.rel_right - (t.abs_ORF_start - e.left) \
                    if j == t.first_ORF_index else e.rel_right
                return lo, hi

            i = s_cds_i
            while i >= f_cds_i and not stop:
                ref_left, ref_right = r_bounds(i)
                j = t.second_ORF_index
                left, right = t_bounds(j)
                partial = 0
                while j >= t.first_ORF_index and left <= ref_right \
                        and not stop:
                    if right >= ref_left:
                        region_left = max(left, ref_left)
                        region_right = min(right, ref_right)
                        region_length += region_right - region_left + 1
                        phase1 = (region_left - ref_left + ref_partial) % 3
                        phase2 = (region_left - left + partial) % 3
                        if phase1 != phase2:
                            stop = True
                    if not stop:
                        partial += right - left + 1
                        j -= 1
                        if j >= 0:
                            left, right = t_bounds(j)
                if not stop:
                    ref_partial += ref_right - ref_left + 1
                    i -= 1
        else:
            def r_bounds(i):
                lo = rt.abs_ORF_start if i == f_cds_i \
                    else ex[rt.exon_index[i]].left
                hi = rt.abs_ORF_end if i == s_cds_i \
                    else ex[rt.exon_index[i]].right
                return lo, hi

            def t_bounds(j):
                lo = t.abs_ORF_start if j == t.first_ORF_index \
                    else ex[t.exon_index[j]].left
                hi = t.abs_ORF_end if j == t.second_ORF_index \
                    else ex[t.exon_index[j]].right
                return lo, hi

            i = f_cds_i
            while i <= s_cds_i and not stop:
                ref_left, ref_right = r_bounds(i)
                j = t.first_ORF_index
                left, right = t_bounds(j)
                partial = 0
                while j <= t.second_ORF_index and left <= ref_right \
                        and not stop:
                    if right >= ref_left:
                        region_left = max(left, ref_left)
                        region_right = min(right, ref_right)
                        region_length += region_right - region_left + 1
                        phase1 = (region_left - ref_left + ref_partial) % 3
                        phase2 = (region_left - left + partial) % 3
                        if phase1 != phase2:
                            stop = True
                    if not stop:
                        partial += right - left + 1
                        j += 1
                        if j < t.exons:
                            left, right = t_bounds(j)
                if not stop:
                    ref_partial += ref_right - ref_left + 1
                    i += 1

        tr_length = 0
        for i in range(t.first_ORF_index, t.second_ORF_index + 1):
            left = t.abs_ORF_start if i == t.first_ORF_index \
                else ex[t.exon_index[i]].left
            right = t.abs_ORF_end if i == t.second_ORF_index \
                else ex[t.exon_index[i]].right
            tr_length += right - left + 1
        if float(region_length * 100 // tr_length) < 50.0:
            return 0
        return 0 if stop else 1

    # -- output --------------------------------------------------------

    def write_variant_gtf(self, ref: int, path: str) -> None:
        parts: List[str] = []
        if ref != -1:
            self.new_labels = [[] for _ in range(self.trs[ref].exons + 2)]
        print_counter = 0
        for order in range(len(self.trs)):
            i = self.order_index[order]
            t = self.trs[i]
            print_counter += 1
            parts.append(f"variant_isoform#{print_counter}")
            parts.append(f" /nex={t.exons}")
            parts.append(f" /L={t.length}")
            if t.ORF_start != -1 and t.ORF_end != -1:
                parts.append(
                    f" /CDS={'<' if t.no_ATG else ''}{t.ORF_start}.."
                    f"{t.ORF_end}{'' if t.has_stop else '>'}")
            else:
                parts.append(" /CDS=..")
            if i == ref:
                rs = t.RefSeq if t.RefSeq is not None else "(null)"
                parts.append(f" /RefSeq={rs}")
            else:
                rs = t.RefSeq if t.RefSeq is not None else ""
                if not t.has_stop:
                    parts.append(f" /RefSeq={rs}")
                else:
                    parts.append(
                        f" /RefSeq={rs}({'Y' if t.start_cons == 1 else 'N'}"
                        f"{'Y' if t.end_cons == 1 else 'N'})")
            if t.ORF_start != -1 and t.ORF_end != -1:
                pl = (t.ORF_end - t.ORF_start + 1) // 3 - 1
                parts.append(
                    f" /ProtL={'>' if (t.no_ATG == 1 or not t.has_stop) else ''}"
                    f"{pl}")
            else:
                parts.append(" /ProtL=..")
            if i != ref:
                if not t.has_stop:
                    parts.append(" /Frame=..")
                elif self.is_in_frame(i, ref) == 0:
                    parts.append(" /Frame=no")
                else:
                    parts.append(" /Frame=yes")
            if i == ref:
                parts.append(" /Type=Ref")
            else:
                comp = self._competing_labels(i, ref)
                irl = self._ir_labels(i, ref)
                new = self._init_term_skip_new_labels(i, ref)
                parts.append(f" /Type={comp}{irl}{new}")
            if print_counter < len(self.trs):
                parts.append("\n")
        with open(path, "w") as f:
            f.write("".join(parts))

    def write_output_file(self, ref: int, path: str) -> None:
        out = [f"{len(self.trs)}\n{self.gen_length_str}\n"]
        print_counter = 0
        for order in range(len(self.trs)):
            i = self.order_index[order]
            t = self.trs[i]
            print_counter += 1
            out.append(f">{print_counter}:{t.exons}:{1 if i == ref else 0}:"
                       f"{1 if t.type == 0 else 0}:")
            # NMD flag
            if not t.has_stop or (t.abs_ORF_start == -1
                                  and t.abs_ORF_end == -1):
                out.append("-1\n")
            elif self.strand == 1:
                if t.second_ORF_index == t.exons - 1:
                    out.append("0\n")
                elif self.exons[t.exon_index[t.second_ORF_index]].right \
                        - t.abs_ORF_end > 50:
                    out.append("1\n")
                else:
                    out.append("0\n")
            else:
                if t.first_ORF_index == 0:
                    out.append("0\n")
                elif t.abs_ORF_start \
                        - self.exons[t.exon_index[t.first_ORF_index]].left > 50:
                    out.append("1\n")
                else:
                    out.append("0\n")
            for j in range(t.exons):
                e = self.exons[t.exon_index[j]]
                out.append(f"{e.left}:{e.right}:"
                           f"{e.rel_left}:{e.rel_right}:{e.polyA}:")
                if t.abs_ORF_start != -1 and t.abs_ORF_end != -1:
                    first_utr = 0
                    second_utr = 0
                    one_color = 1
                    if t.first_ORF_index == j:
                        one_color = 0
                        first_utr = t.abs_ORF_start - e.left
                    if t.second_ORF_index == j:
                        one_color = 0
                        second_utr = e.right - t.abs_ORF_end
                    if one_color:
                        if e.left > t.abs_ORF_end:
                            second_utr = e.right - e.left + 1
                        elif e.right < t.abs_ORF_start:
                            first_utr = e.right - e.left + 1
                    if self.strand == 1:
                        out.append(f"{first_utr}:{second_utr}\n")
                    else:
                        out.append(f"{second_utr}:{first_utr}\n")
                else:
                    out.append("-1:-1\n")
                out.append(f"{e.sequence}\n")
        out.append("#\n")
        with open(path, "w") as f:
            f.write("".join(out))


def run_cds_annotation(workdir: str, gene: str = "GENE",
                       organism: str = "human") -> None:
    """Full stage 7: isoforms.txt + predicted-introns.txt +
    genomic-exonforCCDS.txt + genomic.txt [+ cds] ->
    CCDS_transcripts.txt + VariantGTF.txt."""
    ann = CCDSAnnotator()
    with timing.span("pintron_step7_read"):
        ann.read_cds_annotations(os.path.join(workdir, "cds"))
        ann.read_transcripts(os.path.join(workdir, "isoforms.txt"),
                             os.path.join(workdir, "genomic.txt"))
        ann.read_introns(os.path.join(workdir, "predicted-introns.txt"))
        ann.read_genomic_exons(os.path.join(workdir,
                                            "genomic-exonforCCDS.txt"))
    with timing.span("pintron_step7_align"):
        ann.get_exon_alignments()
        ann.mark_intron_types()
        for t in ann.trs:
            t.length = sum(len(ann.exons[z].sequence) for z in t.exon_index)
        for t in ann.trs:
            ann.mark_transcript_type(t)
    with timing.span("pintron_step7_orf"):
        ann.Tcds = TCDS_DEFAULT
        for i, t in enumerate(ann.trs):
            if t.type == 0:
                t.is_annotated = (1 if ann.get_cds_annotation_for_refseq(i)
                                  else 0)
        for i, t in enumerate(ann.trs):
            if t.type != 0 or t.is_annotated == 0:
                ann.get_longest_orf(i, ann.Tcds)
    with timing.span("pintron_step7_write"):
        ref = ann.set_ref_to_longest_transcript() if ann.trs else -1
        for i in range(len(ann.trs)):
            ann.check_start_end_wrt_ref(ref, i)
        if ann.trs:
            cds_from, cds_to = ann.get_cds_for_gene(ref)
            ann.mark_exon_endpoints(cds_from, cds_to)
        ann.set_cover_exons()
        if ann.trs:
            ann.set_print_order(ref)
        ann.write_variant_gtf(ref, os.path.join(workdir, "VariantGTF.txt"))
        ann.write_output_file(ref, os.path.join(workdir,
                                                "CCDS_transcripts.txt"))
