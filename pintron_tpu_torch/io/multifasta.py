"""Multi-FASTA I/O and sequence preprocessing.

Behavior-equivalent rebuild of the reference's preprocessing layer
(reference: src/io-multifasta.c): FASTA parsing, genomic header parsing,
GenBank-id extraction, strand interpretation + reverse-complement,
polyA/polyT tail masking and genomic N-tail stripping.

Exact semantics matter: every masked character changes which seeds the
aligner may use, so these routines reproduce the reference rules
bit-for-bit (masking chars '*'/'#', window length 14, fraction 0.72 —
io-multifasta.h:_POLYA_*).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, TextIO

POLYA_CHR = "*"
POLYT_CHR = "#"
POLYA_MIN_LEN = 14
POLYA_MIN_FRACTION = 0.72

_COMPLEMENT_PAIRS = [
    ("A", "T"), ("C", "G"), ("R", "Y"), ("M", "K"), ("B", "V"), ("D", "H"),
]
_COMP = {}
for _a, _b in _COMPLEMENT_PAIRS:
    for _x, _y in ((_a, _b), (_b, _a)):
        _COMP[_x] = _y
        _COMP[_x.lower()] = _y.lower()
_COMP_TABLE = str.maketrans(
    "".join(_COMP.keys()), "".join(_COMP.values())
)


@dataclass
class EstInfo:
    """A sequence record plus preprocessing state (types.h:_EST_info)."""

    est_id: str = ""
    seq: str = ""            # working sequence (gets masked / RC'd)
    original_seq: str = ""   # unmasked sequence (RC'd together with seq)
    gb: Optional[str] = None
    chromosome: Optional[str] = None
    strand_as_read: str = ""
    strand: int = 1
    fixed_strand: bool = False
    abs_start: int = 0
    abs_end: int = 0
    pref_polyA_length: int = -1
    suff_polyA_length: int = -1
    pref_polyT_length: int = -1
    suff_polyT_length: int = -1
    pref_N_length: int = 0
    suff_N_length: int = 0

    def copy_and_reverse(self) -> "EstInfo":
        """Opposite-strand copy (main-est-fact.c:copy_and_reverse)."""
        rev = EstInfo(
            est_id=self.est_id,
            seq=self.seq,
            original_seq=self.original_seq,
            gb=self.gb,
            chromosome=self.chromosome,
            strand_as_read=self.strand_as_read,
            strand=-self.strand,
            fixed_strand=self.fixed_strand,
        )
        reverse_and_complement(rev)
        rev.pref_polyA_length = self.suff_polyT_length
        rev.suff_polyA_length = self.pref_polyT_length
        rev.pref_polyT_length = self.suff_polyA_length
        rev.suff_polyT_length = self.pref_polyA_length
        return rev


def read_multifasta(fh: TextIO) -> List[EstInfo]:
    """Parse multi-FASTA: '>'-headers, sequence lines concatenated until the
    next header or a literal '#\\#' separator (io-multifasta.c:133-167).
    Trailing control characters are stripped from each line."""
    records: List[EstInfo] = []
    cur: Optional[EstInfo] = None
    chunks: List[str] = []

    def flush():
        nonlocal cur
        if cur is not None:
            cur.seq = "".join(chunks)
            cur.original_seq = cur.seq
            records.append(cur)
            cur = None
        chunks.clear()

    for raw in fh:
        line = raw.rstrip("\r\n")
        # my_getline strips all trailing chars < ' '
        while line and ord(line[-1]) < 32:
            line = line[:-1]
        if line.startswith(">"):
            flush()
            cur = EstInfo(est_id=line[1:])
        elif line == "#\\#":
            flush()
        elif cur is not None and line:
            chunks.append(line)
    flush()
    return records


def set_est_gb_identification(est: EstInfo) -> None:
    """Extract '/gb=...' (or '/GB=') id from the header
    (io-multifasta.c:279-304)."""
    for tag in ("/gb=", "/GB="):
        pos = est.est_id.find(tag)
        if pos >= 0:
            rest = est.est_id[pos + 4:]
            out = []
            for ch in rest:
                if ch in (" ", "/"):
                    break
                out.append(ch)
            est.gb = "".join(out)
            return


def parse_genomic_header(gen: EstInfo) -> None:
    """Parse '>chrN:start:end:strand' (io-multifasta.c:306-423); fall back
    to whole-sequence defaults when malformed."""
    parts = gen.est_id.split(":")
    ok = False
    if len(parts) == 4:
        chrom, start_s, end_s, strand_s = parts
        try:
            abs_start = int(_atoi(start_s))
            abs_end = int(_atoi(end_s))
            strand = int(_atoi(strand_s))
            if abs_start >= 1 and abs_end >= 1 and strand in (-1, 1):
                gen.chromosome = chrom
                gen.abs_start = abs_start
                gen.abs_end = abs_end
                gen.strand = strand
                gen.strand_as_read = strand_s
                ok = True
        except ValueError:
            ok = False
    if not ok:
        gen.chromosome = "unknown"
        gen.abs_start = 1
        gen.abs_end = len(gen.seq)
        gen.strand = 1
        gen.strand_as_read = "+1"


def _atoi(s: str) -> int:
    """C atoi: leading whitespace, optional sign, digits; 0 if none."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


def set_est_strand_and_rc(est: EstInfo, gen: EstInfo) -> None:
    """Interpret strand from the header and reverse-complement if needed
    (io-multifasta.c:425-504).  NM_/NR_ RefSeq ids are plus-strand fixed."""
    is_nm_or_nr = (
        est.gb is not None
        and len(est.gb) >= 3
        and est.gb[0] == "N"
        and est.gb[2] == "_"
        and est.gb[1] in ("M", "R")
    )
    if is_nm_or_nr:
        est.strand_as_read = "1"
        est.strand = 1
        est.fixed_strand = True
    else:
        pos = est.est_id.find("/clone_end=")
        if pos < 0:
            pos = est.est_id.find("/CLONE_END=")
        if pos >= 0:
            rest = est.est_id[pos + 11:]
            out = []
            for ch in rest[:10]:
                if ch in ("\0", "'"):
                    break
                out.append(ch)
            est.strand_as_read = "".join(out)
            valid = False
            if est.strand_as_read == "3":
                est.strand = 1
                valid = True
            elif est.strand_as_read == "5":
                est.strand = -1
                valid = True
            else:
                est.strand = 1
            if valid:
                fpos = est.est_id.find("/fixed_strand=")
                if fpos < 0:
                    fpos = est.est_id.find("/FIXED_STRAND=")
                if fpos >= 0:
                    c = est.est_id[fpos + 14: fpos + 15]
                    est.fixed_strand = c == "1"
        else:
            est.strand = 1
            est.strand_as_read = ""
    if est.strand == -1:
        reverse_and_complement(est)


def reverse_and_complement(est: EstInfo) -> None:
    """RC the working sequence, and OVERWRITE the original sequence with
    the same characters: the reference writes the complemented EST_seq
    bytes into BOTH buffers (io-multifasta.c:512-518), so after masking a
    reverse copy's "original" carries the mask characters too."""
    rc = est.seq.translate(_COMP_TABLE)[::-1]
    est.seq = rc
    est.original_seq = rc


def _polyat_scan(get: "callable", est_len: int):
    """One direction of the polyA/T scan (io-multifasta.c:663-828).
    `get(i)` returns the i-th character scanning from the relevant end.
    Returns (char, masked_len) or (None, 0)."""
    count_A = count_T = 0
    last_A = last_T = 0
    last_A_count = last_T_count = 0
    i = 0
    while i < POLYA_MIN_LEN and i < est_len:
        c = get(i)
        if c == "A":
            count_A += 1
            last_A = i
            last_A_count = count_A
        if c == "T":
            count_T += 1
            last_T = i
            last_T_count = count_T
        i += 1
    running_A, running_T = count_A, count_T
    thr = POLYA_MIN_FRACTION * POLYA_MIN_LEN
    while i < est_len and (running_A >= thr or running_T >= thr):
        drop = get(i - POLYA_MIN_LEN)
        if drop == "A":
            running_A -= 1
        if drop == "T":
            running_T -= 1
        c = get(i)
        if c == "A":
            count_A += 1
            running_A += 1
            last_A = i
            last_A_count = count_A
        if c == "T":
            count_T += 1
            running_T += 1
            last_T = i
            last_T_count = count_T
        i += 1
    if last_A < POLYA_MIN_LEN - 1:
        last_A = POLYA_MIN_LEN - 1
    if last_T < POLYA_MIN_LEN - 1:
        last_T = POLYA_MIN_LEN - 1
    if (last_A_count >= POLYA_MIN_FRACTION * (last_A + 1)) or (
        last_T_count >= POLYA_MIN_FRACTION * (last_T + 1)
    ):
        if (last_A_count / (last_A + 1)) >= (last_T_count / (last_T + 1)):
            return "A", last_A + 1
        return "T", last_T + 1
    return None, 0


def polyat_substitution(est: EstInfo) -> None:
    """Mask polyA ('*') / polyT ('#') runs at both sequence ends
    (io-multifasta.c:663-828, the running-window variant)."""
    est.pref_polyA_length = -1
    est.suff_polyA_length = -1
    est.pref_polyT_length = -1
    est.suff_polyT_length = -1
    est_len = len(est.seq)
    assert est_len > 0
    if est_len < POLYA_MIN_LEN:
        return

    seq = list(est.seq)

    c, mlen = _polyat_scan(lambda i: seq[i], est_len)
    if c is not None:
        sc = POLYA_CHR if c == "A" else POLYT_CHR
        for i in range(mlen):
            seq[i] = sc
        if c == "A":
            est.pref_polyA_length = mlen
        else:
            est.pref_polyT_length = mlen

    c, mlen = _polyat_scan(lambda i: seq[est_len - i - 1], est_len)
    if c is not None:
        sc = POLYA_CHR if c == "A" else POLYT_CHR
        for i in range(mlen):
            seq[est_len - i - 1] = sc
        if c == "A":
            est.suff_polyA_length = mlen
        else:
            est.suff_polyT_length = mlen

    est.seq = "".join(seq)


def ntails_removal(gen: EstInfo) -> None:
    """Strip leading/trailing 'N's from the genomic working sequence
    (io-multifasta.c:830-868).  The original sequence keeps its Ns; output
    coordinates add back pref_N_length."""
    seq = gen.seq
    est_len = len(seq)
    assert est_len > 0
    pref = 0
    while pref < est_len and seq[pref] == "N":
        pref += 1
    gen.pref_N_length = pref if seq[:1] == "N" else 0
    if gen.pref_N_length:
        seq = seq[pref:]
    est_len = len(seq)
    suff = 0
    while suff < est_len and seq[est_len - 1 - suff] == "N":
        suff += 1
    if suff == est_len:
        raise ValueError("The sequence is only composed by Ns.")
    if suff:
        seq = seq[: est_len - suff]
    gen.suff_N_length = suff
    gen.seq = seq
