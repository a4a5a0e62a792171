"""Burset splice-pattern frequency table (refine-intron.c:376-556).

Dinucleotide donor/acceptor pair frequencies from Burset et al.; the
canonical GT-AG scores 200, GC-AG 126, the U12 AT-AC 8.
"""

from __future__ import annotations

_TABLE = {
    ("AA", "AG"): 1, ("AA", "AT"): 1, ("AA", "GT"): 1,
    ("AC", "CC"): 1,
    ("AG", "AC"): 1, ("AG", "AG"): 5, ("AG", "CT"): 2, ("AG", "GC"): 1,
    ("AG", "TG"): 2,
    ("AT", "AA"): 1, ("AT", "AC"): 8, ("AT", "AG"): 7, ("AT", "AT"): 2,
    ("AT", "GC"): 1, ("AT", "GT"): 1,
    ("CA", "AG"): 1, ("CA", "TT"): 1,
    ("CC", "AG"): 2,
    ("CG", "AG"): 1, ("CG", "CA"): 1,
    ("CT", "AC"): 2, ("CT", "CA"): 1,
    ("GA", "AG"): 8, ("GA", "GT"): 1, ("GA", "TC"): 1, ("GA", "TG"): 1,
    ("GC", "AG"): 126, ("GC", "GG"): 1, ("GC", "TA"): 1,
    ("GG", "AC"): 1, ("GG", "AG"): 11, ("GG", "CA"): 1, ("GG", "GA"): 2,
    ("GG", "TC"): 2,
    ("GT", "AG"): 200, ("GT", "AC"): 4, ("GT", "AT"): 2, ("GT", "CA"): 9,
    ("GT", "CG"): 4, ("GT", "CT"): 3, ("GT", "GC"): 1, ("GT", "GG"): 10,
    ("GT", "GT"): 1, ("GT", "TA"): 7, ("GT", "TC"): 2, ("GT", "TG"): 8,
    ("GT", "TT"): 2,
    ("TA", "AG"): 6, ("TA", "CG"): 1, ("TA", "TC"): 1,
    ("TC", "AG"): 1, ("TC", "GG"): 1,
    ("TG", "AC"): 1, ("TG", "AG"): 7, ("TG", "GG"): 2,
    ("TT", "AG"): 5, ("TT", "AT"): 1, ("TT", "GG"): 1,
}


def get_burset_frequency(donor_pt: str, acceptor_pt: str) -> int:
    return _TABLE.get((donor_pt.upper(), acceptor_pt.upper()), 0)


def get_burset_frequency_adaptor(t: str, cut1: int, cut2: int) -> int:
    """refine-intron.c:362-374: donor = t[cut1:cut1+2], acceptor =
    t[cut2-2:cut2].  Reads beyond the string yield '\\0' bytes in C which
    never match a pattern; model with clamped slices."""
    if cut2 < 2:
        return 0
    donor = t[cut1:cut1 + 2] if cut1 >= 0 else ""
    acceptor = t[cut2 - 2:cut2]
    if len(donor) < 2 or len(acceptor) < 2:
        return 0
    return get_burset_frequency(donor, acceptor)


def check_burset_patterns(genomic_sequence: str, donor_left_on_gen: int,
                          acceptor_right_on_gen: int) -> int:
    """refine-intron.c:346-360 (via real_substring semantics: negative
    starts clamp and shorten)."""
    def sub(idx, length):
        if idx < 0:
            length += idx
            idx = 0
        if length <= 0:
            return ""
        return genomic_sequence[idx:idx + length]

    donor_pt = sub(donor_left_on_gen + 1, 2)
    acceptor_pt = sub(acceptor_right_on_gen - 2, 2)
    if len(donor_pt) < 2 or len(acceptor_pt) < 2:
        return 0
    return get_burset_frequency(donor_pt, acceptor_pt)
