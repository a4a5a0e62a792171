"""PolyA signal detection and tail correction (detect-polya.c)."""

from __future__ import annotations

from typing import List, Tuple

from pintron_tpu_torch.factorize.types import Factor


def correct_composition_tail(factorization: List[Factor],
                             genomic_sequence: str,
                             est_sequence: str) -> List[Factor]:
    """Extend the tail exon while bases match exactly
    (detect-polya.c:42-68).  ``est_sequence`` is the UNMASKED sequence."""
    tail = factorization[-1]
    i = tail.est_end + 1
    j = tail.gen_end + 1
    est_length = len(est_sequence)
    gen_length = len(genomic_sequence)
    while (i < est_length and j < gen_length
           and genomic_sequence[j] == est_sequence[i]):
        i += 1
        j += 1
    tail.est_end = i - 1
    tail.gen_end = j - 1
    return factorization


def detect_polya_signal(factorization: List[Factor], genomic_sequence: str,
                        est_sequence: str) -> Tuple[bool, bool]:
    """detect-polya.c:73-166.  Returns (polyA, polyadenil)."""
    tail = factorization[-1]
    est_length = len(est_sequence)
    cleav = est_sequence[tail.est_end + 1:est_length]

    i = 0
    matches = 0
    stop = False
    n = len(cleav)
    while i < n and not stop:
        if cleav[i] in "aA":
            if matches >= 8:
                stop = True
            else:
                matches += 1
                i += 1
        else:
            if matches >= 8:
                stop = True
            else:
                i = n

    polyadenil = False
    if stop:
        i = max(0, tail.gen_end - 39)
        while i <= tail.gen_end and not polyadenil:
            if genomic_sequence[i] in "aA":
                pas = genomic_sequence[i:i + 6]
                # exact-case comparisons only, like the reference's strcmp
                if pas in ("aataaa", "AATAAA", "attaaa", "ATTAAA"):
                    polyadenil = True
            i += 1

    if stop:
        # reject if a genomic A-run straddles the cut
        i = max(0, tail.gen_end - 9)
        matches = 0
        glen = len(genomic_sequence)
        while i <= tail.gen_end + 10 and stop and i < glen:
            if matches >= 6:
                stop = False
            else:
                if genomic_sequence[i] in "aA":
                    matches += 1
                else:
                    matches = 0
                i += 1
        if stop:
            i = tail.gen_end + 1
            count = 0
            while i <= tail.gen_end + 10 and stop and i < glen:
                if count >= 7:
                    stop = False
                else:
                    if genomic_sequence[i] in "aA":
                        count += 1
                    i += 1

    return stop, polyadenil
