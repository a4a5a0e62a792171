"""Factorization stream I/O (reference: src/io-factorizations.c:44-235).

Format: ``>id`` header, then per factorization a block of
``EST_start EST_end GEN_start GEN_end`` quadruples, with ``#polya=`` /
``#polyad=`` flag lines attached to the preceding factorization.
"""

from __future__ import annotations

from typing import List, TextIO

from pintron_tpu_torch.factorize.types import Factor
from pintron_tpu_torch.stages.min_factorization import (EstFactorizations,
                                                  read_factorizations)

__all__ = ["read_factorizations", "write_factorizations",
           "EstFactorizations", "Factor"]


def write_factorizations(fh: TextIO,
                         ests: List[EstFactorizations]) -> None:
    """io-factorizations.c:44-107: emit the quadruple blocks with polyA
    flags per factorization."""
    for est in ests:
        fh.write(f">{est.est_id}\n")
        for fi, factors in enumerate(est.factorizations):
            fh.write(f"\n#polya={1 if est.polya[fi] else 0}\n")
            fh.write(f"#polyad={1 if est.polyadenil[fi] else 0}\n")
            for f in factors:
                fh.write(f"{f.est_start} {f.est_end} "
                         f"{f.gen_start} {f.gen_end}\n")
