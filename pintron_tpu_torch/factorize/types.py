"""Factorization data model (types.h:_factor and friends)."""

from __future__ import annotations

from typing import List


class Factor:
    """An EST/genomic interval pair (exon candidate); ends inclusive."""

    __slots__ = ("est_start", "est_end", "gen_start", "gen_end")

    def __init__(self, est_start: int, est_end: int,
                 gen_start: int, gen_end: int):
        self.est_start = est_start
        self.est_end = est_end
        self.gen_start = gen_start
        self.gen_end = gen_end

    def copy(self) -> "Factor":
        return Factor(self.est_start, self.est_end,
                      self.gen_start, self.gen_end)

    def __repr__(self):
        return (f"Factor({self.est_start}-{self.est_end}, "
                f"{self.gen_start}-{self.gen_end})")


Factorization = List[Factor]
