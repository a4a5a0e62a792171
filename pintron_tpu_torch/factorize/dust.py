"""Dinucleotide-repeat (DUST-style) complexity score
(exon-complexity.c:38-131)."""

from __future__ import annotations

from pintron_tpu_torch.native import get_lib as _get_native_lib

_IDX = {}
for _i, _a in enumerate("ACGT"):
    for _j, _b in enumerate("ACGT"):
        _IDX[_a + _b] = _i * 4 + _j
        _IDX[_a.lower() + _b] = _i * 4 + _j
        _IDX[_a + _b.lower()] = _i * 4 + _j
        _IDX[_a.lower() + _b.lower()] = _i * 4 + _j


import functools


@functools.lru_cache(maxsize=1 << 17)
def dust_score(sequence: str) -> float:
    length = len(sequence)
    if length <= 2:
        return 0.0
    lib = _get_native_lib()
    if lib is not None:
        return lib.dust_score_c(sequence.encode("latin1"), length)
    freq = [0] * 17
    running = 0
    for i in range(length - 1):
        idx = _IDX.get(sequence[i:i + 2], 16)
        running += freq[idx]
        freq[idx] += 1
    dust = (10.0 * running) / (length - 2)
    return dust / length


def dust_score_by_left_and_right(sequence: str, start: int, end: int) -> float:
    return dust_score(sequence[start:end + 1])
