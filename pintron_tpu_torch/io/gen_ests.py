"""Bundled genomic + per-EST MEG serialization (src/io-gen-ests.c).

Format: ``#GENOMICA#`` + single-EST record, then repeated ``#EST#`` +
EST record and ``#MEG#`` + MEG block (io-meg format, ``#\\#``-terminated).
Used by the reference's test tooling to snapshot alignment state.
"""

from __future__ import annotations

from typing import List, TextIO, Tuple

from pintron_tpu_torch.io.meg import read_meg, write_meg
from pintron_tpu_torch.meg.graph import MEG


def _read_single_est(fh: TextIO) -> Tuple[str, str]:
    header = ""
    for line in fh:
        line = line.strip()
        if line:
            header = line
            break
    seq = ""
    for line in fh:
        line = line.strip()
        if line:
            seq = line
            break
    return header.lstrip(">"), seq


def read_gen_ests(fh: TextIO):
    """GEN_ESTS_read (io-gen-ests.c:52-95)."""
    first = ""
    for line in fh:
        line = line.strip()
        if line:
            first = line
            break
    gen = _read_single_est(fh) if first == "#GENOMICA#" else None
    ests: List[Tuple[Tuple[str, str], MEG]] = []
    current = None
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if line == "#EST#":
            current = _read_single_est(fh)
        elif line == "#MEG#":
            meg = read_meg(fh)
            ests.append((current, meg))
    return gen, ests


def write_gen_ests(fh: TextIO, gen: Tuple[str, str],
                   ests: List[Tuple[Tuple[str, str], MEG]]) -> None:
    """GEN_ESTS_write (io-gen-ests.c:98-113)."""
    fh.write("#GENOMICA#\n")
    fh.write(f">{gen[0]}\n{gen[1]}\n")
    fh.write("#\\#\n")
    for (est, meg) in ests:
        fh.write("#EST#\n")
        fh.write(f">{est[0]}\n{est[1]}\n")
        fh.write("#MEG#\n")
        write_meg(fh, meg)
        fh.write("#\\#\n")
