"""Test-data generator (rebuild of src/test-data-create.c).

Reads a verbose est-fact report on stdin; after the line
``EST factorizations:`` each 9-field row opens an EST record
(``>id`` + sequence to stdout; a factor quadruple per exon to stderr),
and subsequent 7-field rows add exons until the next 9-field row or the
``Distinct ...`` sentinel.  A sequence field of ``X`` switches to
shifted-coordinate mode (coordinates rebased to the row's second field),
mirroring test-data-create.c:39-105.

Usage: python -m pintron_tpu_torch.tools.test_data_create < report.txt \
           > ests.out 2> factors.out
"""

from __future__ import annotations

import sys
from typing import List, TextIO


def _fields(line: str) -> List[str]:
    return line.split()


def read_rows(fp: TextIO, first_fields: List[str], dest1: TextIO,
              dest2: TextIO) -> None:
    """test-data-create.c:39-105."""
    f = first_fields
    while True:
        if len(f) < 9:
            return
        sxdel = False
        str_conv = 0
        dest1.write(f">{f[1]}\n")
        dest2.write(f">{f[1]}\n")
        if f[8] != "X":
            dest1.write(f"{f[8]}\n")
            dest2.write(f"{f[3]}\t {f[4]}\t {f[5]}\t {f[6]}\n")
        else:
            sxdel = True
            str_conv = int(f[4])
        line = fp.readline()
        if not line:
            return
        f = _fields(line)
        while len(f) != 9 and (not f or f[0] != "Distinct"):
            line = fp.readline()
            if not line:
                return
            f = _fields(line)
            if len(f) == 7 and f[6] != "X":
                dest1.write(f"{f[6]}\n")
                if not sxdel:
                    dest2.write(f"{f[1]}\t {f[2]}\t {f[3]}\t {f[4]}\n")
                else:
                    coord1 = int(f[1]) - str_conv
                    coord2 = int(f[2]) - str_conv
                    dest2.write(f"{coord1}\t {coord2}\t {f[3]}\t {f[4]}\n")
        if len(f) != 9:
            return


def test_create(fp: TextIO, dest1: TextIO, dest2: TextIO) -> None:
    """test-data-create.c:108-120."""
    for line in fp:
        if line.rstrip("\n") == "EST factorizations:":
            # consume lines until the first 9-field row, like the C's
            # initial scan loop (test-data-create.c:56-59)
            for row in fp:
                f = _fields(row)
                if len(f) == 9:
                    read_rows(fp, f, dest1, dest2)
                    break


def main() -> None:
    test_create(sys.stdin, sys.stdout, sys.stderr)


if __name__ == "__main__":
    main()
