"""Graphviz (dot) rendering of a MEG, for debugging.

Rebuild of the reference's LOG_GRAPHS facility
(max-emb-graph.c:711-783 print_meg/save_meg_to_filename;
call sites compute-est-fact.c:117-129): when enabled, the MEG is dumped
at four construction stages as ``meg-1-untouched.dot`` ..
``meg-4-after-short-edge-contraction.dot``.  Long pairings (>= 30nt) are
filled yellow; edges whose T-gap minus P-gap is below 4 are red, others
blue.  Enable with the ``PINTRON_LOG_GRAPHS`` environment variable (the
reference's equivalent is a debug build with -DLOG_GRAPHS).
"""

from __future__ import annotations

import os
from typing import TextIO

from pintron_tpu_torch.meg.graph import (MEG, SINK_PAIRING_START,
                                   SOURCE_PAIRING_START)

MIN_UNDERLINE_LEN = 30
MAX_GAP_ON_P = 4


def log_graphs_enabled() -> bool:
    return bool(os.environ.get("PINTRON_LOG_GRAPHS"))


def print_meg(V: MEG, fh: TextIO) -> None:
    """max-emb-graph.c:735-771 (ids assigned in column order)."""
    idx = 0
    for Vi in V:
        for p in Vi:
            p.id = idx
            idx += 1
    fh.write("digraph MEG {\n")
    for Vi in V:
        for p in Vi:
            if p.p == SOURCE_PAIRING_START:
                fh.write(f'n{p.id} [label="source"')
            elif p.p == SINK_PAIRING_START:
                fh.write(f'n{p.id} [label="sink"')
            else:
                fh.write(f'n{p.id} [label="{p.id} ({p.p}-{p.p + p.l}, '
                         f'{p.t}-{p.t + p.l})"')
            if p.l >= MIN_UNDERLINE_LEN:
                fh.write(", style=filled, fillcolor=yellow")
            fh.write("];\n")
            for a in p.adjs:
                fh.write(f"\tn{p.id} -> n{a.id}[fontsize=12")
                if (p.p != SOURCE_PAIRING_START
                        and a.p != SINK_PAIRING_START):
                    fh.write(f',label="P:{a.p - p.p - p.l}\\n'
                             f'T:{a.t - p.t - p.l}\\n'
                             f'D:{(a.t - p.t) - (a.p - p.p)}"')
                    if (a.t - p.t) - (a.p - p.p) < MAX_GAP_ON_P:
                        fh.write(",color=red")
                    else:
                        fh.write(",color=blue")
                fh.write("];\n")
    fh.write("}\n")


def save_meg_to_filename(V: MEG, filename: str) -> None:
    with open(filename, "w") as fh:
        print_meg(V, fh)
