"""MEG serialization (reference: src/io-meg.c).

Format: one ``(p,t,l)`` line per pairing (vertices grouped by EST
position), ``#adj#``, then ``id-id`` edge lines; ``#\\#`` terminates a
MEG inside a GEN_ESTS bundle.
"""

from __future__ import annotations

import re
from typing import TextIO

from pintron_tpu_torch.meg.graph import MEG, Pairing
from pintron_tpu_torch.stages.est_fact import write_meg  # noqa: F401  (re-export)

_PAIRING_RE = re.compile(r"\((-?\d+),(-?\d+),(-?\d+)\)")


def read_meg(fh: TextIO) -> MEG:
    """meg_read (io-meg.c:60-144): parse vertices until ``#adj#``, then
    edges until ``#\\#`` or EOF.  Vertices are bucketed by EST position
    `p` like the reference's pext_array-of-lists."""
    pairings = []
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if line == "#adj#":
            break
        m = _PAIRING_RE.match(line)
        if not m:
            raise ValueError(f"bad pairing line: {line!r}")
        p = Pairing(int(m.group(1)), int(m.group(2)), int(m.group(3)))
        p.id = len(pairings)
        pairings.append(p)

    for line in fh:
        line = line.strip()
        if not line:
            continue
        if line == "#\\#":
            break
        a, b = line.split("-")
        pairings[int(a)].adjs.append(pairings[int(b)])

    # bucket by EST position; source/sink sentinels (types.h:203-206) go
    # into the first/last bucket rather than at their literal positions
    regular = [q.p for q in pairings if not q.is_source() and not q.is_sink()]
    dim = max(regular, default=0)
    graph: MEG = [[] for _ in range(dim + 2)]
    for q in pairings:
        if q.is_source():
            graph[0].append(q)
        elif q.is_sink():
            graph[dim + 1].append(q)
        else:
            graph[q.p].append(q)
    return graph
