"""A locus's outputs against the upstream's.

The upstream outputs are those of the reference C pipeline
(AlgoLab/PIntron), frozen in ``benchmark/data/<locus>.tar.gz``.  STEPs
2-4 of the upstream are deterministic, so their artifacts are compared
byte for byte.  Its STEP 5 (compact-compositions, Perl) iterates
hashes in a random order, so the finals a run of the upstream writes
are one member of a class; each locus's data names how close to its
golden finals the run must come (``finals``):

  * ``byte``: full.json and the GTF equal the golden's;
  * ``canonical``: equal up to the isoform and intron numbering;
  * ``class``: in the class of finals the upstream's STEP 5 can give:
    the GTF equal up to the numbering, the JSON's introns and top-level
    fields equal up to the numbering, the upstream regression checker's
    probed JSON values equal (regressionTest/testPIntronOutput.c), and
    STEP 5's invariants equal where the golden carries build-ests.txt.

The canonical forms and the checker's probes are a frozen copy of the
port's ``regression.py``; nothing here imports the program.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter

# STEP 2 (est-fact), STEP 3 (exon agreement) and STEP 4 (intron
# agreement) results; processed-megs-info.txt is a log of the run
STEP_ARTIFACTS = ("raw-multifasta-out.txt", "processed-ests.txt",
                  "megs.txt", "processed-megs.txt", "meg-edges.txt",
                  "out-agree.txt", "out-after-intron-agree.txt",
                  "predicted-introns.txt")
FINALS = ("full.json", "pintron-all-isoforms.gtf")
CLASSES = ("byte", "canonical", "class")

JSON_PROBES = (
    [("sequence_id", 1), ("strand", 1)]
    + [("acceptor_alignment_error", n) for n in (1, 2, 3, 4)]
    + [("acceptor_exon_prefix", n) for n in (2, 3, 4)]
    + [("acceptor_score", n) for n in (2, 3, 4)]
    + [("donor_alignment_error", n) for n in (2, 3, 4)]
    + [("donor_exon_suffix", n) for n in (2, 3, 4)]
    + [("donor_score", n) for n in (2, 3, 4)]
    + [("BPS_position", n) for n in (1, 2, 3)]
    + [("BPS_score", n) for n in (2, 3, 4)]
    + [("length", n) for n in (3, 4, 5)]
    + [("number_of_supporting_transcripts", n) for n in (2, 3, 4)]
    + [("pattern", n) for n in (1, 2, 3, 4)]
    + [("prefix", n) for n in (1, 2, 3, 4)]
    + [("suffix", n) for n in (1, 2)]
    + [("relative_end", n) for n in (1, 2, 3, 4)]
    + [("relative_start", n) for n in (1, 2, 3, 4)]
    + [("repeat_sequence", n) for n in (1, 2, 3, 4)]
    + [("acceptor_factor_end", n) for n in (1, 2, 3, 4, 6)]
    + [("acceptor_factor_prefix", n) for n in range(1, 9)]
    + [("acceptor_factor_start", n) for n in range(1, 9)]
    + [("donor_factor_start", n) for n in range(1, 9)]
    + [("RefSeqID", 1), ("annotated_CDS?", 1), ("annotated_CDS?", 2)]
    + [("3UTR_length", 1), ("3UTR_length", 2)]
    + [("cumulative_length", 1)]
    + [("cumulative_length_on_transcript", 1),
       ("cumulative_length_on_transcript", 2)]
    + [("length_on_transcript", 1)]
)


def _read(path: str):
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def differing(work: str, gold: str, names) -> list:
    """The files of ``names`` that are missing from ``work`` or whose
    bytes differ from the golden's."""
    bad = []
    for n in names:
        a = _read(os.path.join(work, n))
        if a is None or a != _read(os.path.join(gold, n)):
            bad.append(n)
    return bad


def _nth_value(path: str, key: str, n: int) -> str:
    probe, found = f'"{key}"', 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            if probe in line:
                found += 1
                if found == n:
                    _, _, rest = line.partition(":")
                    return rest.strip().split(",")[0].strip()
    return "<missing>"


def probes_equal(p1: str, p2: str) -> bool:
    return all(_nth_value(p1, k, n) == _nth_value(p2, k, n)
               for k, n in JSON_PROBES)


def canonical_json(path: str):
    with open(path) as f:
        obj = json.load(f)
    isos = sorted(json.dumps({k: v for k, v in iso.items() if k != "number"},
                             sort_keys=True)
                  for iso in obj.get("isoforms", {}).values())
    introns = sorted(json.dumps({k: v for k, v in i.items()
                                 if k != "isoforms"}, sort_keys=True)
                     for i in obj.get("introns", {}).values())
    rest = {k: v for k, v in obj.items() if k not in ("isoforms", "introns")}
    return isos, introns, rest


def canonical_gtf(path: str):
    groups = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            m = re.search(r'transcript_id "([^"]*)"', line)
            masked = re.sub(r'transcript_id "[^"]*"', 'transcript_id "T"',
                            line)
            groups.setdefault(m.group(1) if m else "", []).append(masked)
    return sorted(tuple(sorted(g)) for g in groups.values())


def _build_ests(path: str):
    with open(path) as f:
        lines = f.read().splitlines()
    n_exons = int(lines[5])
    exons = [tuple(int(x) for x in ln.split(":"))
             for ln in lines[7:7 + n_exons]]
    comps, pos = [], 7 + n_exons
    while pos < len(lines) and lines[pos] != "#":
        chain = [int(x) for x in lines[pos + 1].split(".")]
        comps.append((lines[pos], [exons[i] for i in chain]))
        pos += 2 + len(chain)
    keys, internals = Counter(), Counter()
    for hdr, exl in comps:
        support, _, refseq = hdr[1:].partition(".")
        chain = tuple((exl[i][1], exl[i + 1][0]) for i in range(len(exl) - 1))
        keys[(len(exl), chain, support, refseq)] += 1
        for ex in exl[1:-1]:
            internals[ex[:2]] += 1
    return lines[:7], len(comps), keys, internals


def step5_invariants_equal(work: str, gold: str) -> bool:
    """STEP 5's order-free invariants (the 7-line header, the
    composition count, the multiset of (exons, intron chain, support,
    RefSeq) and of internal exons, genomic-exonforCCDS.txt's lines);
    True where the golden carries no build-ests.txt."""
    if not os.path.exists(os.path.join(gold, "build-ests.txt")):
        return True
    try:
        if _build_ests(os.path.join(work, "build-ests.txt")) != \
                _build_ests(os.path.join(gold, "build-ests.txt")):
            return False
    except (OSError, ValueError, IndexError):
        return False

    def lines(d):
        b = _read(os.path.join(d, "genomic-exonforCCDS.txt"))
        return None if b is None else Counter(b.decode().splitlines())
    return lines(work) == lines(gold)


def finals_class(work: str, gold: str) -> str:
    """The closest class the run's finals reach: byte, canonical, class
    or diff."""
    if not differing(work, gold, FINALS):
        return "byte"
    jw, jg = (os.path.join(d, FINALS[0]) for d in (work, gold))
    gw, gg = (os.path.join(d, FINALS[1]) for d in (work, gold))
    try:
        cw, cg = canonical_json(jw), canonical_json(jg)
        gtf_equal = canonical_gtf(gw) == canonical_gtf(gg)
    except (OSError, ValueError):
        return "diff"
    if cw == cg and gtf_equal:
        return "canonical"
    if (gtf_equal and cw[1:] == cg[1:] and probes_equal(jw, jg)
            and step5_invariants_equal(work, gold)):
        return "class"
    return "diff"


def check_locus(work: str, gold: str, want: str, gene: str) -> dict:
    """One golden locus's run: {"artifacts": the STEP 2-4 artifacts
    that differ, "finals": the class reached, "finals_ok": whether it
    is at least ``want``, "gene_ok": every GTF row carries ``gene``}."""
    bad = differing(work, gold, STEP_ARTIFACTS)
    got = finals_class(work, gold)
    ok = got != "diff" and CLASSES.index(got) <= CLASSES.index(want)
    gtf = _read(os.path.join(work, FINALS[1])) or b""
    labels = set(re.findall(rb'gene_id "([^"]*)"', gtf))
    return {"artifacts": bad, "finals": got, "finals_ok": ok,
            "gene_ok": bool(labels) and labels == {gene.encode()}}
