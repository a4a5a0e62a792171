"""Regression harness: the three comparison modes of the reference's
checker (regressionTest/testPIntronOutput.c) plus an order-canonical JSON
mode for the nondeterministic stage-5 equivalence class.

Modes:
  * ``byte``       — exact byte equality (compare(), :8-42)
  * ``json_fields``— field-wise comparison of the checker's ~90 probed
                     nth-occurrence values (compareJson(), :116-220),
                     applied new-format-to-new-format
  * ``sorted_gtf`` — order-insensitive GTF row-set equality
                     (compareGtf()/compareGtfCr(), :270-424)
  * ``canonical``  — full JSON equality modulo isoform/intron numbering
                     (the reference's Perl stage-5 is hash-order
                     nondeterministic; only this canonical form is stable)

CLI: ``python -m pintron_tpu_torch.regression <out_dir> <reference_dir>``
compares full.json + pintron-all-isoforms.gtf and exits nonzero on
mismatch.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple

# compareJson probes these keys (new-format names), at these occurrence
# numbers (1-based, in file order).
JSON_PROBES: List[Tuple[str, int]] = (
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


def byte_equal(path1: str, path2: str) -> bool:
    with open(path1, "rb") as a, open(path2, "rb") as b:
        return a.read() == b.read()


def _nth_value(path: str, key: str, n: int) -> str:
    """returnInfoNextToPattern (:57-112): n-th line containing the key,
    value = the token after the first ':' up to ',' or space."""
    probe = f'"{key}"'
    found = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            if probe in line:
                found += 1
                if found == n:
                    _, _, rest = line.partition(":")
                    return rest.strip().split(",")[0].strip()
    return "<missing>"


def json_fields_equal(path1: str, path2: str,
                      probes=None) -> List[str]:
    """Returns the list of mismatching probes (empty = pass)."""
    probes = probes if probes is not None else JSON_PROBES
    bad = []
    for key, n in probes:
        v1 = _nth_value(path1, key, n)
        v2 = _nth_value(path2, key, n)
        if v1 != v2:
            bad.append(f"{key}#{n}: {v1!r} != {v2!r}")
    return bad


def sorted_gtf_equal(path1: str, path2: str) -> bool:
    with open(path1) as a, open(path2) as b:
        return sorted(l for l in a if l.strip()) \
            == sorted(l for l in b if l.strip())


def canonical_json(path: str):
    """Canonical form invariant under the reference's stage-5
    nondeterminism: isoforms as a sorted multiset (numbering dropped),
    introns with isoform linkage dropped, rest verbatim."""
    obj = json.load(open(path))
    isos = sorted(
        json.dumps({k: v for k, v in iso.items() if k != "number"},
                   sort_keys=True)
        for iso in obj.get("isoforms", {}).values())
    introns = sorted(
        json.dumps({k: v for k, v in i.items() if k != "isoforms"},
                   sort_keys=True)
        for i in obj.get("introns", {}).values())
    rest = {k: v for k, v in obj.items() if k not in ("isoforms", "introns")}
    return isos, introns, rest


def canonical_json_equal(path1: str, path2: str) -> bool:
    return canonical_json(path1) == canonical_json(path2)


def canonical_gtf(path: str):
    """GTF as a multiset of per-transcript row groups with the transcript
    numbering masked — invariant under isoform renumbering."""
    import re
    groups: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            m = re.search(r'transcript_id "([^"]*)"', line)
            tid = m.group(1) if m else ""
            masked = re.sub(r'transcript_id "[^"]*"',
                            'transcript_id "T"', line)
            groups.setdefault(tid, []).append(masked)
    return sorted(tuple(sorted(g)) for g in groups.values())


def canonical_gtf_equal(path1: str, path2: str) -> bool:
    return canonical_gtf(path1) == canonical_gtf(path2)


def _parse_build_ests(path: str):
    """Parse build-ests.txt (compact-compositions output): returns
    (header7, exon_triples, compositions) where each composition is
    (support_header, [(left, right, polya, seq), ...])."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = lines[:7]
    n_exons = int(lines[5])
    exons = []
    for ln in lines[7:7 + n_exons]:
        l, r, p = ln.split(":")
        exons.append((int(l), int(r), int(p)))
    comps = []
    pos = 7 + n_exons
    while pos < len(lines) and lines[pos] != "#":
        hdr = lines[pos]
        chain = [int(x) for x in lines[pos + 1].split(".")]
        seqs = lines[pos + 2:pos + 2 + len(chain)]
        comps.append((hdr, [exons[i] + (seqs[k],)
                            for k, i in enumerate(chain)]))
        pos += 2 + len(chain)
    return header, exons, comps


def stage5_class_equal(out_dir: str, ref_dir: str) -> Dict[str, object]:
    """Membership test for the stage-5 (compact-compositions)
    equivalence class: the reference Perl script iterates hashes in a
    randomized order (PERL_HASH_SEED), so byte-equality of
    build-ests.txt is not expected — but these invariants ARE stable
    across every member of the class
    (dist-scripts/compact-compositions.pl:120-320 semantics):

      * the 7-line header (abs coords, strand, boundary, composition
        count, exon count, coverage length),
      * the multiset of (exon-count, intron chain, support count,
        refseq marker) per composition — the intron chain (internal
        splice boundaries) is the grouping key, so it and its support
        are order-invariant even when external-exon merging picks
        different representatives,
      * the multiset of INTERNAL exon coordinates,
      * genomic-exonforCCDS.txt as a line multiset (RefSeq compositions
        are never merged).

    Also requires the stage-5 INPUT (out-after-intron-agree.txt +
    predicted-introns.txt) to be byte-identical, proving the divergence
    originates at stage 5.  Returns per-invariant booleans + 'ok'."""
    import os
    from collections import Counter

    res: Dict[str, object] = {}

    def _safe_byte_equal(a, b):
        return (os.path.exists(a) and os.path.exists(b)
                and byte_equal(a, b))

    stage4 = ("out-after-intron-agree.txt", "predicted-introns.txt")
    if not any(os.path.exists(os.path.join(ref_dir, n)) for n in stage4):
        # final-outputs-only golden: nothing stage-4/5 to compare
        res["ok"] = False
        res["no_golden_intermediates"] = True
        res["input_byte"] = None
        return res
    res["input_byte"] = all(
        _safe_byte_equal(os.path.join(out_dir, n),
                         os.path.join(ref_dir, n))
        for n in stage4)
    if not os.path.exists(os.path.join(ref_dir, "build-ests.txt")):
        # this golden shipped only final outputs; stage-5 internals
        # cannot be compared — the caller falls back to the reference
        # checker's own tolerant modes on the finals
        res["ok"] = False
        res["no_golden_intermediates"] = True
        return res
    try:
        h1, _e1, c1 = _parse_build_ests(
            os.path.join(out_dir, "build-ests.txt"))
        h2, _e2, c2 = _parse_build_ests(
            os.path.join(ref_dir, "build-ests.txt"))
    except (OSError, ValueError, IndexError):
        res["ok"] = False
        res["parse"] = False
        return res
    res["header"] = h1 == h2
    res["composition_count"] = len(c1) == len(c2)

    def keys(comps):
        out = Counter()
        internals = Counter()
        for hdr, exlist in comps:
            chain = tuple((exlist[i][1], exlist[i + 1][0])
                          for i in range(len(exlist) - 1))
            parts = hdr[1:].split(".", 1)
            support = parts[0]
            refseq = parts[1] if len(parts) > 1 else ""
            out[(len(exlist), chain, support, refseq)] += 1
            for ex in exlist[1:-1]:
                internals[ex[:2]] += 1
        return out, internals

    k1, i1 = keys(c1)
    k2, i2 = keys(c2)
    res["chain_support_multiset"] = k1 == k2
    res["internal_exon_multiset"] = i1 == i2

    def ccds_lines(d):
        p = os.path.join(d, "genomic-exonforCCDS.txt")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return Counter(f.read().splitlines())

    res["ccds_exons"] = ccds_lines(out_dir) == ccds_lines(ref_dir)
    res["ok"] = all(res[k] for k in ("input_byte", "header",
                                     "composition_count",
                                     "chain_support_multiset",
                                     "internal_exon_multiset",
                                     "ccds_exons"))
    return res


def compare_outputs(out_dir: str, ref_dir: str,
                    json_name: str = "full.json",
                    gtf_name: str = "pintron-all-isoforms.gtf"
                    ) -> Dict[str, object]:
    import os
    j1 = os.path.join(out_dir, json_name)
    j2 = os.path.join(ref_dir, json_name)
    g1 = os.path.join(out_dir, gtf_name)
    g2 = os.path.join(ref_dir, gtf_name)
    return {
        "json_byte": byte_equal(j1, j2),
        "gtf_byte": byte_equal(g1, g2),
        "json_fields": json_fields_equal(j1, j2),
        "sorted_gtf": sorted_gtf_equal(g1, g2),
        "json_canonical": canonical_json_equal(j1, j2),
        "gtf_canonical": canonical_gtf_equal(g1, g2),
    }


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m pintron_tpu_torch.regression OUT_DIR REF_DIR",
              file=sys.stderr)
        return 2
    res = compare_outputs(argv[0], argv[1])
    ok = (res["json_byte"] and res["gtf_byte"]) or \
         (res["json_canonical"] and res["gtf_canonical"])
    for k, v in res.items():
        print(f"{k}: {v if not isinstance(v, list) else (v or 'ok')}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
