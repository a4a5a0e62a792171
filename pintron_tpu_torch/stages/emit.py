"""Stage 8: final JSON + GTF emission.

Rebuild of the reference orchestrator's output step
(dist-scripts/pintron.py:232-761): merges CCDS_transcripts.txt,
VariantGTF.txt, predicted-introns.txt and out-after-intron-agree.txt into
the `file_format_version: 5` JSON document, then derives the GTF
(exon / 5UTR / start_codon / CDS / stop_codon / 3UTR rows).

Output is byte-identical to the reference: the JSON is serialized with
sorted keys at indent 4, and the GTF iterates isoforms in the JSON's
(lexicographic) key order.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

from pintron_tpu_torch.runtime import timing


def _parse_genome_header(genomic_path: str) -> Dict[str, str]:
    with open(genomic_path, encoding="utf-8") as f:
        line = f.readline().rstrip("\r\n")
    m = re.match(r">(chr)?(X|Y|x|y|\d+):\d+:\d+:(\+|-|\+1|-1|1)", line)
    strand = "-" if m.group(3) in ("-1", "-") else "+"
    return {"sequence_id": "chr" + m.group(2), "strand": strand}


def _parse_factorizations(path: str) -> Dict:
    """out-after-intron-agree.txt -> per-EST factorization records."""
    facts: Dict[str, Dict] = {}
    count = 0
    current = None
    with open(path, encoding="utf-8") as f:
        for raw in f:
            l = raw.rstrip()
            if l.startswith(">"):
                count += 1
                gb = re.search(r"/gb=([a-zA-Z_0-9]+)", l).group(1)
                current = {"polyA?": False, "PAS": False, "exons": [],
                           "EST": gb}
                facts[gb] = current
                ce = re.search(r"/clone_end=([35])", l)
                if ce:
                    current["clone end"] = ce.group(1)
            elif re.match(r"#polya=1", l):
                current["polyA?"] = True
            elif re.match(r"#polyad(\S*)=1", l):
                current["PAS"] = True
            elif re.match(r"(\d+) (\d+) (\d+) (\d+)( \S+)? \S+$", l):
                g = re.match(r"(\d+) (\d+) (\d+) (\d+) (\S+) (\S+)$",
                             l).groups()
                exon = {"EST start": int(g[0]), "EST end": int(g[1]),
                        "relative_start": int(g[2]),
                        "relative_end": int(g[3]),
                        "EST sequence": g[4], "genome sequence": g[5]}
                current["exons"].append(exon)
                if current["PAS"]:
                    current["exon"] = exon
    return facts, count


def _parse_variant_gtf(path: str) -> Dict[int, Dict]:
    isoforms: Dict[int, Dict] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            row = re.split(" /", line.rstrip())
            index = int(re.sub(r"^.*\#", "", row.pop(0)))
            iso: Dict = {"exons": [], "polyA?": False, "PAS?": False,
                         "annotated_CDS?": False, "reference_frame?": False}
            for t in row:
                k, v = re.split("=", t, 2)
                if k == "nex":
                    iso["number_of_exons"] = int(v)
                elif k == "L":
                    iso["length"] = int(v)
                elif k == "CDS":
                    if v != "..":
                        iso["annotated_CDS?"] = True
                        m = re.match(r"^(<?)(\d+)\.\.(\d+)(>?)$", v)
                        iso["CDS_start"] = int(m.group(2))
                        iso["CDS_end"] = int(m.group(3))
                        iso["CDS_length"] = iso["CDS_end"] \
                            - iso["CDS_start"] + 1
                        iso["start_codon?"] = m.group(1) != "<"
                        iso["stop_codon?"] = m.group(4) != ">"
                elif k == "RefSeq":
                    m = re.match(r"^(.*?)(\(?([NY])([NY])\)?)?$", v,
                                 flags=re.IGNORECASE)
                    if m:
                        iso["reference_start_codon?"] = m.group(3) != "N"
                        iso["reference_stop_codon?"] = m.group(4) != "N"
                        if m.group(1):
                            iso["RefSeqID"] = m.group(1)
                elif k == "ProtL":
                    if v != ".." and iso["annotated_CDS?"]:
                        m = re.match(r"^(>?)(\d+)$", v, flags=re.IGNORECASE)
                        iso["protein_length"] = int(m.group(2))
                        iso["protein_incomplete?"] = m.group(1) == ">"
                elif k == "Frame":
                    if re.match("^y", v, flags=re.IGNORECASE) \
                            and iso["annotated_CDS?"]:
                        iso["reference_frame?"] = True
                elif k == "Type":
                    if v == "Ref":
                        iso["reference_frame?"] = True
                        if "RefSeqID" in iso:
                            iso["variant_type"] = iso["RefSeqID"] \
                                + " (Reference TR)"
                        else:
                            iso["variant_type"] = "(Reference TR)"
                    else:
                        iso["variant_type"] = re.sub(r"\s+$", "", v)
                elif not re.match(r"^\s*\#", line):
                    raise ValueError(
                        f"Could not parse GTF file {path} ({k}=>{v})")
            isoforms[index] = iso
    return isoforms


def _parse_ccds(path: str, isoforms: Dict[int, Dict]) -> Dict:
    out = {}
    with open(path, encoding="utf-8") as f:
        out["number_of_predicted_isoforms"] = int(f.readline().rstrip())
        out["genome_length"] = int(f.readline().rstrip())
        index = None
        for line in f:
            l = re.sub(r"#.*", "", re.sub(r"\s+", "", line.rstrip()))
            if re.match("^>", l):
                fields = [int(x) for x in l[1:].split(":")]
                index = fields[0]
                if index not in isoforms:
                    raise ValueError(f"CCDS file {path} contains isoform "
                                     f"with index {index} not in variants")
                if fields[1] > isoforms[index]["number_of_exons"]:
                    raise ValueError(f"Wrong number of exons: {index}")
                isoforms[index]["reference?"] = fields[2] != 0
                isoforms[index]["from_RefSeq?"] = fields[3] != 0
                isoforms[index]["NMD_flag"] = fields[4]
            elif re.match(r"^(\d+:){5}(-?\d+:)(-?\d+)$", l):
                vals = l.split(":")
                exon = {"absolute_start": max(0, int(vals[0])),
                        "absolute_end": max(0, int(vals[1])),
                        "relative_start": max(0, int(vals[2])),
                        "relative_end": max(0, int(vals[3])),
                        "5UTR_length": max(0, int(vals[5])),
                        "3UTR_length": max(0, int(vals[6]))}
                exon["length"] = abs(exon["absolute_end"]
                                     - exon["absolute_start"]) + 1
                if int(vals[4]) == 1:
                    isoforms[index]["polyA?"] = True
                # reference checks fields [4]/[5] (polyA and 5UTR) here
                # (pintron.py:459-462), so 5UTR_length is never deleted and
                # 3UTR_length is dropped when the 5UTR field is negative
                if int(vals[4]) < 0:
                    del exon["5UTR_length"]
                if int(vals[5]) < 0:
                    del exon["3UTR_length"]
                isoforms[index]["exons"].append(exon)
            elif re.match("^[acgtACGT]+$", l):
                isoforms[index]["exons"][-1]["sequence"] = l
                isoforms[index]["exons"][-1]["length_on_transcript"] = len(l)
            elif not re.match(r"^\s*\#", line):
                raise ValueError(f"Could not parse CCDS file {path} "
                                 f"at line:\n{line}")
    return out


def _parse_predicted_introns(path: str) -> Dict[int, Dict]:
    introns: Dict[int, Dict] = {}
    index = 1
    with open(path, encoding="utf-8") as f:
        for line in f:
            fl = line.rstrip().split("\t")
            intron = {
                "relative_start": int(fl[0]), "relative_end": int(fl[1]),
                "absolute_start": int(fl[2]), "absolute_end": int(fl[3]),
                "length": int(fl[4]),
                "number_of_supporting_transcripts": int(fl[5]),
                "donor_alignment_error": float(fl[7]),
                "acceptor_alignment_error": float(fl[8]),
                "donor_score": float(fl[9]), "acceptor_score": float(fl[10]),
                "BPS_score": float(fl[11]), "BPS_position": int(fl[12]),
                "type": fl[13], "pattern": fl[14], "repeat_sequence": fl[15],
                "donor_exon_suffix": fl[16], "prefix": fl[17],
                "suffix": fl[18], "acceptor_exon_prefix": fl[19],
                "supporting_transcripts": {i: {} for i in fl[6].split(",")
                                           if i != ""},
            }
            if intron["BPS_position"] < 0:
                del intron["BPS_position"]
            introns[index] = intron
            index += 1
    return introns


def compute_json(workdir: str, output_file: str, pas_tolerance: int = 30,
                 version: str = "") -> dict:
    """Build the full-output JSON document (file_format_version 5)."""
    with timing.span("pintron_step8_parse"):
        genome = _parse_genome_header(os.path.join(workdir, "genomic.txt"))
        facts, n_processed = _parse_factorizations(
            os.path.join(workdir, "out-after-intron-agree.txt"))
        isoforms = _parse_variant_gtf(os.path.join(workdir, "VariantGTF.txt"))
        ccds_meta = _parse_ccds(os.path.join(workdir, "CCDS_transcripts.txt"),
                                isoforms)
        introns = _parse_predicted_introns(
            os.path.join(workdir, "predicted-introns.txt"))

    gene = {
        "file_format_version": 5,
        "program_version": version,
        "isoforms": isoforms,
        "introns": introns,
        "number_of_processed_transcripts": n_processed,
        "number_of_predicted_isoforms":
            ccds_meta["number_of_predicted_isoforms"],
        "genome": {
            "sequence_id": genome["sequence_id"],
            "strand": genome["strand"],
            "length": ccds_meta["genome_length"],
        },
    }

    with timing.span("pintron_step8_link"):
        # exons arrive genome-reversed on '-' strand; normalize then link
        # introns
        for iso in isoforms.values():
            iso["exons"].reverse()
        for iso in isoforms.values():
            iso["exons"].sort(key=lambda x: x["relative_end"])
            iso["introns"] = []
            for nxt, prv in zip(iso["exons"][1:], iso["exons"][:-1]):
                ext = sorted([nxt["absolute_end"], nxt["absolute_start"],
                              prv["absolute_end"], prv["absolute_start"]])
                lb, rb = ext[1] + 1, ext[2] - 1
                for idx, intron in introns.items():
                    if (intron["absolute_start"] == lb
                            and intron["absolute_end"] == rb) or \
                            (intron["absolute_end"] == lb
                             and intron["absolute_start"] == rb):
                        iso["introns"].append(idx)

    with timing.span("pintron_step8_windows"):
        # per-intron supporting-EST alignment windows
        for intron in introns.values():
            pairs = []
            for est in intron["supporting_transcripts"]:
                factor = facts[est]
                gl = [e for e in factor["exons"]
                      if e["relative_end"] == intron["relative_start"] - 1]
                gr = [e for e in factor["exons"]
                      if e["relative_start"] == intron["relative_end"] + 1]
                if len(gl) == 1 and len(gr) == 1:
                    pairs.append((est, gl[0], gr[0]))
            if len(pairs) != intron["number_of_supporting_transcripts"]:
                raise ValueError("intron supporting-factor mismatch")
            for est, donor, acceptor in pairs:
                intron["supporting_transcripts"][est] = {
                    "donor_factor_suffix": donor["EST sequence"][
                        -len(intron["donor_exon_suffix"]):],
                    "acceptor_factor_prefix":
                        acceptor["EST sequence"][
                            :len(intron["acceptor_exon_prefix"])],
                    "acceptor_factor_start": acceptor["EST start"],
                    "donor_factor_end": donor["EST end"],
                    "acceptor_factor_end": acceptor["EST end"],
                    "donor_factor_start": donor["EST start"],
                }

    with timing.span("pintron_step8_write"):
        # transcript sequence + PAS propagation
        for iso in isoforms.values():
            iso["sequence"] = "".join(e["sequence"] for e in iso["exons"])
            if not iso["polyA?"]:
                continue
            last = iso["exons"][-1]
            for fac in facts.values():
                if fac["PAS"] and fac["exon"]["relative_start"] \
                        == last["relative_start"] \
                        and 30 >= fac["exon"]["relative_end"] \
                        - last["relative_end"] >= -30:
                    iso["PAS?"] = True
                    break

        _annotate_cds_features(gene)

        doc = json.dumps(gene, sort_keys=True, indent=4)
        with open(output_file, "w", encoding="utf-8") as f:
            f.write(doc)
        return json.loads(doc)


def _annotate_cds_features(gene: dict) -> None:
    """Per-exon UTR bounds, start/stop codon coordinates, and frames
    (pintron.py:607-755 semantics)."""
    strand = gene["genome"]["strand"]
    for iso in gene["isoforms"].values():
        if not iso["annotated_CDS?"]:
            continue
        cum_t = 0
        cum_g = 0
        start_codon_seq = ""
        stop_codon_seq = ""
        for exon in iso["exons"]:
            cum_t_old = cum_t
            cum_g += exon["length"]
            exon["cumulative_length"] = cum_g
            cum_t += exon["length_on_transcript"]
            exon["cumulative_length_on_transcript"] = cum_t
            if cum_t < iso["CDS_start"] - 1:
                if strand == "+":
                    exon["absolute_5UTR_start"] = exon["absolute_start"]
                    exon["absolute_5UTR_end"] = exon["absolute_end"]
                else:
                    exon["absolute_5UTR_start"] = exon["absolute_end"]
                    exon["absolute_5UTR_end"] = exon["absolute_start"]
                continue
            if cum_t_old > iso["CDS_end"] + 1:
                if strand == "+":
                    exon["absolute_3UTR_start"] = exon["absolute_start"]
                    exon["absolute_3UTR_end"] = exon["absolute_end"]
                else:
                    exon["absolute_3UTR_start"] = exon["absolute_end"]
                    exon["absolute_3UTR_end"] = exon["absolute_start"]
                continue
            if cum_t_old + 1 <= iso["CDS_start"] - 1 <= cum_t:
                if strand == "+":
                    exon["absolute_5UTR_start"] = exon["absolute_start"]
                    exon["absolute_5UTR_end"] = exon["absolute_start"] \
                        + exon["5UTR_length"] - 1
                else:
                    exon["absolute_5UTR_start"] = exon["absolute_end"]
                    exon["absolute_5UTR_end"] = exon["absolute_end"] \
                        - (exon["5UTR_length"] - 1)
            if cum_t_old + 1 <= iso["CDS_end"] + 1 <= cum_t:
                if strand == "+":
                    exon["absolute_3UTR_start"] = exon["absolute_end"] \
                        - (exon["3UTR_length"] - 1)
                    exon["absolute_3UTR_end"] = exon["absolute_end"]
                else:
                    exon["absolute_3UTR_start"] = exon["absolute_start"]
                    exon["absolute_3UTR_end"] = exon["absolute_start"] \
                        + exon["3UTR_length"] - 1

            read_len = 0
            if cum_t_old < iso["CDS_start"] <= cum_t:
                read_len = min(3, cum_t - iso["CDS_start"] + 1)
                pos = iso["CDS_start"] - cum_t_old - 1
                start_codon_seq += exon["sequence"][pos:pos + read_len]
            elif cum_t_old < iso["CDS_start"] + 1 <= cum_t \
                    or cum_t_old < iso["CDS_start"] + 2 <= cum_t:
                read_len = min(iso["CDS_start"] + 2 - cum_t_old,
                               cum_t - cum_t_old)
                start_codon_seq += exon["sequence"][:read_len]
            if read_len > 0:
                if strand == "+":
                    exon["start_codon_absolute_start"] = \
                        exon["absolute_start"] + exon["5UTR_length"]
                    exon["start_codon_absolute_end"] = \
                        exon["absolute_start"] + exon["5UTR_length"] \
                        + read_len - 1
                else:
                    exon["start_codon_absolute_start"] = \
                        exon["absolute_end"] - exon["5UTR_length"] \
                        - read_len + 1
                    exon["start_codon_absolute_end"] = \
                        exon["absolute_end"] - exon["5UTR_length"]

            read_len = 0
            if cum_t_old < iso["CDS_end"] <= cum_t:
                read_len = 3 - len(stop_codon_seq)
                final = iso["CDS_end"] - cum_t_old
                stop_codon_seq += exon["sequence"][final - read_len:final]
            elif cum_t_old < iso["CDS_end"] - 2 <= cum_t:
                read_len = cum_t - (iso["CDS_end"] - 3)
                stop_codon_seq += exon["sequence"][-read_len:]
            elif cum_t_old < iso["CDS_end"] - 1 <= cum_t:
                read_len = 1
                stop_codon_seq += exon["sequence"][0]
            if read_len > 0:
                if strand == "+":
                    exon["stop_codon_absolute_start"] = \
                        exon["absolute_end"] - exon["3UTR_length"] \
                        - read_len + 1
                    exon["stop_codon_absolute_end"] = \
                        exon["absolute_end"] - exon["3UTR_length"]
                else:
                    exon["stop_codon_absolute_start"] = \
                        exon["absolute_start"] + exon["3UTR_length"]
                    exon["stop_codon_absolute_end"] = \
                        exon["absolute_start"] + exon["3UTR_length"] \
                        + read_len - 1

            if cum_t >= iso["CDS_start"] and cum_t_old < iso["CDS_end"] - 3:
                exon["CDS_absolute_start"] = \
                    exon["absolute_start"] + exon["5UTR_length"] \
                    if strand == "+" \
                    else exon["absolute_end"] - exon["5UTR_length"]
                if "stop_codon_absolute_start" in exon:
                    exon["CDS_absolute_end"] = \
                        exon["stop_codon_absolute_start"] - 1 \
                        if strand == "+" \
                        else exon["stop_codon_absolute_end"] + 1
                else:
                    exon["CDS_absolute_end"] = exon["absolute_end"] \
                        if strand == "+" else exon["absolute_start"]

    for iso in gene["isoforms"].values():
        if not iso["annotated_CDS?"]:
            continue
        cum_cds = 0
        cum_stop = 0
        for exon in iso["exons"]:
            frame = (3 - (cum_cds % 3)) % 3
            if "start_codon_absolute_end" in exon:
                exon["start_codon_frame"] = frame
            if "CDS_absolute_end" in exon:
                exon["CDS_frame"] = frame
                cum_cds += abs(exon["CDS_absolute_end"]
                               - exon["CDS_absolute_start"]) + 1
            if "stop_codon_absolute_end" in exon:
                exon["stop_codon_frame"] = cum_stop
                cum_stop += abs(exon["stop_codon_absolute_end"]
                                - exon["stop_codon_absolute_start"]) + 1


def json2gtf(json_file: str, gtf_file: str, gene_name: str,
             all_isoforms: bool = True) -> None:
    with open(json_file, encoding="utf-8") as f:
        entry = json.load(f)
    seq_id = entry["genome"]["sequence_id"]
    strand = entry["genome"]["strand"]
    lines: List[str] = []

    def emit(feature, start, end, frame, iso_id):
        if end < start:
            start, end = end, start
        lines.append("\t".join([
            seq_id, "PIntron", feature, str(start), str(end), ".", strand,
            str(frame),
            f'gene_id "{gene_name}"; transcript_id "{gene_name}.{iso_id}";\n'
        ]))

    for iso_id, iso in entry["isoforms"].items():
        for exon in iso["exons"]:
            if all_isoforms or iso["annotated_CDS?"]:
                emit("exon", exon["absolute_start"], exon["absolute_end"],
                     ".", iso_id)
                if "absolute_5UTR_start" in exon:
                    emit("5UTR", exon["absolute_5UTR_start"],
                         exon["absolute_5UTR_end"], ".", iso_id)
                if "start_codon_absolute_start" in exon:
                    emit("start_codon", exon["start_codon_absolute_start"],
                         exon["start_codon_absolute_end"],
                         exon["start_codon_frame"], iso_id)
                if "CDS_absolute_start" in exon:
                    emit("CDS", exon["CDS_absolute_start"],
                         exon["CDS_absolute_end"], exon["CDS_frame"], iso_id)
                if "stop_codon_absolute_start" in exon:
                    emit("stop_codon", exon["stop_codon_absolute_start"],
                         exon["stop_codon_absolute_end"],
                         exon["stop_codon_frame"], iso_id)
                if "absolute_3UTR_start" in exon:
                    emit("3UTR", exon["absolute_3UTR_start"],
                         exon["absolute_3UTR_end"], ".", iso_id)
    with open(gtf_file, "w", encoding="utf-8") as f:
        f.write("".join(lines))
