"""Stage 5: composition compaction (build-ests.txt).

Rebuild of dist-scripts/compact-compositions.pl: group EST compositions by
identical intron chains, merge externals with polyA-aware rules, reduce
external exons against other compositions' internal exons, then emit the
unique-exon table and per-composition exon chains.

The reference Perl script iterates hashes in a RANDOMIZED order (Perl
hash-seed randomization), so its build-ests.txt is not deterministic
across runs; only the final pipeline outputs are order-invariant.  This
rebuild uses deterministic insertion order instead — downstream stages
produce identical final outputs for any member of the equivalence class.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, TextIO, Tuple


class Composition:
    __slots__ = ("ests", "exons")

    def __init__(self, ests: int, exons: List[List]):
        self.ests = ests
        self.exons = exons  # items: [gen_left, gen_right, est_seq, gen_seq]


def run_compact_compositions(in_fh: TextIO, out_fh: TextIO,
                             genomic_path: str,
                             ccds_out_path: str) -> None:
    # --- genomic header (compact-compositions.pl:56-90) ---
    with open(genomic_path) as g:
        gen_header = g.readline().rstrip("\n")
        m = re.match(r"^>chr([xXyY\d]+):(\d+):(\d+):([-+]?1)", gen_header,
                     re.IGNORECASE)
        if m:
            a, b = int(m.group(2)), int(m.group(3))
            abs_left, abs_right = (a, b) if a < b else (b, a)
            strand = m.group(4)
        else:
            abs_left = 1
            abs_right = 0
            strand = "+1"
            for line in g:
                abs_right += len(line.rstrip("\n"))
    boundary = 0
    out_fh.write(f"{abs_left}\n{abs_right}\n{strand}\n{boundary}\n")
    gen_length = abs_right - abs_left + 1

    # --- parse compositions ---
    content = in_fh.read()
    records = re.split(r"^>", content, flags=re.M)

    composition_hash: Dict[str, Composition] = {}
    polya_hash: Dict[str, int] = {}
    compact_composition: Dict[str, List[str]] = {}

    ccds_out = open(ccds_out_path, "w")

    row_re = re.compile(r"\s*(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\w+)\s+(\w+)")
    for record in records:
        if record == "":
            continue
        lines = record.rstrip("\n").split("\n")
        header = lines[0]
        polya = 0
        mgb = re.search(r"/gb=(\w+)", header)
        if not mgb:
            raise ValueError(f"No GB ID found for {header}")
        gb = mgb.group(1)
        is_refseq = bool(re.match(r"^N[MR]_", gb))

        exon_list: List[List] = []
        for row in lines[1:]:
            if row == "":
                continue
            if row.startswith("#"):
                mp = re.match(r"^#polya=(\d+)", row)
                if mp:
                    polya = int(mp.group(1))
            else:
                mr = row_re.match(row)
                if not mr:
                    raise ValueError("Wrong format file!")
                exon_list.append([int(mr.group(3)), int(mr.group(4)),
                                  mr.group(5), mr.group(6)])

        if gb[:3] in ("NM_", "NR_"):
            for cl in exon_list:
                ccds_out.write(f"{cl[0]} {cl[1]} {cl[2]}\n")

        key_str = ""
        key_must_not_exist = False
        if len(exon_list) > 1:
            key_str = f"{exon_list[0][1]}-"
            for cl in exon_list[1:-1]:
                key_str += f"{cl[0]}-{cl[1]}-"
            key_str += f"{exon_list[-1][0]}-"
            if gb[:3] in ("NM_", "NR_"):
                key_str += gb
                key_must_not_exist = True

        if key_str and key_str in compact_composition:
            assert not key_must_not_exist
            gb_ids = compact_composition[key_str]
            stop = False
            for cid in gb_ids:
                comp = composition_hash[cid]
                first = comp.exons[0]
                last = comp.exons[-1]
                add_first = exon_list[0]
                add_last = exon_list[-1]
                assert first[1] == add_first[1] and last[0] == add_last[0]
                ok = False
                new_last = None
                if polya == 1:
                    if polya_hash[cid] == 1:
                        if last[1] == add_last[1]:
                            new_last = (last[1], last[2], last[3])
                            ok = True
                    else:
                        if last[1] <= add_last[1]:
                            new_last = (add_last[1], add_last[2],
                                        add_last[3])
                            ok = True
                else:
                    if polya_hash[cid] == 1:
                        if last[1] >= add_last[1]:
                            new_last = (last[1], last[2], last[3])
                            ok = True
                    else:
                        if last[1] >= add_last[1]:
                            new_last = (last[1], last[2], last[3])
                        else:
                            new_last = (add_last[1], add_last[2],
                                        add_last[3])
                        ok = True
                if ok:
                    if first[0] <= add_first[0]:
                        new_first = (first[0], first[2], first[3])
                    else:
                        new_first = (add_first[0], add_first[2],
                                     add_first[3])
                    if polya_hash[cid] == 0:
                        polya_hash[cid] = polya
                    first[0] = new_first[0]
                    first[2] = new_first[1]
                    first[3] = new_first[2]
                    last[1] = new_last[0]
                    last[2] = new_last[1]
                    last[3] = new_last[2]
                    comp.ests += 1
                    stop = True
                    break
            if not stop:
                gb_ids.append(gb)
                composition_hash[gb] = Composition(1, exon_list)
                polya_hash[gb] = polya
        else:
            if key_str:
                compact_composition[key_str] = [gb]
                assert gb not in composition_hash
            composition_hash[gb] = Composition(1, exon_list)
            polya_hash[gb] = polya

    ccds_out.close()

    # --- pass 2: exon lookup hashes + polyA per exon ---
    polya_exon_hash: Dict[str, int] = {}
    left_exon_hash: Dict[int, Dict[int, List[str]]] = {}
    right_exon_hash: Dict[int, Dict[int, List[str]]] = {}

    for key, comp in composition_hash.items():
        for i, cl in enumerate(comp.exons):
            exon_key = f"{cl[0]}-{cl[1]}"
            if i == len(comp.exons) - 1:
                if polya_exon_hash.get(exon_key, 0) == 0:
                    polya_exon_hash[exon_key] = polya_hash[key]
            else:
                polya_exon_hash[exon_key] = 0
            left_exon_hash.setdefault(cl[0], {}).setdefault(
                cl[1], []).append(key)
            right_exon_hash.setdefault(cl[1], {}).setdefault(
                cl[0], []).append(key)

    # --- pass 3: reduce external exons (compact-compositions.pl:476-646) ---
    for key, comp in composition_hash.items():
        # Perl guard is scalar(@temp_list) > 2 where temp_list[0] is the EST
        # count, i.e. compositions with >= 2 exons ARE processed
        # (compact-compositions.pl:482).
        if key[:3] in ("NM_", "NR_") or len(comp.exons) < 2:
            continue
        first = comp.exons[0]
        right_temp = right_exon_hash[first[1]]
        left_ordered = sorted(right_temp.keys())
        stop = False
        for cand_left in left_ordered:
            if stop:
                break
            if cand_left == first[0]:
                break
            for cid in right_temp[cand_left]:
                exlist = composition_hash[cid].exons
                found = None
                for k in range(len(exlist) - 1):  # exclude the last exon
                    cl = exlist[k]
                    if cl[0] == cand_left and cl[1] == first[1]:
                        found = cl
                        break
                if found is not None:
                    first[0] = found[0]
                    first[1] = found[1]
                    first[2] = found[2]
                    first[3] = found[3]
                    stop = True
                    break

        if polya_hash[key] == 0:
            last = comp.exons[-1]
            left_temp = left_exon_hash[last[0]]
            right_ordered = sorted(left_temp.keys(), reverse=True)
            stop = False
            for cand_right in right_ordered:
                if stop:
                    break
                if cand_right == last[1]:
                    break
                for cid in left_temp[cand_right]:
                    exlist = composition_hash[cid].exons
                    found = None
                    for k in range(1, len(exlist)):  # exclude the first
                        cl = exlist[k]
                        if cl[0] == last[0] and cl[1] == cand_right:
                            found = cl
                            break
                    if found is not None:
                        last[0] = found[0]
                        last[1] = found[1]
                        last[2] = found[2]
                        last[3] = found[3]
                        polya_hash[key] = polya_hash[cid]
                        stop = True
                        break

    # --- pass 4: unique exon table + composition strings ---
    print_compositions: Dict[str, List] = {}
    print_exon_list: List[str] = []
    print_exon_seq_list: List[str] = []
    print_exon_hash: Dict[str, int] = {}
    # ordered_print_exon_hash: left -> right -> list of (polya, idx, seq)
    ordered_hash: Dict[int, Dict[int, List[Tuple[int, int, str]]]] = {}
    exon_index = 0
    min_left = gen_length + 1
    max_right = 0

    for key, comp in composition_hash.items():
        is_refseq = key[:3] in ("NM_", "NR_")
        composition_str = ""
        for cl in comp.exons:
            if max_right < cl[1]:
                max_right = cl[1]
            if min_left > cl[0]:
                min_left = cl[0]
            exon_key = f"{cl[0]}-{cl[1]}"
            polya = polya_exon_hash[exon_key]
            if is_refseq:
                exon_key += f":{key}"
            if exon_key not in print_exon_hash:
                print_exon_hash[exon_key] = exon_index
                exon_index += 1
                print_exon_list.append(f"{cl[0]}:{cl[1]}:{polya}")
                add_seq = cl[2] if is_refseq else cl[3]
                print_exon_seq_list.append(add_seq)
                ordered_hash.setdefault(cl[0], {}).setdefault(
                    cl[1], []).append((polya, print_exon_hash[exon_key],
                                       add_seq))
            composition_str += f"{print_exon_hash[exon_key]}."
        composition_str = composition_str[:-1]
        if composition_str in print_compositions:
            assert not is_refseq
            print_compositions[composition_str][0] += comp.ests
        else:
            entry: List = [comp.ests]
            if is_refseq:
                entry.append(key)
            print_compositions[composition_str] = entry

    out_fh.write(f"{len(print_compositions)}\n")
    out_fh.write(f"{len(print_exon_list)}\n")
    out_fh.write(f"{max_right}\n")

    hash_map: Dict[int, int] = {}
    ordered_index = 0
    for left in sorted(ordered_hash.keys()):
        for right in sorted(ordered_hash[left].keys()):
            for polya, idx, _seq in ordered_hash[left][right]:
                assert idx not in hash_map
                out_fh.write(f"{left}:{right}:{polya}\n")
                hash_map[idx] = ordered_index
                ordered_index += 1
    assert ordered_index == len(print_exon_list)

    for comp_key, entry in print_compositions.items():
        header = "".join(f".{s}" for s in entry)
        out_fh.write(header + "\n")
        index_list = [int(x) for x in comp_key.split(".")]
        out_fh.write(".".join(str(hash_map[i]) for i in index_list) + "\n")
        for i in index_list:
            out_fh.write(print_exon_seq_list[i] + "\n")

    out_fh.write("#\n*\n")
