"""Border refinement DP (refine.c:105-192).

Given a pattern gap p and a genomic window t, choose the P-cut (and the
induced T offsets) minimizing prefix+suffix edit errors, ties broken by
the Burset frequency of the induced intron.
"""

from __future__ import annotations

from typing import Tuple

from pintron_tpu_torch.factorize.alignments import edit_distance_full
from pintron_tpu_torch.factorize.burset import get_burset_frequency_adaptor


import functools
from pintron_tpu_torch.native import get_lib, get_scratch


@functools.lru_cache(maxsize=1 << 16)
def general_refine_borders(p: str, min_p_cut: int, max_p_cut: int,
                           t: str, max_errs: int
                           ) -> Tuple[bool, int, int, int, int]:
    """Returns (ok, offset_p, offset_t1, offset_t2, edit_distance);
    offset_t2 already converted to len_t - off_t2 like the reference's
    out parameter."""
    len_p = len(p)
    len_t = len(t)

    lib = get_lib()
    if lib is not None:
        _, _, out = get_scratch(0)
        lib.refine_borders_core(p.encode("latin1"), len_p,
                                min_p_cut, max_p_cut,
                                t.encode("latin1"), len_t, max_errs, out)
        if out[0] >= 0:
            return (bool(out[0]), int(out[1]), int(out[2]), int(out[3]),
                    int(out[4]))
    t_win = min(len_p + max_errs, len_t)
    # Mp = edit_distance(t[:t_win], p): matrix rows over p (second arg)
    Mp = edit_distance_full(t[:t_win], p)
    rt = t[::-1]
    rp = p[::-1]
    Ms = edit_distance_full(rt[:t_win], rp)

    # min over each row (prefix length i of p): best j in 0..t_win
    # Row minima with first-occurrence position (the reference scans left
    # to right with a strict comparison, refine.c:130-159).
    min_pp = Mp.min(axis=1)
    min_pos_pp = Mp.argmin(axis=1)
    min_sp = Ms.min(axis=1)
    min_pos_sp = Ms.argmin(axis=1)
    min_pp[0] = 0
    min_pos_pp[0] = 0
    min_sp[0] = 0
    min_pos_sp[0] = 0

    off_p = int(min_p_cut)
    off_t1 = int(min_pos_pp[min_p_cut])
    off_t2 = int(min_pos_sp[len_p - min_p_cut])
    best = int(min_pp[min_p_cut] + min_sp[len_p - min_p_cut])
    best_burset = get_burset_frequency_adaptor(t, off_t1, len_t - off_t2)
    for i in range(min_p_cut + 1, max_p_cut + 1):
        curr_burset = get_burset_frequency_adaptor(
            t, min_pos_pp[i], len_t - min_pos_sp[len_p - i])
        curr = int(min_pp[i] + min_sp[len_p - i])
        if best > curr or (best == curr and curr_burset > best_burset):
            best = curr
            off_p = i
            off_t1 = int(min_pos_pp[i])
            off_t2 = int(min_pos_sp[len_p - i])
            best_burset = curr_burset
    return (best <= max_errs, off_p, off_t1, len_t - off_t2, best)


def refine_borders(p: str, t: str, max_errs: int
                   ) -> Tuple[bool, int, int, int, int]:
    return general_refine_borders(p, 0, len(p), t, max_errs)
