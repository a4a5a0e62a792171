"""MEG simplification passes.

Rebuild of meg-simplification.c: useless-edge removal, orphan pruning,
short-edge contraction, complexity gates, and transitive reduction over a
topologically sorted graph.  The reference's passes mutate linked lists
while iterating; list *order* is semantically relevant downstream (it
determines enumeration order of embeddings and ultimately output order),
so each pass reproduces the reference's sequential mutation behavior.
"""

from __future__ import annotations

from typing import List, Optional

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.meg.graph import (MEG, Pairing, SINK_PAIRING_START,
                                   compute_gl, meg_stats)


def _remove_identity(lst: List[Pairing], x: Pairing) -> bool:
    """Remove first occurrence by identity (list_remove_element)."""
    for k, e in enumerate(lst):
        if e is x:
            del lst[k]
            return True
    return False


def is_too_complex_for_compaction(V: MEG, config: Config) -> bool:
    """Hard caps pre-compaction (meg-simplification.c:68-87)."""
    tot_p, tot_e = meg_stats(V)
    return tot_e > 1000 or tot_p > 2000


def is_too_complex(V: MEG, config: Config) -> bool:
    """Heuristic complexity gates (meg-simplification.c:89-140)."""
    min_len = 0
    freq_min_len = 0
    tot_p = 0
    tot_e = 0
    est_len = len(V) - 2
    for Vi in V:
        for p in Vi:
            tot_p += 1
            if min_len == 0 or p.l < min_len:
                min_len = p.l
                freq_min_len = 1
            elif p.l == min_len:
                freq_min_len += 1
            tot_e += len(p.adjs)
    if tot_p < 5 or tot_e < 4:
        return False
    if (config.max_pairings_in_MEG != 0
            and tot_p > config.max_pairings_in_MEG
            and freq_min_len > config.max_freq_shortest_pairing * tot_p):
        return True
    if (tot_e > 5 * tot_p
            or tot_p > (2 * est_len) // config.min_factor_len
            or (tot_p > est_len // config.min_factor_len and tot_p >= 50)):
        return True
    return False


def remove_other_sources_and_sinks(V: MEG) -> None:
    """Prune vertices with no adjacents or no incidents, to fixpoint
    (meg-simplification.c:142-190)."""
    n = len(V)
    while True:
        removed = False
        for i in range(1, n - 1):
            Vi = V[i]
            k = 0
            while k < len(Vi):
                I = Vi[k]
                if not I.adjs or not I.incs:
                    removed = True
                    for adj in I.adjs:
                        _remove_identity(adj.incs, I)
                    for inc in I.incs:
                        _remove_identity(inc.adjs, I)
                    del Vi[k]
                else:
                    k += 1
        if not removed:
            break


def remove_useless_edges(V: MEG, config: Config) -> None:
    """Drop edges whose diagonal gap is too large for sequencing error but
    too small for an intron (meg-simplification.c:193-231)."""
    g = compute_gl(config)
    for i in range(1, len(V)):
        for p in V[i]:
            k = 0
            while k < len(p.adjs):
                a = p.adjs[k]
                if a.t != SINK_PAIRING_START:
                    gap = max(a.t - a.p - p.t + p.p, 0)
                    if gap > g and gap < config.min_intron_length:
                        del p.adjs[k]
                        _remove_identity(a.incs, p)
                        continue
                k += 1


def simplify_meg(V: MEG, config: Config) -> None:
    remove_useless_edges(V, config)
    remove_other_sources_and_sinks(V)


def compact_short_edges(V: MEG, config: Config) -> None:
    """Contract edges with equal-length gaps <= 3nt into merged vertices
    (meg-simplification.c:258-312).  New vertices are appended to the tail
    of the source pairing's column and revisited in the same sweep, exactly
    like the reference's live list iteration."""
    n = len(V)
    while True:
        removed = False
        for i in range(1, n):
            Vi = V[i]
            pi = 0
            while pi < len(Vi):
                p = Vi[pi]
                ai = 0
                while ai < len(p.adjs):
                    a = p.adjs[ai]
                    if a.t != SINK_PAIRING_START:
                        compact = False
                        if a.t + a.l - p.t == a.p + a.l - p.p:
                            compact = (a.t >= p.t + p.l
                                       and a.t - p.t - p.l <= 3)
                        if compact:
                            removed = True
                            del p.adjs[ai]
                            _remove_identity(a.incs, p)
                            new_v = Pairing(p.p, p.t, a.p + a.l - p.p)
                            for w in a.adjs:
                                new_v.adjs.append(w)
                                w.incs.append(new_v)
                            for inc in p.incs:
                                new_v.incs.append(inc)
                                inc.adjs.append(new_v)
                            Vi.append(new_v)
                            continue
                    ai += 1
                pi += 1
        remove_other_sources_and_sinks(V)
        if not removed:
            break


def _dfs_topological_ids(order: List[Pairing]):
    """Iterative DFS over the flattened graph computing topological ids
    (meg-simplification.c:360-470).  Returns (ids, is_acyclic)."""
    nv = len(order)
    index = {id(p): k for k, p in enumerate(order)}
    for k, p in enumerate(order):
        p.id = k
    color = [0] * nv
    ids = [0] * nv
    is_acyclic = True
    S: List[int] = [k for k, p in enumerate(order) if not p.incs]
    if not S:
        is_acyclic = False
    progr_id = nv
    visited = 0
    while True:
        while S:
            v_id = S.pop()
            v = order[v_id]
            if color[v_id] == 0:
                color[v_id] = 1
                S.append(v_id)
                for a in v.adjs:
                    aid = a.id
                    if color[aid] == 0:
                        S.append(aid)
                    elif color[aid] == 1:
                        is_acyclic = False
            elif color[v_id] == 1:
                color[v_id] = 2
                progr_id -= 1
                ids[v_id] = progr_id
                visited += 1
        restarted = False
        for k in range(nv):
            if color[k] == 0:
                is_acyclic = False
                S.append(k)
                restarted = True
                break
        if not restarted:
            break
    assert visited == nv
    return ids, is_acyclic


def transitive_reduction(V: MEG) -> bool:
    """Topologically sort the MEG's pairings and remove transitive edges
    (meg-simplification.c:477-632).  Adjacency/incidence lists end up
    ordered as the reference leaves them: adjs in (topologically sorted)
    original order filtered, incs in decreasing processing order.
    Returns False (and leaves the MEG untouched) if the graph is cyclic."""
    order: List[Pairing] = [p for Vi in V for p in Vi]
    ids, is_acyclic = _dfs_topological_ids(order)
    if not is_acyclic:
        return False
    # reorder the flat array topologically; set p.id to topological rank
    nv = len(order)
    for k, p in enumerate(order):
        p.id = ids[k]
    by_rank: List[Optional[Pairing]] = [None] * nv
    for p in order:
        by_rank[p.id] = p
    order = by_rank  # topologically ordered
    # sort adjacency/incidence lists by topological id (list_sort)
    for p in order:
        p.adjs.sort(key=lambda x: x.id)
        p.incs.sort(key=lambda x: x.id)

    outs_star: List[List[Pairing]] = [[] for _ in range(nv)]
    outs_red: List[List[Pairing]] = [[] for _ in range(nv)]
    outs_red_inc: List[List[Pairing]] = [[] for _ in range(nv)]
    in_star = [None] * nv  # per-v bit set replaced by a set of ids

    for i in range(nv - 1, -1, -1):
        v = order[i]
        star = {i}
        outs_star[i].append(v)
        for w in v.adjs:
            keep = (w.id not in star
                    or w.p < v.p or w.t < v.t
                    or w.p + w.l < v.p + v.l or w.t + w.l < v.t + v.l)
            if keep:
                outs_red[i].append(w)
                outs_red_inc[w.id].append(v)
                if not (w.p + w.l < v.p + v.l or w.t + w.l < v.t + v.l):
                    for wa in outs_star[w.id]:
                        if wa.id not in star:
                            if (v.t <= wa.t and v.p <= wa.p
                                    and v.t + v.l <= wa.t + wa.l
                                    and v.p + v.l <= wa.p + wa.l):
                                star.add(wa.id)
                                outs_star[i].append(wa)
    for i in range(nv):
        v = order[i]
        v.adjs = outs_red[i]
        v.incs = outs_red_inc[i]
    return True
