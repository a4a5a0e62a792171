"""Maximal Embedding Graph (MEG) construction.

Rebuild of the reference's pairing/vertex/edge machinery
(max-emb-graph.c).  A *pairing* (p, t, l) states that
pattern[p:p+l] == text[t:t+l] and the occurrence is maximal in the
suffix-tree sense.  Vertices are grouped in columns: column 0 holds the
source sentinel, column i+1 the pairings starting at pattern position i,
and the last column the sink sentinel — the same layout the reference
keeps in its `pext_array` (max-emb-graph.c:217-380).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.index.gst import SuffixTree, MaximalPairingScanner

# Per-genome alphabet maps (one genome per worker process): identity-keyed
# single-slot cache, rebuilt only when the genome bytes object changes.
_GEN_MAPS = None


def _gen_maps(gen: bytes):
    """(alph_index, alph_size, a256) for the genomic alphabet."""
    global _GEN_MAPS
    if _GEN_MAPS is None or _GEN_MAPS[0] is not gen:
        alphabet = sorted(set(gen))
        alph_index = {c: k for k, c in enumerate(alphabet)}
        a256 = np.full(256, len(alphabet), dtype=np.int64)
        for c, k in alph_index.items():
            a256[c] = k
        _GEN_MAPS = (gen, alph_index, len(alphabet), a256,
                     a256.ctypes.data)
    return _GEN_MAPS[1], _GEN_MAPS[2], _GEN_MAPS[3], _GEN_MAPS[4]

INT_MIN = -(2 ** 31)
INT_MAX = 2 ** 31 - 1
SOURCE_PAIRING_LEN = 200
SINK_PAIRING_LEN = 200
SOURCE_PAIRING_START = INT_MIN
SINK_PAIRING_START = INT_MAX - SINK_PAIRING_LEN


class Pairing:
    __slots__ = ("p", "t", "l", "adjs", "incs", "id", "visited",
                 "number_of_visits")

    def __init__(self, p: int, t: int, l: int):
        self.p = p
        self.t = t
        self.l = l
        self.adjs: List["Pairing"] = []
        self.incs: List["Pairing"] = []
        self.id = -1
        self.visited = False
        self.number_of_visits = 0

    def is_source(self) -> bool:
        return self.p == SOURCE_PAIRING_START

    def is_sink(self) -> bool:
        return self.p == SINK_PAIRING_START

    def __repr__(self):
        if self.is_source():
            return "Pairing(source)"
        if self.is_sink():
            return "Pairing(sink)"
        return f"Pairing({self.p},{self.t},{self.l})"


MEG = List[List[Pairing]]  # columns of pairings


def build_vertex_set(pattern: bytes, tree: SuffixTree, gen: bytes,
                     config: Config) -> MEG:
    """Build the MEG vertex set (max-emb-graph.c:build_vertex_set).

    ``pattern`` is the masked EST working sequence; ``gen`` the (N-stripped)
    genomic sequence the tree indexes.
    """
    plen = len(pattern)
    V: MEG = [[Pairing(SOURCE_PAIRING_START, SOURCE_PAIRING_START,
                       SOURCE_PAIRING_LEN)]]

    # Does the genomic alphabet allow emitting the t==0 occurrence?
    # (fill_list_pairings guard max-emb-graph.c:195: t==0 emitted at slice
    # k==0, or k==1 when the previous symbol IS alphabet char 0.)
    alph_index, alph_size, a256, a256_ptr = _gen_maps(gen)

    from pintron_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "vertex_scan"):
        cols = _native_vertex_scan(lib, pattern, tree, config, a256_ptr,
                                   alph_size)
        if cols is not None:
            V.extend(cols)
            _append_sink_and_cleanup(V)
            return V

    scanner = MaximalPairingScanner(tree, pattern)
    rate = config.min_string_depth_rate
    min_len = config.min_factor_len
    depth = tree.depth
    parent = tree.parent
    start, end = tree.start, tree.end
    lo, hi, occ = tree.lo, tree.hi, tree.leaf_occ

    for i in range(plen):
        avoid = scanner.prev_symbol  # consumed by advance(); cache for fill
        Vi: List[Pairing] = []
        V.append(Vi)
        dst, matched = scanner.advance(i)
        if dst == -1:
            continue
        d = depth[parent[dst]] + matched
        min_sd = int(max(d * rate, float(min_len)))

        symbol_k = alph_index.get(avoid, alph_size)
        # ascend from the deepest edge towards the root
        node = dst
        cur_l = d
        block: Optional[int] = None
        while cur_l >= min_sd:
            b_lo, b_hi = (lo[block], hi[block]) if block is not None else (
                hi[node], hi[node])
            for rng in ((lo[node], b_lo), (b_hi, hi[node])):
                for j in range(rng[0], rng[1]):
                    t = occ[j]
                    if t > 0:
                        if alph_index.get(gen[t - 1], alph_size) != symbol_k:
                            Vi.append(Pairing(i, t, cur_l))
                    else:
                        # t == 0: no previous char; emitted once per the
                        # slice-scan guard
                        if symbol_k != 0 or alph_size > 1:
                            Vi.append(Pairing(i, t, cur_l))
            block = node
            node = parent[node]
            if node <= 0:
                # reached the root: reference would read a NULL up-edge
                # (depth 0 < min_sd always ends the loop first in practice)
                break
            cur_l = depth[node]

        Vi.sort(key=lambda pr: (pr.p, pr.t, pr.l))

        # In-column low-complexity dedup (max-emb-graph.c:301-334):
        # scan pairs (PI before PJ) over the sorted list; removals are
        # decided against the full list, then applied.
        to_remove = set()
        for jj in range(len(Vi) - 1, -1, -1):
            PJ = Vi[jj]
            for ii in range(jj - 1, -1, -1):
                PI = Vi[ii]
                if (PJ.t > PI.t and PJ.t + PJ.l <= PI.t + PI.l) or (
                        PJ.t == PI.t + 1 and PJ.l == PI.l):
                    to_remove.add(jj)
                    break
        if to_remove:
            V[-1] = [pr for k, pr in enumerate(Vi) if k not in to_remove]

    _append_sink_and_cleanup(V)
    return V


def _native_scan_arrays(lib, pattern: bytes, tree: SuffixTree,
                        config: Config, a256_ptr, alph_size):
    """Invoke the C vertex scan; returns ((p, t, l) scratch arrays with
    cached base pointers, n) or None if the native call fails.  The
    arrays are per-process scratch: valid until the next scan."""
    from pintron_tpu_torch.native import np_scratch
    from pintron_tpu_torch.stages import est_fact as _ef
    _ef._TEXT_KEEPALIVE = tree.text  # see the keepalive contract there
    flat = tree.flat_arrays()
    ptrs = flat["_ptrs"]
    plen = len(pattern)
    cap = max(4096, 64 * plen)
    while True:
        out_p, p_ptr = np_scratch("scan_p", cap)
        out_t, t_ptr = np_scratch("scan_t", cap)
        out_l, l_ptr = np_scratch("scan_l", cap)
        cap = out_p.size
        n = lib.vertex_scan(
            tree.text, len(tree.text), pattern, plen,
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
            ptrs[6], ptrs[7], ptrs[8], ptrs[9], ptrs[10], ptrs[11],
            a256_ptr, alph_size,
            config.min_string_depth_rate, config.min_factor_len,
            p_ptr, t_ptr, l_ptr, cap)
        if n == -1:
            return None
        if n < -1:
            cap = -n
            continue
        break
    return (out_p, p_ptr), (out_t, t_ptr), (out_l, l_ptr), int(n)


def _native_vertex_scan(lib, pattern: bytes, tree: SuffixTree,
                        config: Config, a256_ptr, alph_size):
    """Invoke the C vertex scan; returns per-position pairing columns or
    None if the native call is unavailable/failed."""
    arrs = _native_scan_arrays(lib, pattern, tree, config,
                               a256_ptr, alph_size)
    if arrs is None:
        return None
    (out_p, _), (out_t, _), (out_l, _), n = arrs
    plen = len(pattern)
    cols: List[List[Pairing]] = [[] for _ in range(plen)]
    for k in range(n):
        cols[out_p[k]].append(Pairing(int(out_p[k]), int(out_t[k]),
                                      int(out_l[k])))
    return cols


def build_meg_native(pattern: bytes, tree: SuffixTree, gen: bytes,
                     shared_config: Config, config: Config,
                     inc_pairing_len: int):
    """Full native MEG construction: vertex scan + edges + simplification
    + transitive reduction + compaction + complexity-retry ladder, all in
    one C pass per attempt (compute-est-fact.c:90-152 semantics).
    Returns (V, inc_pairing_len, flat_arrays) or (None, inc_pairing_len,
    None) if the native library is unavailable.  flat_arrays is the
    (p, t, l, col, adj_off, adj, nv, ncols) tuple consumed by the native
    embedding enumerator (meg_factorizations)."""
    from pintron_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "meg_build"):
        return None, inc_pairing_len, None

    from pintron_tpu_torch.native import np_scratch

    plen = len(pattern)
    alph_index, alph_size, a256, a256_ptr = _gen_maps(gen)

    while True:
        config.min_factor_len = (shared_config.min_factor_len
                                 + inc_pairing_len)
        arrs = _native_scan_arrays(lib, pattern, tree, config, a256_ptr,
                                   alph_size)
        if arrs is None:
            return None, inc_pairing_len, None
        (in_p, in_p_ptr), (in_t, in_t_ptr), (in_l, in_l_ptr), n = arrs

        cap_v = n + 16
        cap_e = max(8 * n, 1024)
        flags, flags_ptr = np_scratch("meg_flags", 5)
        while True:
            out_p, p_ptr = np_scratch("meg_p", cap_v)
            out_t, t_ptr = np_scratch("meg_t", cap_v)
            out_l, l_ptr = np_scratch("meg_l", cap_v)
            out_col, col_ptr = np_scratch("meg_col", cap_v)
            out_off, off_ptr = np_scratch("meg_off", cap_v + 1)
            out_adj, adj_ptr = np_scratch("meg_adj", cap_e)
            cap_v = min(out_p.size, out_off.size - 1)
            cap_e = out_adj.size
            nv = lib.meg_build(
                in_p_ptr, in_t_ptr, in_l_ptr,
                n, plen,
                config.min_factor_len, config.max_intron_length,
                config.min_intron_length,
                config.max_prefix_discarded_rate,
                config.max_suffix_discarded_rate,
                config.max_pairings_in_MEG,
                config.max_freq_shortest_pairing,
                1 if config.trans_red else 0,
                1 if config.short_edge_comp else 0,
                p_ptr, t_ptr, l_ptr,
                col_ptr, off_ptr,
                adj_ptr, flags_ptr, cap_v, cap_e)
            if nv == -2:
                cap_v = int(flags[3]) + 1
                cap_e = int(flags[4]) + 1
                continue
            if nv < 0:
                return None, inc_pairing_len, None
            break

        too_complex = bool(flags[0])
        if too_complex and (shared_config.min_factor_len + inc_pairing_len
                            + 1 + 2 < plen + 2):
            inc_pairing_len += 1
            continue

        # scratch-backed views (valid until the next MEG build in this
        # process — strictly after this EST is fully processed)
        flat = (out_p, out_t, out_l, out_col, out_off, out_adj,
                nv, plen + 2,
                (p_ptr, t_ptr, l_ptr, col_ptr, off_ptr, adj_ptr))
        return MegFlat(flat), inc_pairing_len, flat


class MegFlat:
    """Flat-array MEG from the native builder: carries just enough
    surface (len = #columns, stats, text writers) for the native per-EST
    flow — no per-vertex Python objects are ever built."""

    __slots__ = ("arrays",)

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return self.arrays[7]

    def stats(self):
        off, nv = self.arrays[4], self.arrays[6]
        return nv, (int(off[nv]) if nv else 0)

    def _format(self, mode: int) -> str:
        import ctypes

        from pintron_tpu_torch.native import get_lib
        lib = get_lib()
        arrs = self.arrays
        adj_off, nv, ncols, ptrs = arrs[4], arrs[6], arrs[7], arrs[8]
        n_adj = int(adj_off[nv]) if nv else 0
        cap = (nv * 72 + 8 + n_adj * 46 if mode == 0 else n_adj * 224) + 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = lib.meg_format(
                ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
                nv, ncols, mode, buf, cap)
            if n < 0:
                cap = -int(n) + 16
                continue
            return buf.raw[:n].decode("latin1")

    def write_meg(self, fh) -> None:
        fh.write(self._format(0))

    def write_intronic_edges(self, fh) -> None:
        fh.write(self._format(1))


def _append_sink_and_cleanup(V: MEG) -> None:
    V.append([Pairing(SINK_PAIRING_START, SINK_PAIRING_START,
                      SINK_PAIRING_LEN)])

    # Cross-column cleanup (max-emb-graph.c:349-375): for adjacent columns
    # (i, i+1), drop from column i+1 any pairing with the same t as one in
    # column i of length >=.
    n = len(V)
    Vi1 = V[n - 2]
    for i in range(n - 3, 0, -1):
        Vi = V[i]
        keep = []
        for I1 in Vi1:
            removed = False
            for I in Vi:
                if I.t == I1.t and I.l >= I1.l:
                    removed = True
                    break
            if not removed:
                keep.append(I1)
        if len(keep) != len(Vi1):
            Vi1[:] = keep
        Vi1 = Vi


def compute_fl(config: Config) -> int:
    return 2 * config.min_factor_len + 1


def compute_gl(config: Config) -> int:
    return 2 * config.min_factor_len + 3


def is_there_an_edge_strict(I: Pairing, J: Pairing, l: int, fl: int,
                            config: Config) -> bool:
    """Strict MEG linking predicate (max-emb-graph.c:393-463)."""
    MAX_OVERLAP = 0.4
    I_is_long = I.l >= 5 * l

    if J.p <= I.p:
        return False
    if J.t <= I.t:
        return False

    if I.p + I.l <= J.p <= I.p + I.l + fl:
        # simple-sequence on P
        if I.t + I.l <= J.t and (
                config.max_intron_length == 0
                or J.t <= I.t + I.l + config.max_intron_length):
            return True
        if (I.t + 2 * l <= J.t + J.l and J.t < I.t + I.l
                and J.p + I.t - I.p - J.t <= fl):
            # overlap on T
            if I_is_long and I.t + I.l - J.t > MAX_OVERLAP * I.l:
                return False
            return True
    elif I.p + 2 * l <= J.p + J.l and J.p < I.p + I.l:
        # overlap on P
        if I.t + I.l <= J.t and (
                config.max_intron_length == 0
                or J.t <= I.t + I.l + config.max_intron_length):
            return True
        if (I.t + 2 * l <= J.t + J.l and J.t < I.t + I.l
                and J.p + I.t - I.p - J.t <= fl):
            return True
    return False


def is_there_an_edge(I: Pairing, J: Pairing, l: int, fl: int,
                     config: Config) -> bool:
    """Relaxed linking predicate used by the embedding DP
    (max-emb-graph.c:465-529)."""
    if I is J:
        return False
    if J.p - I.p < 0 and 0 < J.t - I.t < I.l:
        return False
    if J.p - I.p <= 0 and J.t - I.t <= 0:
        if (J.p - I.p < 0 or J.t - I.t < 0) or J.l < I.l:
            return False

    if I.p + I.l <= J.p <= I.p + I.l + fl:
        if I.t + I.l <= J.t and (
                config.max_intron_length == 0
                or J.t <= I.t + I.l + config.max_intron_length):
            return True
        if (I.t + 2 * l <= J.t + J.l and J.t < I.t + I.l
                and J.p + I.t - I.p - J.t <= fl):
            return True
    elif I.p + 2 * l <= J.p + J.l and J.p < I.p + I.l:
        if I.t + I.l <= J.t and (
                config.max_intron_length == 0
                or J.t <= I.t + I.l + config.max_intron_length):
            return True
        if (I.t + 2 * l <= J.t + J.l and J.t < I.t + I.l
                and J.p + I.t - I.p - J.t <= fl):
            return True
    return False


def build_edge_set(V: MEG, config: Config) -> None:
    """Add adjacency edges plus source/sink links
    (max-emb-graph.c:532-672)."""
    n = len(V)
    l = config.min_factor_len
    fl = compute_fl(config)
    for i in range(1, n - 1):
        for I in V[i]:
            ubound = min(I.p + I.l + fl + 1, n - l)
            for j in range(ubound):
                for J in V[j]:
                    if is_there_an_edge_strict(I, J, l, fl, config):
                        I.adjs.append(J)
                        J.incs.append(I)

    # edges from the source (max-emb-graph.c:554-598)
    p_len = n - 2
    L = config.min_factor_len
    max_p = int(p_len * config.max_prefix_discarded_rate)
    source = V[0][0]
    for i in range(1, max_p + 1):
        for I in V[i]:
            possible_source = True
            for inc in I.incs:
                if not possible_source:
                    break
                disjoint = ((inc.p + inc.l <= I.p or I.p + I.l <= inc.p)
                            and (inc.t + inc.l <= I.t or I.t + I.l <= inc.t))
                possible_source = not disjoint
                possible_source = possible_source and (
                    inc.p + L > I.p or inc.t + L > I.t)
            if possible_source:
                source.adjs.append(I)
                I.incs.append(source)

    # edges to the sink (max-emb-graph.c:600-646)
    min_p = int(p_len * (1.0 - config.max_suffix_discarded_rate))
    sink = V[p_len + 1][0]
    for i in range(1, p_len + 1):
        for I in V[i]:
            if I.p + I.l < min_p:
                continue
            possible_sink = True
            for adj in I.adjs:
                if not possible_sink:
                    break
                disjoint = ((adj.p + adj.l <= I.p or I.p + I.l <= adj.p)
                            and (adj.t + adj.l <= I.t or I.t + I.l <= adj.t))
                possible_sink = not disjoint
                possible_sink = possible_sink and (
                    I.p + I.l + L > adj.p + adj.l
                    or I.t + I.l + L > adj.t + adj.l)
            if possible_sink:
                sink.incs.append(I)
                I.adjs.append(sink)


def meg_stats(V):
    """(tot_pairings, tot_edges) like meg-simplification.c:MEG_stats."""
    if isinstance(V, MegFlat):
        return V.stats()
    tot_p = 0
    tot_e = 0
    for Vi in V:
        for I in Vi:
            tot_p += 1
            tot_e += len(I.adjs)
    return tot_p, tot_e
