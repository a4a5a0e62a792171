"""Genomic suffix-tree index with pairing-query augmentation.

Array-based Ukkonen construction over the genomic locus plus the
augmentation needed for maximal-pairing queries: string depth, suffix
links, per-node "single preceding character" and DFS leaf intervals
(replacing the reference's per-prev-char occurrence slices,
aug_suffix_tree.c:122-245, with an equivalent set formulation).

The matching-statistics walk (`MaximalPairingScanner`) reproduces the
reference traversal exactly — including its path-dependent interaction
between suffix-link fast-forwarding and the "avoid previous character"
left-maximality pruning (max-emb-graph.c:58-163).  That interaction makes
the emitted pairing set depend on traversal history, so it cannot be
recovered from a pure k-mer index; it is inherently sequential pointer
chasing and therefore lives on the host (the batched DP stages downstream
are the TPU-resident part of the pipeline).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# The name of the file layout SuffixTree.save writes and SuffixTree.load
# attaches (the <prefix>.ibuf/.bbuf/.leafidx/.text/.meta.npy files).
# Change it with the layout: a reader that checks it (the ranks of
# parallel.multihost) then never attaches an index of another layout.
INDEX_FORMAT = "pintron-gst-flat-v1"


class SuffixTree:
    """Suffix tree of ``text`` with a unique terminal (byte 0), built with
    Ukkonen's algorithm.  Node 0 is the root.

    Attributes (parallel arrays indexed by node id):
      start/end : edge label into the node, as [start, end) over text+'\\0'
      parent    : parent node id (root: -1)
      slink     : suffix link (root/leaves: -1)
      depth     : string depth (root: 0; leaves include the terminal)
      leaf_idx  : suffix start index for leaves, -1 for internal nodes
      children  : dict first-byte -> child node id (terminal edge under 0)
    """

    __slots__ = (
        "text", "n", "start", "end", "parent", "slink", "_children",
        "depth", "leaf_idx", "lo", "hi", "leaf_occ", "single_char",
        "_flat",
    )

    @property
    def children(self) -> List[Dict[int, int]]:
        """Per-node first-byte -> child maps; reconstructed lazily from
        the flat arrays when the tree was built natively."""
        if self._children is None:
            flat = self._flat
            coff = flat["coff"].tolist()
            cchar = flat["cchar"].tolist()
            cnode = flat["cnode"].tolist()
            self._children = [
                dict(zip(cchar[coff[v]:coff[v + 1]],
                         cnode[coff[v]:coff[v + 1]]))
                for v in range(len(coff) - 1)]
        return self._children

    @children.setter
    def children(self, value):
        self._children = value

    def __init__(self, text: bytes):
        s = text + b"\x00"
        self.text = s
        self.n = len(s)
        n = self.n
        self._flat = None
        if self._build_native():
            return
        # Upper bound on node count: 2n.
        self.start = [0]
        self.end = [0]
        self.parent = [-1]
        self.slink = [-1]
        self.children: List[Dict[int, int]] = [{}]
        self._build()
        self._augment()

    def _build_native(self) -> bool:
        """Build via the C Ukkonen + augmentation (native/dp.c:st_build);
        produces the same arrays (and DFS occurrence order) as the Python
        path, validated by tests."""
        from pintron_tpu_torch.native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "st_build"):
            return False
        import numpy as np
        tlen = self.n
        cap = 2 * tlen + 4
        # one int64 + one uint8 allocation, sliced into the 13 output
        # arrays (st_build writes every entry it uses, so no zeroing)
        ibuf = np.empty(10 * cap + max(tlen, 1) + 1, dtype=np.int64)
        bbuf = np.empty(2 * cap, dtype=np.uint8)

        def isl(k):
            return ibuf[k * cap:(k + 1) * cap]

        start, end, parent, slink = isl(0), isl(1), isl(2), isl(3)
        depth, leaf_idx, lo, hi = isl(4), isl(5), isl(6), isl(7)
        cnode = isl(8)
        coff = ibuf[9 * cap:10 * cap + 1]
        occ = ibuf[10 * cap + 1:10 * cap + 1 + max(tlen, 1)]
        single = bbuf[:cap]
        cchar = bbuf[cap:]
        nn = lib.st_build(self.text, tlen,
                          start.ctypes.data, end.ctypes.data,
                          parent.ctypes.data, slink.ctypes.data,
                          depth.ctypes.data, leaf_idx.ctypes.data,
                          lo.ctypes.data, hi.ctypes.data, occ.ctypes.data,
                          single.ctypes.data, coff.ctypes.data,
                          cchar.ctypes.data, cnode.ctypes.data)
        if nn <= 0:
            return False
        # Padded-allocation ABI: the native scan's int32 shadow copies
        # full-capacity slices (vertex_scan in dp.c), so zero the tails
        # beyond the real node count — defined values, no uninitialized
        # reads, and any accidental deref of a padding entry is 0.
        # cnode/cchar hold coff[nn] edges (< nn), not nn, so zero cnode
        # from its true used length; cchar tails are never shadow-copied.
        for arr, used in ((start, nn), (end, nn), (parent, nn),
                          (slink, nn), (depth, nn), (lo, nn), (hi, nn),
                          (cnode, int(coff[nn])), (coff, nn + 1)):
            arr[used:] = 0
        self.start = start[:nn]
        self.end = end[:nn]
        self.parent = parent[:nn]
        self.slink = slink[:nn]
        self.depth = depth[:nn]
        self.leaf_idx = leaf_idx[:nn]
        self.lo = lo[:nn]
        self.hi = hi[:nn]
        # occurrence count == the root's DFS interval (may be < tlen when
        # the text embeds NUL bytes and the terminal isn't unique)
        self.leaf_occ = occ[:int(hi[0])]
        self.single_char = single[:nn]
        nch = int(coff[nn])
        self._flat = {
            "start": self.start, "end": self.end, "parent": self.parent,
            "slink": self.slink, "depth": self.depth, "single":
            self.single_char, "lo": self.lo, "hi": self.hi,
            "occ": self.leaf_occ, "coff": coff[:nn + 1],
            "cchar": cchar[:nch], "cnode": cnode[:nch],
        }
        self._children = None  # reconstructed lazily from _flat on demand
        return True

    # -- construction -------------------------------------------------------

    def _new_node(self, start: int, end: int, parent: int) -> int:
        self.start.append(start)
        self.end.append(end)
        self.parent.append(parent)
        self.slink.append(-1)
        self.children.append({})
        return len(self.start) - 1

    def _build(self) -> None:
        s = self.text
        n = self.n
        INF = n
        start, end, parent = self.start, self.end, self.parent
        slink, children = self.slink, self.children
        new_node = self._new_node

        active_node = 0
        active_edge = 0   # index into s of first char of active edge
        active_len = 0
        remainder = 0

        for i in range(n):
            c = s[i]
            remainder += 1
            last_internal = -1
            while remainder > 0:
                if active_len == 0:
                    active_edge = i
                ae = s[active_edge]
                child = children[active_node].get(ae, -1)
                if child == -1:
                    # new leaf directly under active_node
                    leaf = new_node(i, INF, active_node)
                    children[active_node][ae] = leaf
                    if last_internal != -1:
                        slink[last_internal] = active_node
                        last_internal = -1
                else:
                    edge_len = min(end[child], i + 1) - start[child]
                    if active_len >= edge_len:
                        active_node = child
                        active_edge += edge_len
                        active_len -= edge_len
                        continue
                    if s[start[child] + active_len] == c:
                        # char already present: extension is implicit
                        active_len += 1
                        if last_internal != -1:
                            slink[last_internal] = active_node
                            last_internal = -1
                        break
                    # split the edge
                    split = new_node(start[child], start[child] + active_len,
                                     active_node)
                    children[active_node][ae] = split
                    start[child] += active_len
                    parent[child] = split
                    children[split][s[start[child]]] = child
                    leaf = new_node(i, INF, split)
                    children[split][c] = leaf
                    if last_internal != -1:
                        slink[last_internal] = split
                    last_internal = split
                remainder -= 1
                if active_node == 0 and active_len > 0:
                    active_len -= 1
                    active_edge = i - remainder + 1
                elif active_node != 0:
                    active_node = slink[active_node] if slink[active_node] != -1 else 0

        # Clamp open leaf edges.
        for v in range(1, len(start)):
            if end[v] > n:
                end[v] = n

    # -- augmentation --------------------------------------------------------

    def _augment(self) -> None:
        nn = len(self.start)
        s = self.text
        n = self.n
        start, end, children = self.start, self.end, self.children
        depth = [0] * nn
        leaf_idx = [-1] * nn
        lo = [0] * nn
        hi = [0] * nn
        single = [0] * nn  # 0 == '\0' sentinel == "mixed or none"
        leaf_occ: List[int] = []

        # Iterative DFS computing depth, leaf indices, DFS leaf intervals
        # and single_char (post-order merge), mirroring
        # aug_suffix_tree.c:fill_node_info semantics.
        stack: List[Tuple[int, bool]] = [(0, False)]
        while stack:
            v, processed = stack.pop()
            if not processed:
                if v != 0:
                    depth[v] = depth[self.parent[v]] + (end[v] - start[v])
                kids = children[v]
                if not kids:
                    # leaf: suffix index = n - depth (text includes terminal)
                    idx = n - depth[v]
                    leaf_idx[v] = idx
                    lo[v] = len(leaf_occ)
                    leaf_occ.append(idx)
                    hi[v] = len(leaf_occ)
                    single[v] = s[idx - 1] if idx > 0 else 0
                else:
                    stack.append((v, True))
                    lo[v] = len(leaf_occ)
                    for ch in kids.values():
                        stack.append((ch, False))
            else:
                hi[v] = len(leaf_occ)
                # single_char: common non-zero child value, else 0
                val = -1
                for ch in children[v].values():
                    cv = single[ch]
                    if cv == 0:
                        val = 0
                        break
                    if val == -1:
                        val = cv
                    elif val != cv:
                        val = 0
                        break
                single[v] = val if val > 0 else 0

        self.depth = depth
        self.leaf_idx = leaf_idx
        self.lo = lo
        self.hi = hi
        self.leaf_occ = leaf_occ
        self.single_char = single
        self._flat = None

    def save(self, prefix: str) -> None:
        """Serialize the index into the canonical single-buffer layout
        (<prefix>.ibuf.npy / .bbuf.npy / .text.npy / .meta.npy) so
        other processes can ATTACH via mmap instead of rebuilding —
        the multi-process fixed cost the reference pays per worker
        (main-est-fact.c:224-240 rebuilds the GST in every process).
        Written under /dev/shm the pages are shared page cache: N
        workers map one copy."""
        import numpy as np
        fl = self.flat_arrays()
        n = self.n
        cap = 2 * n + 4
        nn = len(fl["start"])
        nch = int(fl["coff"][nn])
        nocc = len(fl["occ"])
        ibuf = np.zeros(10 * cap + max(n, 1) + 1, dtype=np.int64)
        bbuf = np.zeros(2 * cap, dtype=np.uint8)
        order = ("start", "end", "parent", "slink", "depth", None,
                 "lo", "hi")
        for k, name in enumerate(order):
            if name is None:
                continue
            a = np.asarray(fl[name])
            ibuf[k * cap:k * cap + len(a)] = a
        cn = np.asarray(fl["cnode"])[:nch]
        ibuf[8 * cap:8 * cap + nch] = cn
        co = np.asarray(fl["coff"])
        ibuf[9 * cap:9 * cap + len(co)] = co
        oc = np.asarray(fl["occ"])
        ibuf[10 * cap + 1:10 * cap + 1 + nocc] = oc
        sg = np.asarray(fl["single"])
        bbuf[:len(sg)] = sg
        cc = np.asarray(fl["cchar"])[:nch]
        bbuf[cap:cap + nch] = cc
        li = np.asarray(self.leaf_idx, dtype=np.int64)
        # atomic per-file publish (write-temp + rename): concurrent
        # savers of the same content-addressed prefix produce identical
        # bytes, so last-rename-wins can never tear a reader's mmap —
        # an in-place np.save would truncate files an attached worker
        # is mapping
        import os as _os
        for suffix, arr in ((".ibuf.npy", ibuf), (".bbuf.npy", bbuf),
                            (".leafidx.npy", li),
                            (".text.npy",
                             np.frombuffer(self.text, dtype=np.uint8)),
                            (".meta.npy",
                             np.array([n, nn, nch, nocc],
                                      dtype=np.int64))):
            tmp = f"{prefix}.tmp{_os.getpid()}{suffix}"
            np.save(tmp, arr)   # np.save keeps the .npy-suffixed name
            _os.replace(tmp, prefix + suffix)

    @classmethod
    def load(cls, prefix: str) -> "SuffixTree":
        """Attach a saved index via mmap (zero build cost; pages shared
        across attaching processes)."""
        import numpy as np
        self = cls.__new__(cls)
        meta = np.load(prefix + ".meta.npy")
        n, nn, nch, nocc = (int(x) for x in meta)
        ibuf = np.load(prefix + ".ibuf.npy", mmap_mode="r")
        bbuf = np.load(prefix + ".bbuf.npy", mmap_mode="r")
        text = np.load(prefix + ".text.npy", mmap_mode="r")
        self.text = text.tobytes()   # bytes object for the c_char_p ABI
        self.n = n
        cap = 2 * n + 4

        def isl(k):
            return ibuf[k * cap:(k + 1) * cap]

        self.start = isl(0)[:nn]
        self.end = isl(1)[:nn]
        self.parent = isl(2)[:nn]
        self.slink = isl(3)[:nn]
        self.depth = isl(4)[:nn]
        self.lo = isl(6)[:nn]
        self.hi = isl(7)[:nn]
        self.leaf_occ = ibuf[10 * cap + 1:10 * cap + 1 + nocc]
        self.single_char = bbuf[:nn]
        self.leaf_idx = np.load(prefix + ".leafidx.npy", mmap_mode="r")
        self._flat = {
            "start": self.start, "end": self.end, "parent": self.parent,
            "slink": self.slink, "depth": self.depth,
            "single": self.single_char, "lo": self.lo, "hi": self.hi,
            "occ": self.leaf_occ,
            "coff": ibuf[9 * cap:9 * cap + nn + 1],
            "cchar": bbuf[cap:cap + max(nch, 1)],
            "cnode": ibuf[8 * cap:8 * cap + max(nch, 1)],
            "_ibuf": ibuf, "_bbuf": bbuf,
        }
        self._children = None
        return self

    def flat_arrays(self):
        """Flattened numpy arrays for the native vertex scan (cached)."""
        if self._flat is not None and "_ptrs" not in self._flat:
            self._flat["_ptrs"] = tuple(
                self._flat[k].ctypes.data
                for k in ("start", "end", "parent", "slink", "depth",
                          "single", "lo", "hi", "occ", "coff", "cchar",
                          "cnode"))
        if self._flat is None:
            # Python-built tree: replicate the native build's single
            # padded buffer layout (each array padded to cap = 2n+4, occ
            # to n) — the C scan's int32 shadow copy reads full-capacity
            # slices, so every array source must tolerate that.
            import numpy as np
            nn = len(self.start)
            cap = 2 * self.n + 4
            ibuf = np.zeros(10 * cap + max(self.n, 1) + 1, dtype=np.int64)
            bbuf = np.zeros(2 * cap, dtype=np.uint8)

            def isl(k, vals):
                a = ibuf[k * cap:(k + 1) * cap]
                a[:len(vals)] = vals
                return a[:max(len(vals), 1)]

            coff_full = ibuf[9 * cap:10 * cap + 1]
            pos = 0
            cchar = bbuf[cap:]
            cnode_full = ibuf[8 * cap:9 * cap]
            for v in range(nn):
                coff_full[v] = pos
                for ch, kid in self.children[v].items():
                    cchar[pos] = ch
                    cnode_full[pos] = kid
                    pos += 1
            coff_full[nn] = pos
            occ = ibuf[10 * cap + 1:10 * cap + 1 + max(self.n, 1)]
            occ[:len(self.leaf_occ)] = self.leaf_occ
            single = bbuf[:cap]
            single[:nn] = np.asarray(self.single_char, dtype=np.uint8)
            self._flat = {
                "start": isl(0, self.start),
                "end": isl(1, self.end),
                "parent": isl(2, self.parent),
                "slink": isl(3, self.slink),
                "depth": isl(4, self.depth),
                "single": single[:nn],
                "lo": isl(6, self.lo),
                "hi": isl(7, self.hi),
                "occ": occ[:len(self.leaf_occ)],
                "coff": coff_full[:nn + 1], "cchar": cchar[:max(pos, 1)],
                "cnode": cnode_full[:max(pos, 1)],
                "_ibuf": ibuf, "_bbuf": bbuf,
            }
            self._flat["_ptrs"] = tuple(
                self._flat[k].ctypes.data
                for k in ("start", "end", "parent", "slink", "depth",
                          "single", "lo", "hi", "occ", "coff", "cchar",
                          "cnode"))
        return self._flat


class MaximalPairingScanner:
    """Stateful walk over the suffix tree for one pattern, reproducing
    max-emb-graph.c:find_deepest_common_node / follow_suffix_link_and_fast_fwd.

    Edges are represented by their destination node; ``(dst, matched)``
    corresponds to the reference's (LST_Edge* final, size_t matched_len)."""

    __slots__ = ("tree", "pattern", "plen", "prev_dst", "prev_matched",
                 "prev_symbol")

    def __init__(self, tree: SuffixTree, pattern: bytes):
        self.tree = tree
        self.pattern = pattern
        self.plen = len(pattern)
        self.prev_dst = -1        # -1 == no previous edge (NULL)
        self.prev_matched = 0
        self.prev_symbol = 0      # '\0'

    def _descend(self, node: int, rel: int, already: int, avoid: int
                 ) -> Tuple[int, int]:
        """find_deepest_common_node_rec.  Returns (dst_node, matched_len);
        dst_node == -1 means NULL (failed at root)."""
        t = self.tree
        s = t.text
        pat = self.pattern
        plen = self.plen
        start, end, children = t.start, t.end, t.children
        single = t.single_char
        while True:
            if rel >= plen:
                # pattern exhausted: final = node's up edge
                if node == 0:
                    return -1, 0
                return node, end[node] - start[node]
            c = pat[rel]
            kid = children[node].get(c, -1)
            if kid != -1 and single[kid] != 0 and single[kid] == avoid:
                kid = -1
            if kid == -1:
                if node == 0:
                    return -1, 0
                return node, end[node] - start[node]
            el = end[kid] - start[kid]
            if el == 1:
                lcp = 1
            elif already > 0:
                if already >= el:
                    lcp = el
                else:
                    lcp = already
                    i = start[kid] + already
                    j = rel + already
                    while lcp < el and j < plen and s[i] == pat[j]:
                        lcp += 1
                        i += 1
                        j += 1
            else:
                lcp = 0
                i = start[kid]
                j = rel
                while lcp < el and j < plen and s[i] == pat[j]:
                    lcp += 1
                    i += 1
                    j += 1
            if rel + lcp >= plen or lcp < el:
                return kid, lcp
            # fully matched this edge: recurse below
            already = already - lcp if already > lcp else 0
            node = kid
            rel += el

    def advance(self, i: int) -> Tuple[int, int]:
        """Process pattern suffix ``i``; returns (dst_node, matched_len) of
        the deepest common edge, with internal state updated for the next
        suffix (max-emb-graph.c:247-338 driver portion)."""
        t = self.tree
        avoid = self.prev_symbol
        if self.prev_dst == -1 or t.slink[t.parent[self.prev_dst]] == -1:
            # no previous edge, or its source is the root (no suffix link)
            dst, matched = self._descend(0, i, 0, avoid)
        else:
            prev_len = t.end[self.prev_dst] - t.start[self.prev_dst]
            if prev_len == self.prev_matched:
                sl = t.slink[self.prev_dst]
                m0 = 0
            else:
                sl = t.slink[t.parent[self.prev_dst]]
                m0 = self.prev_matched
            dst, matched = self._descend(sl, i + t.depth[sl], m0, avoid)
        if dst == -1:
            self.prev_dst = -1
            self.prev_matched = 0
        else:
            self.prev_dst = dst
            self.prev_matched = matched
        self.prev_symbol = self.pattern[i] if i < self.plen else 0
        return dst, matched
