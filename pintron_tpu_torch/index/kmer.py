"""K-mer seed index — the batched seeding substrate for APPROXIMATE use.

NOT the production seeding path, by evidence rather than by default:
the reference's pairing emission is traversal-history dependent
(suffix-link fast-forwarding interacts with the avoid-prev-char pruning
and the depth-rate cutoff), so no pure per-position index — k-mer hash,
suffix array or FM ranks — can reproduce it exactly.  See DESIGN.md
"Seeding index" and tools/seeding_evidence.py for the minimal
counterexample; production seeding stays the host state machine
(index/gst.py + the native vertex scan).  This module remains the
batched substrate for use cases that tolerate the fresh-descent
semantics (read filtering, candidate prescreening):

* build: hash every k-mer of the locus, argsort -> (sorted_hash,
  position) arrays.  O(n log n) host build, arrays live happily in HBM.
* lookup: a batch of query k-mer hashes -> contiguous position ranges by
  binary search (`np.searchsorted`, or `torch.searchsorted` on a
  device), fully vectorized over the batch.
* seed-extend (host or device): extend hits left/right to maximal exact
  matches; left-maximality (the reference's "occurrence not preceded by
  the same character as the pattern", max-emb-graph.c:58-140) is a simple
  character comparison here.

`maximal_matches` reproduces the *semantic core* of the reference's
vertex seeding: all left-maximal exact matches of length >= min_len
between an EST and the locus.  (The reference additionally emits clipped
copies of each match at ancestor string-depths and applies
low-complexity dedup — that shaping stays in `meg.graph`.)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BASE = np.zeros(256, dtype=np.int64)
_BASE[ord("C")] = 1
_BASE[ord("c")] = 1
_BASE[ord("G")] = 2
_BASE[ord("g")] = 2
_BASE[ord("T")] = 3
_BASE[ord("t")] = 3


class KmerIndex:
    def __init__(self, seq: bytes, k: int = 12):
        self.k = k
        self.seq = seq
        codes = _BASE[np.frombuffer(seq, dtype=np.uint8)]
        n = len(seq) - k + 1
        if n <= 0:
            self.hashes = np.zeros(0, dtype=np.int64)
            self.positions = np.zeros(0, dtype=np.int64)
            return
        # rolling pack: hash = sum codes[i+j] * 4^(k-1-j)
        h = np.zeros(n, dtype=np.int64)
        for j in range(k):
            h = (h << 2) | codes[j:j + n]
        order = np.argsort(h, kind="stable")
        self.hashes = h[order]
        self.positions = order.astype(np.int64)

    def query_hashes(self, seq: bytes) -> np.ndarray:
        codes = _BASE[np.frombuffer(seq, dtype=np.uint8)]
        n = len(seq) - self.k + 1
        if n <= 0:
            return np.zeros(0, dtype=np.int64)
        h = np.zeros(n, dtype=np.int64)
        for j in range(self.k):
            h = (h << 2) | codes[j:j + n]
        return h

    def lookup_ranges(self, qhashes: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched binary search: (start, end) ranges into `positions`
        for each query hash.  Device-friendly (searchsorted)."""
        lo = np.searchsorted(self.hashes, qhashes, side="left")
        hi = np.searchsorted(self.hashes, qhashes, side="right")
        return lo, hi

    def lookup_ranges_device(self, qhashes, device="cuda"):
        """Same as lookup_ranges on ``device`` (``"cuda"``, the default,
        ``"cuda:N"`` or ``"cpu"``): two ``torch.searchsorted`` passes on
        int64 tensors, exact.  Returns (start, end) int64 tensors on
        ``device``; ``"cuda"`` raises without a card."""
        import torch
        from pintron_tpu_torch.ops.offload import check_card
        device = check_card(device)
        h = torch.from_numpy(self.hashes).to(device)
        q = torch.as_tensor(np.asarray(qhashes, dtype=np.int64),
                            device=device)
        return (torch.searchsorted(h, q, side="left"),
                torch.searchsorted(h, q, side="right"))

    def maximal_matches(self, pattern: bytes, min_len: int
                        ) -> List[Tuple[int, int, int]]:
        """All left-maximal exact matches (p, t, l) with l >= min_len.

        A match starting at (p, t) is reported at its maximal extension
        length; left-maximality means p==0 or t==0 or
        pattern[p-1] != seq[t-1].
        """
        k = self.k
        seq = self.seq
        qh = self.query_hashes(pattern)
        lo, hi = self.lookup_ranges(qh)
        out: List[Tuple[int, int, int]] = []
        seen = set()
        npat = len(pattern)
        nseq = len(seq)
        for p in range(len(qh)):
            for idx in range(lo[p], hi[p]):
                t = int(self.positions[idx])
                # normalize to the left-maximal start of this match
                pp, tt = p, t
                while pp > 0 and tt > 0 and pattern[pp - 1] == seq[tt - 1]:
                    pp -= 1
                    tt -= 1
                key = (pp, tt)
                if key in seen:
                    continue
                seen.add(key)
                # extend right to the maximal length
                l = 0
                while pp + l < npat and tt + l < nseq \
                        and pattern[pp + l] == seq[tt + l]:
                    l += 1
                if l >= min_len:
                    out.append((pp, tt, l))
        out.sort()
        return out
