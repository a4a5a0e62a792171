"""Maximal-embedding enumeration over the MEG
(est-factorizations.c:597-1460).

From each unvisited MEG vertex, enumerate maximal paths ("embeddings"),
memoized per subtree root; prepending a node to child embeddings applies
the same compatibility windows used to build the MEG edges, splitting
overlaps at the best Burset cut.
"""

from __future__ import annotations

from typing import List, Optional

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.factorize.burset import get_burset_frequency_adaptor
from pintron_tpu_torch.factorize.types import Factor
from pintron_tpu_torch.meg.graph import MEG, Pairing, SINK_PAIRING_START


class EmbPairing:
    """A (p, t, l) triple inside an embedding (copies of MEG pairings)."""

    __slots__ = ("p", "t", "l")

    def __init__(self, p: int, t: int, l: int):
        self.p = p
        self.t = t
        self.l = l

    def copy(self) -> "EmbPairing":
        return EmbPairing(self.p, self.t, self.l)


Embedding = List[EmbPairing]


class TimeoutExpired(Exception):
    pass


def update_embedding(embedding: Embedding, node: Pairing, gen_seq: str,
                     config: Config) -> List[Embedding]:
    """est-factorizations.c:765-917: prepend node to the embedding if
    compatible; returns a list with 0 or 1 new embeddings."""
    head = embedding[0]
    out: List[Embedding] = []

    if head.p == SINK_PAIRING_START:
        if node.p >= 0:
            out.append([EmbPairing(node.p, node.t, node.l)])
        return out

    if node.p < 0:
        out.append([e.copy() for e in embedding])
        return out

    small_delta = (head.p + head.l) - node.p
    big_delta = (head.t + head.l) - node.t
    min_fl = config.min_factor_len
    fl = 2 * min_fl
    if small_delta >= fl and big_delta >= fl:
        if small_delta - (node.l + head.l) <= fl:
            if small_delta - big_delta <= fl:
                if (small_delta >= node.l + head.l
                        and big_delta >= node.l + head.l):
                    head_copy_p = head.p
                    head_copy_t = head.t
                    head_copy_l = head.l
                    node_copy_l = node.l
                else:
                    ref_delta = min(small_delta, big_delta)
                    temp_length_node = ref_delta // 2
                    temp_length_head = ref_delta - temp_length_node
                    if temp_length_node > node.l:
                        temp_length_node = node.l
                        temp_length_head = ref_delta - temp_length_node
                    else:
                        if temp_length_head > head.l:
                            temp_length_head = head.l
                            temp_length_node = ref_delta - temp_length_head
                    head_copy_l = temp_length_head
                    head_copy_p = head.p + head.l - head_copy_l
                    head_copy_t = head.t + head.l - head_copy_l
                    node_copy_l = temp_length_node

                is_overlap_on_p = small_delta < (node.l + head.l)
                gap_length_on_p = head_copy_p - node.p - node_copy_l - 1
                gap_length_on_t = head_copy_t - node.t - node_copy_l - 1
                possible_intron_length = gap_length_on_t - max(
                    0, gap_length_on_p)
                is_intron_on_t = (possible_intron_length >= 0
                                  and (config.min_intron_length == 0
                                       or possible_intron_length
                                       >= config.min_intron_length))

                if is_overlap_on_p and is_intron_on_t:
                    # find the best P cut according to Burset frequency
                    best_burset_freq = -1
                    best_P_cut = 0
                    min_P_cut = max(node.p + min_fl, head.p)
                    max_P_cut = min(head.p + head.l - min_fl,
                                    node.p + node.l)
                    for cut in range(min_P_cut, max_P_cut + 1):
                        freq = get_burset_frequency_adaptor(
                            gen_seq, cut - node.p + node.t,
                            cut - head.p + head.t)
                        if freq >= best_burset_freq:
                            best_burset_freq = freq
                            best_P_cut = cut
                    tmpdH = best_P_cut - head.p
                    head_copy_l = head.l - tmpdH
                    head_copy_p = head.p + tmpdH
                    head_copy_t = head.t + tmpdH
                    tmpdN = node.p + node.l - best_P_cut
                    node_copy_l = node.l - tmpdN

                if gap_length_on_t <= fl or is_intron_on_t:
                    copy_embedding = [e.copy() for e in embedding]
                    hc = copy_embedding[0]
                    hc.p = head_copy_p
                    hc.t = head_copy_t
                    hc.l = head_copy_l
                    node_copy = EmbPairing(node.p, node.t, node_copy_l)
                    copy_embedding.insert(0, node_copy)
                    out.append(copy_embedding)
    return out


def maximality_relation(add_emb: Embedding, cmp_emb: Embedding) -> int:
    """est-factorizations.c:1362-1460.  2: add maximal (cmp dominated);
    1: both maximal; 0: cmp maximal (add dominated)."""
    la, lc = len(add_emb), len(cmp_emb)
    if la > lc:
        check = True
        for k in range(lc):
            a, c = add_emb[k], cmp_emb[k]
            if c.p < a.p or c.p + c.l > a.p + a.l:
                check = False
                break
            if c.t < a.t or c.t + c.l > a.t + a.l:
                check = False
                break
        return 2 if check else 1
    if la < lc:
        check = True
        for k in range(la):
            a, c = add_emb[k], cmp_emb[k]
            if a.p < c.p or a.p + a.l > c.p + c.l:
                check = False
                break
            if a.t < c.t or a.t + a.l > c.t + c.l:
                check = False
                break
        return 0 if check else 1
    check = True
    for k in range(la):
        a, c = add_emb[k], cmp_emb[k]
        if a.p < c.p or a.p + a.l > c.p + c.l:
            check = False
            break
        if a.t < c.t or a.t + a.l > c.t + c.l:
            check = False
            break
    if check:
        return 0
    check = True
    for k in range(la):
        a, c = add_emb[k], cmp_emb[k]
        if c.p < a.p or c.p + c.l > a.p + a.l:
            check = False
            break
        if c.t < a.t or c.t + c.l > a.t + a.l:
            check = False
            break
    return 2 if check else 1


class EmbeddingEnumerator:
    """Carries the per-EST memoization (list_of_subtree_embeddings) and
    the timeout ladder hooks."""

    def __init__(self, config: Config, gen_seq: str, deadline_check=None):
        self.config = config
        self.gen_seq = gen_seq
        self.memo = {}  # id(pairing) -> list of embeddings
        self.deadline_check = deadline_check or (lambda: False)
        self._tick = 0

    def _check_timeout_throttled(self):
        # reference checks the timeout every 1024 embeddings
        if self._tick == 0 and self.deadline_check():
            raise TimeoutExpired()
        self._tick = (self._tick + 1) & 1023

    def get_subtree_embeddings(self, root: Pairing) -> List[Embedding]:
        """est-factorizations.c:597-762 (iterative version of the
        recursion; the recursion is over MEG paths which may be long)."""
        cached = self.memo.get(id(root))
        if cached is not None:
            return cached
        if self.deadline_check():
            raise TimeoutExpired()

        root.visited = True
        root.number_of_visits += 1

        embedding_list: List[Embedding] = []
        if not root.adjs:
            embedding_list.append([EmbPairing(root.p, root.t, root.l)])
        else:
            for adj in root.adjs:
                sub = self.get_subtree_embeddings(adj)
                for next_embedding in sub:
                    updated = update_embedding(next_embedding, root,
                                               self.gen_seq, self.config)
                    for add_emb in updated:
                        self._check_timeout_throttled()
                        is_maximal = 2
                        k = 0
                        while k < len(embedding_list) and is_maximal >= 1:
                            cmp_emb = embedding_list[k]
                            is_maximal = maximality_relation(add_emb,
                                                             cmp_emb)
                            if is_maximal == 2:
                                del embedding_list[k]
                            else:
                                k += 1
                        if is_maximal >= 1:
                            embedding_list.append(add_emb)
        self.memo[id(root)] = embedding_list
        return embedding_list


def get_factorizations_from_embeddings(embedding_list: List[Embedding],
                                       config: Config) -> List[List[Factor]]:
    """est-factorizations.c:1292-1356: merge pairings with T-gap <= 2l
    into factors."""
    fl = 2 * config.min_factor_len
    out: List[List[Factor]] = []
    for embedding in embedding_list:
        factorization: List[Factor] = []
        for pair in embedding:
            if not factorization:
                factorization.append(Factor(pair.p, pair.p + pair.l - 1,
                                            pair.t, pair.t + pair.l - 1))
            else:
                last = factorization[-1]
                if (pair.t - last.gen_end - 1) > fl:
                    factorization.append(Factor(pair.p, pair.p + pair.l - 1,
                                                pair.t, pair.t + pair.l - 1))
                else:
                    last.est_end = pair.p + pair.l - 1
                    last.gen_end = pair.t + pair.l - 1
        out.append(factorization)
    return out
