"""The port's k-mer index (``pintron_tpu_torch.index.kmer``): the JAX
package's tests/test_kmer.py on the port's modules, with the device
lookup (``lookup_ranges_device``, two ``torch.searchsorted`` passes) on
the CPU, and the index held equal to the JAX package's array for array.

python -m pytest tests/test_torch_kmer.py -m cuda runs the lookup on the
card."""

import numpy as np
import pytest
import torch

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.index.gst import SuffixTree
from pintron_tpu_torch.index.kmer import KmerIndex
from pintron_tpu_torch.meg.graph import build_vertex_set


def _random_seq(rng, n):
    return bytes(rng.choice(list(b"ACGT"), n))


def test_kmer_maximal_matches_brute_force():
    rng = np.random.default_rng(5)
    gen = _random_seq(rng, 400)
    pat = gen[50:90] + _random_seq(rng, 30) + gen[200:260]
    idx = KmerIndex(gen, k=12)
    got = set(idx.maximal_matches(pat, min_len=15))
    # brute force: all left-maximal matches >= 15
    expect = set()
    for p in range(len(pat)):
        for t in range(len(gen)):
            if p > 0 and t > 0 and pat[p - 1] == gen[t - 1]:
                continue
            l = 0
            while p + l < len(pat) and t + l < len(gen) \
                    and pat[p + l] == gen[t + l]:
                l += 1
            if l >= 15:
                expect.add((p, t, l))
    assert got == expect


def test_kmer_recalls_gst_pairings():
    rng = np.random.default_rng(11)
    gen = _random_seq(rng, 600)
    pat = gen[100:160] + _random_seq(rng, 20) + gen[350:420]
    cfg = Config()
    tree = SuffixTree(gen)
    V = build_vertex_set(pat, tree, gen, cfg)
    idx = KmerIndex(gen, k=12)
    matches = idx.maximal_matches(pat, min_len=cfg.min_factor_len)
    # pairing (p,t,l) from the GST is a (possibly clipped) prefix of a
    # maximal match at the same diagonal covering [p, p+l)
    cover = {}
    for (p, t, l) in matches:
        cover.setdefault(t - p, []).append((p, p + l))
    missing = []
    for col in V:
        for pr in col:
            if pr.is_source() or pr.is_sink():
                continue
            spans = cover.get(pr.t - pr.p, [])
            if not any(s <= pr.p and pr.p + pr.l <= e for (s, e) in spans):
                missing.append((pr.p, pr.t, pr.l))
    assert not missing, missing[:5]


def test_kmer_device_lookup_matches_host():
    rng = np.random.default_rng(3)
    gen = _random_seq(rng, 300)
    idx = KmerIndex(gen, k=12)
    q = idx.query_hashes(gen[40:120])
    lo_h, hi_h = idx.lookup_ranges(q)
    lo_d, hi_d = idx.lookup_ranges_device(q, "cpu")
    assert lo_d.dtype == hi_d.dtype == torch.int64
    assert (np.asarray(lo_d) == lo_h).all()
    assert (np.asarray(hi_d) == hi_h).all()


def test_kmer_index_equals_the_jax_packages():
    """hashes, positions, query hashes, ranges and maximal matches array
    for array, on a sequence with soft-masked and N bases."""
    from pintron_tpu.index.kmer import KmerIndex as JaxKmerIndex
    rng = np.random.default_rng(7)
    gen = bytes(rng.choice(list(b"ACGTacgtN"), 2000).astype(np.uint8))
    pat = gen[300:420] + bytes(rng.choice(list(b"ACGT"), 40)
                               .astype(np.uint8)) + gen[900:1000]
    for k in (8, 12):
        got, want = KmerIndex(gen, k=k), JaxKmerIndex(gen, k=k)
        for name in ("hashes", "positions"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        q = got.query_hashes(pat)
        np.testing.assert_array_equal(q, want.query_hashes(pat))
        for a, b in zip(got.lookup_ranges(q), want.lookup_ranges(q)):
            np.testing.assert_array_equal(a, b)
        assert got.maximal_matches(pat, 20) == want.maximal_matches(pat, 20)


@pytest.mark.cuda
def test_kmer_lookup_on_the_card_matches_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    gen = bytes(rng.choice(list(b"ACGT"), 100000).astype(np.uint8))
    idx = KmerIndex(gen, k=12)
    q = idx.query_hashes(gen[5000:9000])
    lo, hi = idx.lookup_ranges_device(q)
    assert lo.device.type == "cuda"
    for d, h in zip((lo, hi), idx.lookup_ranges(q)):
        np.testing.assert_array_equal(d.cpu().numpy(), h)
