"""The port's plain PyTorch K-band ops against the JAX package's ops,
the Pallas kernel (interpret mode) and the native C core.  The DP is
int32, so every comparison is exact equality."""

import numpy as np
import pytest
import torch

from pintron_tpu.native import get_lib
from pintron_tpu.ops.align import (banded_edit_distance as jax_banded,
                                   batch_edit_distance_score as jax_full)
from pintron_tpu_torch.ops import align

CODES = np.concatenate([np.frombuffer(b"ACGTN*#n", dtype=np.int8),
                        np.array([-56, -1], dtype=np.int8)])


def kband_batch(rng, B, n_cols, m_cols, k_max):
    """Seeded K-band problems, a quarter of each kind: len1 - len2 ==
    band, len1 - len2 < band, band covering the matrix, and unrelated
    lengths (len1 < len2 and empty sequences included).  Nearly every
    problem has rows past len2.  Codes include masked bytes and bytes
    >= 128."""
    s1 = CODES[rng.integers(0, len(CODES), (B, n_cols))]
    s2 = CODES[rng.integers(0, len(CODES), (B, m_cols))]
    len1 = np.zeros(B, dtype=np.int32)
    len2 = np.zeros(B, dtype=np.int32)
    band = rng.integers(1, k_max + 1, B).astype(np.int32)
    for b in range(B):
        k = int(band[b])
        mode = b % 4
        if mode == 3:
            n = int(rng.integers(0, n_cols + 1))
            m = int(rng.integers(0, m_cols + 1))
        else:
            m = (int(rng.integers(1, m_cols + 1)) if mode < 2
                 else int(rng.integers(1, max(2, 2 * k))))
            d = k if mode == 0 else int(rng.integers(0, k + 1))
            n = min(m + d, n_cols)
            m = min(m, n)
            s2[b, :m] = s1[b, :m]
            for _ in range(int(rng.integers(0, 1 + m // 6))):
                s2[b, rng.integers(0, m)] = CODES[rng.integers(0, len(CODES))]
        len1[b], len2[b] = n, m
    return s1, len1, s2, len2, band


def _torch(*arrays):
    return align.from_numpy_batch(*arrays, device=torch.device("cpu"))


@pytest.mark.parametrize("seed,k_max", [(1, 4), (2, 8), (3, 16)])
def test_banded_matches_jax(seed, k_max):
    rng = np.random.default_rng(seed)
    s1, l1, s2, l2, band = kband_batch(rng, 1024, 96, 64, k_max)
    want = np.asarray(jax_banded(s1, l1, s2, l2, band, max_rows=64,
                                 k_max=k_max))
    got = align.banded_edit_distance(*_torch(s1, l1, s2, l2, band),
                                     max_rows=64, k_max=k_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_banded_short_scan_matches_jax():
    """max_rows below some len2: the scan stops there in both."""
    rng = np.random.default_rng(4)
    s1, l1, s2, l2, band = kband_batch(rng, 256, 80, 64, 8)
    want = np.asarray(jax_banded(s1, l1, s2, l2, band, max_rows=40,
                                 k_max=8))
    got = align.banded_edit_distance(*_torch(s1, l1, s2, l2, band),
                                     max_rows=40, k_max=8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [5, 6])
def test_full_score_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s1, l1, s2, l2, _ = kband_batch(rng, 1024, 96, 64, 16)
    want = np.asarray(jax_full(s1, l1, s2, l2, max_rows=64))
    got = align.batch_edit_distance_score(*_torch(s1, l1, s2, l2),
                                          max_rows=64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _regime_cases(seed, B, max_rows, k_max):
    """Problems in kband_core's defined regime: n >= m, n - m <= k,
    2k + 1 < n (cf. tests/test_ops.py)."""
    rng = np.random.default_rng(seed)
    seq1 = np.zeros((B, max_rows + 16), dtype=np.int8)
    seq2 = np.zeros((B, max_rows), dtype=np.int8)
    len1 = np.zeros(B, dtype=np.int32)
    len2 = np.zeros(B, dtype=np.int32)
    band = np.zeros(B, dtype=np.int32)
    for b in range(B):
        k = int(rng.integers(1, k_max + 1))
        m = int(rng.integers(max(8, 2 * k + 2), max_rows))
        n = m + int(rng.integers(0, k + 1))
        s1 = CODES[rng.integers(0, 5, n)]
        s2 = s1[:m].copy()
        for _ in range(int(rng.integers(0, 6))):
            s2[rng.integers(0, m)] = CODES[rng.integers(0, 5)]
        seq1[b, :n], seq2[b, :m] = s1, s2
        len1[b], len2[b], band[b] = n, m, k
    return seq1, len1, seq2, len2, band


def test_banded_matches_pallas_interpret_and_native():
    from pintron_tpu.ops.pallas_align import banded_edit_distance_pallas
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    max_rows, k_max = 48, 6
    seq1, len1, seq2, len2, band = _regime_cases(9, 160, max_rows, k_max)
    got = align.banded_edit_distance(*_torch(seq1, len1, seq2, len2, band),
                                     max_rows=max_rows, k_max=k_max).numpy()
    pallas = np.asarray(banded_edit_distance_pallas(
        seq1, len1, seq2, len2, band, max_rows=max_rows, k_max=k_max,
        interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for b in range(len(got)):
        n, m, k = int(len1[b]), int(len2[b]), int(band[b])
        expect = int(lib.kband_core(seq1[b, :n].tobytes(), n,
                                    seq2[b, :m].tobytes(), m, k))
        assert int(got[b]) == expect, (b, n, m, k)


def test_full_score_matches_native():
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(10)
    s1, l1, s2, l2, _ = kband_batch(rng, 256, 64, 48, 8)
    got = align.batch_edit_distance_score(*_torch(s1, l1, s2, l2),
                                          max_rows=48).numpy()
    for b in range(len(got)):
        n, m = int(l1[b]), int(l2[b])
        a, c = s1[b, :n].tobytes(), s2[b, :m].tobytes()
        assert int(got[b]) == int(lib.edit_total(a, n, c, m)), b


def test_from_numpy_batch_dtypes_and_bytes():
    seq = np.frombuffer(b"AC\xc8", dtype=np.uint8).astype(np.int8)[None, :]
    lens = np.array([3], dtype=np.int64)
    s1, l1, s2, l2, band = align.from_numpy_batch(
        seq, lens, seq, lens, lens, device=torch.device("cpu"))
    assert s1.dtype == torch.int8 and s1.is_contiguous()
    assert l1.dtype == l2.dtype == band.dtype == torch.int32
    assert int(s1[0, 2]) == -56      # byte 200 wraps, as offload._encode
