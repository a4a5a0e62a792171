"""The K-band kernel wrappers: dispatch by the tensors' device, input
checks, launch counts, and (on a CUDA card, tests marked ``cuda``) the
hand-written kernels against their plain PyTorch versions.

This file imports no JAX, so its ``cuda`` tests run on a GPU machine
that has none:  python -m pytest tests/test_torch_kband.py -m cuda
"""

import numpy as np
import pytest
import torch

from pintron_tpu_torch.ops import align, kband

CODES = np.concatenate([np.frombuffer(b"ACGTN*#n", dtype=np.int8),
                        np.array([-56, -1], dtype=np.int8)])


def batch(seed, B, n_cols, m_cols, k_max, device):
    """Seeded problems with len1 - len2 == band, rows past len2, bands
    covering the matrix, masked bytes and bytes >= 128."""
    rng = np.random.default_rng(seed)
    s1 = CODES[rng.integers(0, len(CODES), (B, n_cols))]
    s2 = np.zeros((B, m_cols), dtype=np.int8)
    len1 = np.zeros(B, dtype=np.int32)
    len2 = np.zeros(B, dtype=np.int32)
    band = rng.integers(1, k_max + 1, B).astype(np.int32)
    for b in range(B):
        k = int(band[b])
        m = (int(rng.integers(1, max(2, 2 * k))) if b % 3 == 2
             else int(rng.integers(1, m_cols + 1)))
        n = min(m + (k if b % 3 == 0 else int(rng.integers(0, k + 1))),
                n_cols)
        m = min(m, n)
        s2[b, :m] = s1[b, :m]
        for _ in range(int(rng.integers(0, 1 + m // 6))):
            s2[b, rng.integers(0, m)] = CODES[rng.integers(0, len(CODES))]
        len1[b], len2[b] = n, m
    return align.from_numpy_batch(s1, len1, s2, len2, band,
                                  device=torch.device(device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_cpu_tensors_run_the_plain_versions():
    s1, l1, s2, l2, band = batch(1, 200, 80, 48, 8, "cpu")
    kband.reset_launches()
    got = kband.banded_edit_distance_cuda(s1, l1, s2, l2, band,
                                          max_rows=48, k_max=8)
    want = align.banded_edit_distance(s1, l1, s2, l2, band, max_rows=48,
                                      k_max=8)
    assert torch.equal(got, want)
    got = kband.batch_edit_distance_score_cuda(s1, l1, s2, l2, max_rows=48)
    want = align.batch_edit_distance_score(s1, l1, s2, l2, max_rows=48)
    assert torch.equal(got, want)
    assert not any(kband.LAUNCHES.values())


def test_non_cpu_tensors_never_run_the_plain_versions(monkeypatch):
    """A tensor off the CPU goes to a kernel or the call raises."""
    def plain(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    monkeypatch.setattr(align, "banded_edit_distance", plain)
    monkeypatch.setattr(align, "batch_edit_distance_score", plain)
    s1, l1, s2, l2, band = (t.to("meta")
                            for t in batch(2, 8, 16, 8, 2, "cpu"))
    with pytest.raises(ValueError, match="no K-band kernel"):
        kband.banded_edit_distance_cuda(s1, l1, s2, l2, band, max_rows=8,
                                        k_max=2)
    with pytest.raises(ValueError, match="no K-band kernel"):
        kband.batch_edit_distance_score_cuda(s1, l1, s2, l2, max_rows=8)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "batch"])
def test_wrapper_rejects_malformed_batches(bad):
    s1, l1, s2, l2, band = batch(3, 8, 16, 8, 2, "cpu")
    if bad == "dtype":
        s1 = s1.to(torch.int32)
    elif bad == "shape":
        l1 = l1[:, None]
    elif bad == "contiguous":
        s2 = torch.cat([s2, s2], dim=1)[:, ::2]
    else:
        band = band[:-1]
    with pytest.raises(ValueError):
        kband.banded_edit_distance_cuda(s1, l1, s2, l2, band, max_rows=8,
                                        k_max=2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_cols,m_cols,k_max", [
    (77, 96, 64, 8), (300, 1024, 256, 16), (129, 4096, 1024, 64)])
def test_kernels_match_plain_on_card(cuda_device, B, n_cols, m_cols, k_max):
    s1, l1, s2, l2, band = batch(B, B, n_cols, m_cols, k_max, cuda_device)
    before = dict(kband.LAUNCHES)
    got = kband.banded_edit_distance_cuda(s1, l1, s2, l2, band,
                                          max_rows=m_cols, k_max=k_max)
    want = align.banded_edit_distance(s1, l1, s2, l2, band,
                                      max_rows=m_cols, k_max=k_max)
    assert torch.equal(got, want)
    got = kband.batch_edit_distance_score_cuda(s1, l1, s2, l2,
                                               max_rows=m_cols)
    want = align.batch_edit_distance_score(s1, l1, s2, l2, max_rows=m_cols)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kband.LAUNCHES["kband"] == before["kband"] + 1
    assert kband.LAUNCHES["edit_score"] == before["edit_score"] + 1
