"""The K-band kernel wrappers: dispatch by the tensors' device, input
checks, launch counts, a numpy model of ``kband_kernel``'s warp design
against the plain version and the JAX op, and (on a CUDA card, tests
marked ``cuda``) the hand-written kernels against their plain PyTorch
versions.

JAX is imported inside the one test that compares with it, so the
``cuda`` tests run on a GPU machine that has none:
python -m pytest tests/test_torch_kband.py -m cuda
"""

import numpy as np
import pytest
import torch

from pintron_tpu_torch.ops import align, kband, limits

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


BIG = align.BIG
# the kernel's instantiations (csrc/kband.cu)
CPLS = (1, 2, 4, 8, 16, 17, 33)


def _shfl_up(v, d):
    """__shfl_up_sync over the lane axis (last but one): lane l reads
    lane l - d; lanes below d keep their own value."""
    out = v.copy()
    out[..., d:] = v[..., :-d]
    return out


def warp_model(s1, len1, s2, len2, band, *, max_rows, k_max, cpl):
    """numpy model of kband_kernel, one problem a warp of 32 lanes and
    lane l holding the cpl band offsets l*cpl .. l*cpl+cpl-1, all
    problems at once: each row is lane segments of cpl cells, the `up`
    shuffle, an in-lane prefix-min, a 5-step shuffle-up scan over the
    lanes' totals and one shuffle for the exclusive prefix.  A warp
    stops at its own len2 (modelled by keeping its band)."""
    B, N = s1.shape
    MW = s2.shape[1]
    W = 2 * k_max + 1
    assert 32 * cpl >= W
    s1, s2 = s1.astype(np.int32), s2.astype(np.int32)
    n, m = len1.astype(np.int64), len2.astype(np.int64)
    k = band.astype(np.int64)[:, None, None]
    lane = np.arange(32)[:, None]
    o = lane * cpl + np.arange(cpl)[None, :]                  # (32, cpl)
    real = o < W
    c0 = o - k_max
    M = np.where(real & (c0 >= 0) & (c0 <= k), c0, BIG)     # (B, 32, cpl)
    inb = real & (np.abs(c0) <= k)
    rows = np.minimum(max_rows, m)
    bi = np.arange(B)[:, None, None]
    for r in range(1, int(rows.max(initial=0)) + 1):
        live = (r <= rows)[:, None, None]
        c = o + r - k_max
        win = s1[bi, np.clip(c - 1, 0, N - 1)]
        ch2 = s2[:, min(r - 1, MW - 1)][:, None, None]
        next0 = np.concatenate([M[:, 1:, 0], np.full((B, 1), BIG)], axis=1)
        up = np.concatenate([M[:, :, 1:], next0[:, :, None]], axis=2)
        active = inb & (c >= 1) & (c <= n[:, None, None])
        cand = np.where(active, np.minimum(M + (win != ch2), up + 1), BIG)
        cand = np.where((c == 0) & (r <= k), r, cand)
        x = np.minimum.accumulate(cand - o, axis=2)           # in-lane
        t = x[:, :, -1]
        for d in (1, 2, 4, 8, 16):                            # over lanes
            t = np.minimum(t, _shfl_up(t, d))
        before = _shfl_up(t, 1)
        before[:, 0] = BIG
        new = np.where(real, np.minimum(np.minimum(x, before[:, :, None])
                                        + o, BIG), BIG)
        M = np.where(live, new, M)
    final = np.clip(n - m + k_max, 0, W - 1)
    return M.reshape(B, 32 * cpl)[np.arange(B), final].astype(np.int32)


@pytest.mark.parametrize("W", [5, 33, 65, 129, 257, 1025])
def test_warp_model_matches_plain_and_jax(W):
    """The warp design's decomposition of a row gives the plain
    version's and the JAX op's integers on every problem, at every CPL
    that holds the band: problems with len1 - len2 == band, rows past
    len2, bands covering the matrix, masked bytes and bytes >= 128."""
    pytest.importorskip("jax")
    from pintron_tpu.ops.align import banded_edit_distance as jax_banded
    k_max = (W - 1) // 2
    m_cols = max(48, 2 * k_max)
    n_cols = m_cols + k_max + 8
    s1, l1, s2, l2, band = (t.numpy() for t in batch(
        W, 96, n_cols, m_cols, k_max, "cpu"))
    kw = dict(max_rows=m_cols, k_max=k_max)
    want = align.banded_edit_distance(*align.from_numpy_batch(
        s1, l1, s2, l2, band, device=torch.device("cpu")), **kw).numpy()
    np.testing.assert_array_equal(
        np.asarray(jax_banded(s1, l1, s2, l2, band, **kw)), want)
    assert (l1 - l2 == band).any() and (l2 < m_cols).any()
    fits = [cpl for cpl in CPLS if 32 * cpl >= W]
    assert fits
    for cpl in fits:
        np.testing.assert_array_equal(
            warp_model(s1, l1, s2, l2, band, cpl=cpl, **kw), want,
            err_msg=f"W={W} CPL={cpl}")


def test_kmax_beyond_the_kernel_raises():
    s1, l1, s2, l2, band = batch(5, 4, 16, 8, 2, "cpu")
    with pytest.raises(ValueError, match="k_max 513 > 512"):
        kband.banded_edit_distance_cuda(s1, l1, s2, l2, band, max_rows=8,
                                        k_max=kband.KMAX + 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_cpu_tensors_run_the_plain_versions():
    s1, l1, s2, l2, band = batch(1, 200, 80, 48, 8, "cpu")
    limits.reset_launches()
    got = kband.banded_edit_distance_cuda(s1, l1, s2, l2, band,
                                          max_rows=48, k_max=8)
    want = align.banded_edit_distance(s1, l1, s2, l2, band, max_rows=48,
                                      k_max=8)
    assert torch.equal(got, want)
    got = kband.batch_edit_distance_score_cuda(s1, l1, s2, l2, max_rows=48)
    want = align.batch_edit_distance_score(s1, l1, s2, l2, max_rows=48)
    assert torch.equal(got, want)
    assert not any(limits.LAUNCHES.values())


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
    before = dict(limits.LAUNCHES)
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
    assert limits.LAUNCHES["kband"] == before["kband"] + 1
    assert limits.LAUNCHES["edit_score"] == before["edit_score"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("k_max", [2, 15, 16, 31, 32, 63, 64, 127, 128, 255,
                                   256, 271, 272, 511, 512])
def test_kband_kernel_every_warp_layout_on_card(cuda_device, k_max):
    """kband_kernel at every cells-a-lane instantiation (CPL 1, 2, 4, 8,
    16, 17 and 33) and at both edges of each, equal to the plain version on
    every problem, with B not a multiple of the block's 4 warps."""
    m_cols = max(48, 2 * k_max)
    n_cols = m_cols + k_max + 8
    s1, l1, s2, l2, band = batch(k_max, 37, n_cols, m_cols, k_max,
                                 cuda_device)
    kw = dict(max_rows=m_cols, k_max=k_max)
    got = kband.banded_edit_distance_cuda(s1, l1, s2, l2, band, **kw)
    want = align.banded_edit_distance(s1, l1, s2, l2, band, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
