"""Batched alignment DPs as plain PyTorch: the K-band family.

Twins of the JAX package's ``banded_edit_distance`` and
``batch_edit_distance_score`` (``ops/align.py``): one row-wavefront loop
over the DP rows with the whole batch advancing in lockstep, the in-row
left chain closed with ``torch.cummin``.  Same int32 values, same
sentinel, same band and boundary rules, same frozen rows past ``len2``,
so each problem's result equals the JAX op's and the host C
``kband_core``'s.

These are the reference versions of the CUDA kernels in
``pintron_tpu_torch/csrc/kband.cu``: the wrappers in
``pintron_tpu_torch.ops.kband`` run them for tensors on the CPU, and
the tests and ``chip_smoke.py`` compare the kernels against them.
"""

from __future__ import annotations

import numpy as np
import torch

# safe sentinel: > any real distance, no overflow in int32
BIG = 1 << 20


def from_numpy_batch(seq1, len1, seq2, len2, band=None, *,
                     device: torch.device):
    """Move an encoded numpy batch (``offload._encode``: int8 codes,
    int32 lengths) onto ``device`` as contiguous torch tensors, in the
    dtypes the kernels take.  Returns (seq1, len1, seq2, len2) or, with
    ``band``, (seq1, len1, seq2, len2, band)."""
    arrays = [np.ascontiguousarray(seq1, dtype=np.int8),
              np.ascontiguousarray(len1, dtype=np.int32),
              np.ascontiguousarray(seq2, dtype=np.int8),
              np.ascontiguousarray(len2, dtype=np.int32)]
    if band is not None:
        arrays.append(np.ascontiguousarray(band, dtype=np.int32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def banded_edit_distance(seq1, len1, seq2, len2, band, *, max_rows: int,
                         k_max: int) -> torch.Tensor:
    """Batched banded (K-band) edit distance.

    Args:
      seq1: (B, N) integer codes of the LONGER sequences (padded).
      len1: (B,) actual lengths n.
      seq2: (B, M) codes of the shorter sequences.
      len2: (B,) actual lengths m (m <= n).
      band: (B,) per-problem band half-width k (k <= k_max).
      max_rows: row count to scan (>= max(len2)).
      k_max: band half-width bound; the band vector is 2*k_max+1 wide.

    Returns:
      (B,) int32 final band cells M[m][n] (the banded distance).
    """
    device = seq1.device
    B, N = seq1.shape
    MW = seq2.shape[1]
    W = 2 * k_max + 1
    offs = torch.arange(W, dtype=torch.int32, device=device)  # o = c-r+k

    seq1 = seq1.to(torch.int32)
    seq2 = seq2.to(torch.int32)
    len1 = len1.to(torch.int32)
    len2 = len2.to(torch.int32)
    band = band.to(torch.int32)[:, None]

    # row 0: M[o] = c for 0 <= c <= k, BIG outside the band
    c0 = (offs - k_max)[None, :]
    M = torch.where((c0 >= 0) & (c0 <= band), c0,
                    torch.tensor(BIG, dtype=torch.int32, device=device))
    in_band = (offs - k_max).abs()[None, :] <= band
    big_col = torch.full((B, 1), BIG, dtype=torch.int32, device=device)

    for r in range(1, max_rows + 1):
        c = offs[None, :] + (r - k_max)                       # (1, W)
        live = (r <= len2)[:, None]                           # (B, 1)
        active = in_band & (c >= 1) & (c <= len1[:, None]) & live

        ch1 = torch.gather(seq1, 1,
                           (c - 1).clamp(0, N - 1).expand(B, W).long())
        ch2 = seq2[:, min(max(r - 1, 0), MW - 1)][:, None]
        mism = (ch1 != ch2).to(torch.int32)

        diag = M + mism
        up = torch.cat([M[:, 1:], big_col], dim=1) + 1
        cand = torch.minimum(diag, up)
        # boundary cell c == 0 is forced to r while r <= k
        is_boundary = (c == 0) & (r <= band)
        cand = torch.where(is_boundary, r, cand)
        cand = torch.where(active | is_boundary, cand, BIG)
        # left chain: M2[o] = min_{j<=o} cand[j] + (o - j)
        shifted = torch.cummin(cand - offs, dim=1).values
        M2 = torch.clamp(shifted + offs, max=BIG)
        # rows past len2 keep the previous band (final answer frozen)
        M = torch.where(live, M2, M)

    final_off = (len1 - len2 + k_max).clamp(0, W - 1)
    return torch.gather(M, 1, final_off[:, None].long())[:, 0]


def batch_edit_distance_score(seq1, len1, seq2, len2, *,
                              max_rows: int) -> torch.Tensor:
    """Batched full (unbanded) unit-cost edit distance, final cell only:
    M[len2][len1] of the edit DP of each problem (the reference
    edit_distance, src/refine.c:50-83).  (B,) int32."""
    device = seq1.device
    B, N = seq1.shape
    MW = seq2.shape[1]
    seq1 = seq1.to(torch.int32)
    seq2 = seq2.to(torch.int32)
    len1 = len1.to(torch.int32)
    len2 = len2.to(torch.int32)
    cols = torch.arange(N + 1, dtype=torch.int32, device=device)
    M = cols.expand(B, N + 1).clone()

    for r in range(1, max_rows + 1):
        ch2 = seq2[:, min(max(r - 1, 0), MW - 1)][:, None]
        mism = (seq1 != ch2).to(torch.int32)
        cand = torch.minimum(M[:, :-1] + mism, M[:, 1:] + 1)
        first = torch.full((B, 1), r, dtype=torch.int32, device=device)
        cand = torch.cat([first, cand], dim=1)
        row = torch.cummin(cand - cols, dim=1).values + cols
        M = torch.where((r <= len2)[:, None], row, M)

    return torch.gather(M, 1, len1[:, None].long())[:, 0]
