"""Batched alignment DPs as plain PyTorch: the four families of STEP 2.

Twins of the JAX package's ``banded_edit_distance``,
``batch_edit_distance_score``, ``batch_edit_rowmin``,
``batch_nw_traceback`` and ``batch_gap_traceback`` (``ops/align.py``):
one row-wavefront loop over the DP rows with the whole batch advancing
in lockstep, the in-row left chain closed with ``torch.cummin`` (or
``torch.cummax`` for the gap scores).  Same int32 values, same
sentinel, same band and boundary rules, same direction tie chains, same
frozen rows, so each problem's result equals the JAX op's and the host
C DP's.  The traceback ops come back as plain int8 codes, one per step
(the JAX ops' 2-bit wire packing is not kept).

These are the reference versions of the CUDA kernels in
``pintron_tpu_torch/csrc/``: the wrappers in
``pintron_tpu_torch.ops.kband`` and ``pintron_tpu_torch.ops.traceback``
run them for tensors on the CPU, and the tests and ``chip_smoke.py``
compare the kernels against them.
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


def batch_edit_rowmin(seq1, len1, seq2, len2, *,
                      max_rows: int) -> tuple:
    """Per-row minima and FIRST minimal columns of the full edit DP of
    each problem (refine.c:105-192; the JAX ``batch_edit_rowmin``):
    seq1 (B, N) the text windows (columns), seq2 (B, M) the patterns
    (rows).  Returns (vals, pos), int32 (B, max_rows + 1): row r's
    minimum over columns 0..len1 and the smallest column attaining it.
    Rows past len2 are unspecified (callers read rows 0..len2)."""
    device = seq1.device
    B, N = seq1.shape
    MW = seq2.shape[1]
    seq1 = seq1.to(torch.int32)
    seq2 = seq2.to(torch.int32)
    len1 = len1.to(torch.int32)
    cols = torch.arange(N + 1, dtype=torch.int32, device=device)
    outside = cols[None, :] > len1[:, None]
    C = N + 2   # (value, column) keys: one min gives the first argmin

    def rowmin(row):
        key = torch.where(outside, BIG, row).long() * C + cols.long()
        best = key.min(dim=1).values
        return (best // C).to(torch.int32), (best % C).to(torch.int32)

    M = cols.expand(B, N + 1).clone()
    vals = torch.empty((B, max_rows + 1), dtype=torch.int32, device=device)
    pos = torch.empty_like(vals)
    vals[:, 0], pos[:, 0] = rowmin(M)
    for r in range(1, max_rows + 1):
        ch2 = seq2[:, min(max(r - 1, 0), MW - 1)][:, None]
        cand = torch.minimum(M[:, :-1] + (seq1 != ch2).to(torch.int32),
                             M[:, 1:] + 1)
        first = torch.full((B, 1), r, dtype=torch.int32, device=device)
        cand = torch.cat([first, cand], dim=1)
        M = torch.cummin(cand - cols, dim=1).values + cols
        vals[:, r], pos[:, r] = rowmin(M)
    return vals, pos


def _wildcard(codes):
    return (codes == ord("N")) | (codes == ord("n"))


def _check_widths(est, gen, max_n: int, max_m: int) -> None:
    if est.shape[1] != max_n or gen.shape[1] != max_m:
        raise ValueError(f"widths ({est.shape[1]}, {gen.shape[1]}) != "
                         f"(max_n, max_m) = ({max_n}, {max_m})")


def batch_nw_traceback(est, elen, gen, glen, *, max_n: int,
                       max_m: int) -> tuple:
    """Batched Needleman-Wunsch with the traceback (the JAX
    ``batch_nw_traceback``; reference compute-alignments.c:39-207):
    unit costs, N/n wildcards on either side, direction ties
    diag > up > left.

    Args: est (B, max_n) / gen (B, max_m) int8 codes (padded), elen /
    glen (B,) int32 lengths (elen <= max_n, glen <= max_m).
    Returns (score, ops, nsteps): score (B,) int32, the alignment cost;
    ops (B, max_n + max_m) int8 op codes (0 = diag, 1 = up / gap in
    gen, 2 = left / gap in est) from the END of the alignment
    backwards, 3 past nsteps; nsteps (B,) int32, the steps walked
    before the walk reaches row or column 0."""
    _check_widths(est, gen, max_n, max_m)
    device = est.device
    B = est.shape[0]
    est = est.to(torch.int32)
    gen = gen.to(torch.int32)
    elen = elen.to(torch.int32)
    glen = glen.to(torch.int32)
    wild_g = _wildcard(gen)
    cols = torch.arange(max_m + 1, dtype=torch.int32, device=device)
    M = cols.expand(B, max_m + 1).clone()
    # rows past every elen are frozen: the loop stops at the longest
    rows = min(int(elen.max()), max_n) if B else 0
    dirs = torch.zeros((B, max(rows, 1), max_m), dtype=torch.int8,
                       device=device)
    for i in range(1, rows + 1):
        ce = est[:, i - 1][:, None]
        match = (gen == ce) | _wildcard(ce) | wild_g
        diag = M[:, :-1] + torch.where(match, 0, 1).to(torch.int32)
        up = M[:, 1:] + 1
        first = torch.full((B, 1), i, dtype=torch.int32, device=device)
        cand = torch.cat([first, torch.minimum(diag, up)], dim=1)
        vals = torch.cummin(cand - cols, dim=1).values + cols
        left = vals[:, :-1] + 1
        d = torch.where((up < diag) & (left >= up), 1, 0)
        d = torch.where(left < torch.minimum(diag, up), 2, d)
        dirs[:, i - 1] = d.to(torch.int8)
        M = torch.where((i <= elen)[:, None], vals, M)
    score = torch.gather(M, 1, glen[:, None].long())[:, 0]
    ops, nsteps = _walk(dirs.reshape(B, -1), elen, glen, max_m,
                        max_n + max_m, fill=3, step=_nw_step)
    return score, ops, nsteps


def _nw_step(c, sm):
    d = c
    return d, d, (d == 0) | (d == 1), (d == 0) | (d == 2), sm


_JUMP = 5


def _gap_step(c, sm):
    rdc = (c >> 3) & 3
    d2 = torch.where(rdc == 3, _JUMP, rdc)
    d1 = torch.where((c & 4) != 0, 2, _JUMP)
    d = torch.where(sm == 2, d2, torch.where(sm == 1, d1, c & 3))
    op = torch.where(d == _JUMP, 3, d)
    return (d, op, (d == 0) | (d == 1), (d == 0) | (d == 2) | (d == _JUMP),
            sm - (d == _JUMP).long())


def _walk(flat, elen, glen, max_m: int, width: int, *, fill: int, step,
          sm=None):
    """The traceback walk, one step per iteration for the whole batch:
    from (elen, glen) while both are positive, reading the direction
    byte of cell (i, j) at flat[(i-1) * max_m + (j-1)].  Returns the op
    codes (``fill`` past nsteps) and nsteps."""
    device = flat.device
    B = flat.shape[0]
    i = elen.long()
    j = glen.long()
    sm = torch.zeros(B, dtype=torch.long, device=device) if sm is None \
        else sm.long()
    k = torch.zeros(B, dtype=torch.int32, device=device)
    ops = torch.full((B, width), fill, dtype=torch.int8, device=device)
    steps = int((i + j).max()) if B else 0
    for t in range(min(steps, width)):
        active = (i > 0) & (j > 0)
        fidx = ((i - 1) * max_m + (j - 1)).clamp(0, flat.shape[1] - 1)
        c = torch.gather(flat, 1, fidx[:, None])[:, 0].long()
        _d, op, di, dj, sm2 = step(c, sm)
        ops[:, t] = torch.where(active, op, fill).to(torch.int8)
        i = i - (di & active).long()
        j = j - (dj & active).long()
        sm = torch.where(active, sm2, sm)
        k += active.to(torch.int32)
    return ops, k


def batch_gap_traceback(est, elen, gen, glen, *, max_n: int,
                        max_m: int) -> tuple:
    """Batched 3-matrix L/G/R gap alignment with the traceback (the JAX
    ``batch_gap_traceback``; reference compute_gap_alignment,
    refine-intron.c:560-806): match +1, mismatch -1 with N/n wildcards,
    gap -1 in L and R, a free genomic gap in G, free horizontal moves on
    R's last row.  Same per-row formulation (raw diag/up candidates,
    left relaxation by cummax, G a prefix max of the relaxed L row),
    same direction tie chains, same start matrix (R >= G >= L on ties).

    Args as ``batch_nw_traceback``.  Returns (sm, ops, nsteps): sm (B,)
    int32, the start matrix (0 = L, 1 = G, 2 = R); ops (B, max_n +
    max_m) int8 op codes (0 = diag, 1 = up, 2 = left, 3 = left with a
    matrix jump, R -> G or G -> L) from the END backwards, 0 past
    nsteps; nsteps (B,) int32."""
    _check_widths(est, gen, max_n, max_m)
    device = est.device
    B = est.shape[0]
    est = est.to(torch.int32)
    gen = gen.to(torch.int32)
    elen = elen.to(torch.int32)
    glen = glen.to(torch.int32)
    wild_g = _wildcard(gen)
    cols = torch.arange(max_m + 1, dtype=torch.int32, device=device)
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=device)
    L = torch.zeros((B, max_m + 1), dtype=torch.int32, device=device)
    R = torch.zeros_like(L)
    rows = min(int(elen.max()), max_n) if B else 0
    dirs = torch.zeros((B, max(rows, 1), max_m), dtype=torch.int8,
                       device=device)
    for r in range(1, rows + 1):
        ce = est[:, r - 1][:, None]
        match = (gen == ce) | _wildcard(ce) | wild_g
        ms = torch.where(match, 1, -1).to(torch.int32)
        cost = torch.where(r == elen, 0, 1).to(torch.int32)[:, None]
        # L: raw diag/up, then the slope-1 left relaxation
        diagL = L[:, :-1] + ms
        upL = L[:, 1:] - 1
        Lb = torch.cat([zcol, torch.maximum(diagL, upL)], dim=1)
        Lrel = torch.cummax(Lb + cols, dim=1).values - cols
        # G: prefix max of the relaxed L row, shifted by one column
        Grow = torch.cat([zcol, torch.cummax(Lrel, dim=1).values[:, :-1]],
                         dim=1)
        # R: raw diag/up/grow, then the slope-`cost` left relaxation
        diagR = R[:, :-1] + ms
        upR = R[:, 1:] - 1
        Rb = torch.cat([zcol, torch.maximum(torch.maximum(diagR, upR),
                                            Grow[:, :-1])], dim=1)
        ccols = cost * cols
        Rrel = torch.cummax(Rb + ccols, dim=1).values - ccols
        # direction byte: bits 0-1 L, bit 2 G keep(1)/take-L(0),
        # bits 3-4 R (3 = the jump to G)
        lv = Lrel[:, 1:]
        ld = torch.where(lv == diagL, 0, torch.where(lv == upL, 1, 2))
        gd = torch.where(Grow[:, :-1] < Lrel[:, :-1], 0, 1)
        rv = Rrel[:, 1:]
        rd = torch.where(
            rv == diagR, 0,
            torch.where(rv == Rrel[:, :-1] - cost, 2,
                        torch.where(rv == Grow[:, :-1], 3, 1)))
        dirs[:, r - 1] = (ld | (gd << 2) | (rd << 3)).to(torch.int8)
        keep = (r <= elen)[:, None]
        L = torch.where(keep, Lrel, L)
        R = torch.where(keep, Rrel, R)
    # finals at (n, m): G from the frozen final L row
    Gfin = torch.cat([zcol, torch.cummax(L, dim=1).values[:, :-1]], dim=1)
    at = glen[:, None].long()
    Lf = torch.gather(L, 1, at)[:, 0]
    Gf = torch.gather(Gfin, 1, at)[:, 0]
    Rf = torch.gather(R, 1, at)[:, 0]
    sm = torch.where(Rf >= Gf, torch.where(Rf >= Lf, 2, 0),
                     torch.where(Gf >= Lf, 1, 0)).to(torch.int32)
    ops, nsteps = _walk(dirs.reshape(B, -1), elen, glen, max_m,
                        max_n + max_m, fill=0, step=_gap_step, sm=sm)
    return sm, ops, nsteps


def nw_traceback_decode(est_seq: str, gen_seq: str, ops, nsteps: int):
    """Host decode of one ``batch_nw_traceback`` row into the two gapped
    strings (the JAX package's ``nw_traceback_decode``; the native
    ``epm_fill_endpoints`` decodes the same way)."""
    i, j = len(est_seq), len(gen_seq)
    est_al, gen_al = [], []
    for d in ops[:int(nsteps)]:
        d = int(d)
        est_al.append(est_seq[i - 1] if d != 2 else "-")
        gen_al.append(gen_seq[j - 1] if d != 1 else "-")
        i -= d != 2
        j -= d != 1
    est_al += [est_seq[k] for k in range(i - 1, -1, -1)] + ["-"] * j
    gen_al += ["-"] * i + [gen_seq[k] for k in range(j - 1, -1, -1)]
    return "".join(reversed(est_al)), "".join(reversed(gen_al))


def gap_traceback_decode(est_seq: str, gen_seq: str, sm0: int, ops,
                         nsteps: int):
    """Host decode of one ``batch_gap_traceback`` row, as the native
    lookaside decoder (``ri_decode_ops``) replays gap_align_run's walk.
    Returns (est_al, gen_al, factor_cut, intron_start, intron_end,
    intron_start_on_align, intron_end_on_align)."""
    i, j, sm = len(est_seq), len(gen_seq), int(sm0)
    w = i + j
    est_al, gen_al = [""] * w, [""] * w
    jump_w = []
    factor_cut = intron_start = intron_end = 0
    for d in ops[:int(nsteps)]:
        d = int(d)
        w -= 1
        if d == 3:  # a left move that jumps from R to G or from G to L
            if sm == 2:
                intron_end, factor_cut = j - 1, i
            else:
                intron_start = j - 1
            sm -= 1
            if len(jump_w) < 2:
                jump_w.append(w)
        est_al[w] = est_seq[i - 1] if d in (0, 1) else "-"
        gen_al[w] = gen_seq[j - 1] if d != 1 else "-"
        i -= d in (0, 1)
        j -= d != 1
    while i > 0:
        w -= 1
        est_al[w], gen_al[w] = est_seq[i - 1], "-"
        i -= 1
    while j > 0:
        w -= 1
        est_al[w], gen_al[w] = "-", gen_seq[j - 1]
        j -= 1
    on_align = [p - w for p in jump_w] + [0, 0]
    start_al, end_al = ((on_align[1], on_align[0]) if int(sm0) == 2
                        else (on_align[0], 0) if int(sm0) == 1 else (0, 0))
    return ("".join(est_al[w:]), "".join(gen_al[w:]), factor_cut,
            intron_start, intron_end, start_al, end_al)
