"""The NW, gap and refine-borders ops of the port: the plain PyTorch
versions against the JAX package's XLA ops and the host C DPs
(``nw_align_run``, ``gap_align_run``, ``edit_matrix``), numpy models of
the kernels' warp layouts (the edit-row sweep that rowmin_kernel and
edit_score_kernel share among them), the kernel wrappers' dispatch and
input checks, and (on a CUDA card, tests marked ``cuda``) the
hand-written kernels against their plain versions.  Every comparison is
exact.

The JAX comparisons import JAX inside the test, so this file's ``cuda``
tests run on a GPU machine that has none:
    python -m pytest tests/test_torch_traceback.py -m cuda
"""

import numpy as np
import pytest
import torch

from pintron_tpu.factorize.alignments import (_compute_alignment_uncached,
                                              edit_distance_full)
from pintron_tpu.factorize.gap_align import _compute_gap_alignment_uncached
from pintron_tpu.native import get_lib
from pintron_tpu_torch.ops import align, kband, limits, offload, traceback

ACGT = np.array(list("ACGT"))
WILD = np.array(list("ACGTNn"))


def _mutate(rng, s, k):
    s = list(s)
    for _ in range(k):
        if s:
            s[int(rng.integers(0, len(s)))] = str(rng.choice(ACGT))
    return "".join(s)


def nw_cases(seed, count=60):
    """(est, gen) pairs: mutated and truncated copies, unrelated pairs,
    N/n wildcards on either side, e == g, single characters and empty
    windows."""
    rng = np.random.default_rng(seed)
    cases = [("ACGT", "ACGT"), ("A", "TTTT"), ("A", "A"), ("T", "G"),
             ("NNNN", "ACGT"), ("", "ACG"), ("ACG", ""), ("", "")]
    for _ in range(count):
        src = WILD if rng.integers(0, 3) == 0 else ACGT
        e = "".join(rng.choice(src, int(rng.integers(1, 90))))
        if rng.integers(0, 2):
            g = _mutate(rng, e, int(rng.integers(0, 8)))
            g = g[: max(1, len(e) - int(rng.integers(0, 5)))]
        else:
            g = "".join(rng.choice(src, int(rng.integers(1, 90))))
        cases.append((e, g))
    return cases


def gap_cases(seed, count=60):
    """(est, gen) pairs, half of them realistic: gen is est with an
    intron inserted, then mutated."""
    rng = np.random.default_rng(seed)
    cases = [("A", "A"), ("ACGT", "A"), ("A", "TTTTTTTT"), ("N", "ACGTA"),
             ("", "ACG"), ("ACG", "")]
    for _ in range(count):
        src = WILD if rng.integers(0, 4) == 0 else ACGT
        e = "".join(rng.choice(src, int(rng.integers(1, 100))))
        if rng.integers(0, 2):
            cut = int(rng.integers(0, len(e) + 1))
            intron = "".join(rng.choice(ACGT, int(rng.integers(0, 140))))
            g = _mutate(rng, e[:cut] + intron + e[cut:],
                        int(rng.integers(0, 6))) or "A"
        else:
            g = "".join(rng.choice(src, int(rng.integers(1, 240))))
        cases.append((e, g))
    return cases


def encode(pairs, pad=0, wrap=False):
    """Pad (a, b) string pairs into int8 batches, ``pad`` extra columns
    on each side; with ``wrap``, padding bytes are 'N' (never read)."""
    N = max(max(len(a) for a, _ in pairs), 1) + pad
    M = max(max(len(b) for _, b in pairs), 1) + pad
    fill = ord("N") if wrap else 0
    s1 = np.full((len(pairs), N), fill, dtype=np.int8)
    s2 = np.full((len(pairs), M), fill, dtype=np.int8)
    l1 = np.zeros(len(pairs), dtype=np.int32)
    l2 = np.zeros(len(pairs), dtype=np.int32)
    for i, (a, b) in enumerate(pairs):
        s1[i, :len(a)] = np.frombuffer(a.encode(), dtype=np.uint8)
        s2[i, :len(b)] = np.frombuffer(b.encode(), dtype=np.uint8)
        l1[i], l2[i] = len(a), len(b)
    return s1, l1, s2, l2


def _torch(*arrays, device="cpu"):
    return align.from_numpy_batch(*arrays, device=torch.device(device))


def _need_native():
    if get_lib() is None:
        pytest.skip("native library unavailable")


# ---- plain versions against the JAX ops -----------------------------------

@pytest.mark.parametrize("seed,pad", [(23, 0), (24, 7)])
def test_nw_plain_matches_jax(seed, pad):
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    s1, l1, s2, l2 = encode(nw_cases(seed), pad=pad)
    N, M = s1.shape[1], s2.shape[1]
    score_j, fused = jalign.batch_nw_traceback(s1, l1, s2, l2, max_n=N,
                                               max_m=M)
    ops_j, n_j = jalign.decode_nw_fused(fused, N + M)
    score, ops, nsteps = align.batch_nw_traceback(
        *_torch(s1, l1, s2, l2), max_n=N, max_m=M)
    assert score.dtype == nsteps.dtype == torch.int32
    assert ops.dtype == torch.int8 and ops.shape == (len(l1), N + M)
    np.testing.assert_array_equal(score.numpy(), np.asarray(score_j))
    np.testing.assert_array_equal(nsteps.numpy(), n_j)
    for b in range(len(l1)):
        np.testing.assert_array_equal(ops.numpy()[b, :n_j[b]],
                                      ops_j[b, :n_j[b]])


@pytest.mark.parametrize("seed,pad", [(31, 0), (32, 5)])
def test_gap_plain_matches_jax(seed, pad):
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    s1, l1, s2, l2 = encode(gap_cases(seed), pad=pad)
    N, M = s1.shape[1], s2.shape[1]
    sm_j, ops_j, n_j = jalign.decode_gap_fused(
        jalign.batch_gap_traceback(s1, l1, s2, l2, max_n=N, max_m=M), N + M)
    sm, ops, nsteps = align.batch_gap_traceback(
        *_torch(s1, l1, s2, l2), max_n=N, max_m=M)
    np.testing.assert_array_equal(sm.numpy(), sm_j)
    np.testing.assert_array_equal(nsteps.numpy(), n_j)
    for b in range(len(l1)):
        np.testing.assert_array_equal(ops.numpy()[b, :n_j[b]],
                                      ops_j[b, :n_j[b]])


@pytest.mark.parametrize("seed,pad", [(41, 0), (42, 9)])
def test_rowmin_plain_matches_jax(seed, pad):
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    # (text, pattern): refine-borders windows and their patterns
    pairs = [(g, e) for e, g in gap_cases(seed)]
    s1, l1, s2, l2 = encode(pairs, pad=pad)
    R = s2.shape[1]
    fused = np.asarray(jalign.batch_edit_rowmin(s1, l1, s2, l2,
                                                max_rows=R)).astype(np.int64)
    vals, pos = align.batch_edit_rowmin(*_torch(s1, l1, s2, l2),
                                        max_rows=R)
    assert vals.shape == pos.shape == (len(l1), R + 1)
    for b in range(len(l1)):
        rows = int(l2[b]) + 1
        np.testing.assert_array_equal(vals.numpy()[b, :rows],
                                      fused[b, :rows])
        np.testing.assert_array_equal(pos.numpy()[b, :rows],
                                      fused[b, R + 1:R + 1 + rows])


# ---- plain versions against the host C DPs ---------------------------------

@pytest.mark.parametrize("seed", [23, 25])
def test_nw_plain_matches_host(seed):
    _need_native()
    cases = [c for c in nw_cases(seed) if c[0] and c[1]]
    s1, l1, s2, l2 = encode(cases, wrap=True)
    score, ops, nsteps = align.batch_nw_traceback(
        *_torch(s1, l1, s2, l2), max_n=s1.shape[1], max_m=s2.shape[1])
    for b, (e, g) in enumerate(cases):
        ref = _compute_alignment_uncached(e, g)
        assert int(score[b]) == ref.score, (b, e, g)
        assert align.nw_traceback_decode(e, g, ops[b], nsteps[b]) == \
            (ref.est, ref.gen), (b, e, g)


@pytest.mark.parametrize("seed", [31, 33])
def test_gap_plain_matches_host(seed):
    _need_native()
    cases = [c for c in gap_cases(seed) if c[0] and c[1]]
    s1, l1, s2, l2 = encode(cases, wrap=True)
    sm, ops, nsteps = align.batch_gap_traceback(
        *_torch(s1, l1, s2, l2), max_n=s1.shape[1], max_m=s2.shape[1])
    for b, (e, g) in enumerate(cases):
        ref = _compute_gap_alignment_uncached(e, g)
        assert align.gap_traceback_decode(e, g, sm[b], ops[b],
                                          nsteps[b]) == (
            ref.est, ref.gen, ref.factor_cut, ref.intron_start,
            ref.intron_end, ref.intron_start_on_align,
            ref.intron_end_on_align), (b, e, g)


def test_rowmin_plain_matches_host():
    _need_native()
    pairs = [(g, e) for e, g in gap_cases(43)]
    s1, l1, s2, l2 = encode(pairs, wrap=True)
    vals, pos = align.batch_edit_rowmin(*_torch(s1, l1, s2, l2),
                                        max_rows=s2.shape[1])
    for b, (t, p) in enumerate(pairs):
        M = edit_distance_full(t, p)           # (len(p)+1, len(t)+1)
        np.testing.assert_array_equal(vals.numpy()[b, :len(p) + 1],
                                      M.min(axis=1))
        np.testing.assert_array_equal(pos.numpy()[b, :len(p) + 1],
                                      M.argmin(axis=1))


# ---- a numpy model of nw_kernel's warp design -----------------------------

def _wild(c):
    return (c == ord("N")) | (c == ord("n"))


def _shfl_up1(v):
    """__shfl_up_sync by one over the lane axis (axis 1)."""
    out = v.copy()
    out[:, 1:] = v[:, :-1]
    return out


def nw_warp_model(est, elen, gen, glen, *, max_n, max_m, R=16, strips=3):
    """numpy model of nw_kernel, all problems at once, one warp of 32
    lanes each: passes of 32 * R est rows, lane l holding rows
    l*R+1 .. l*R+R of a pass; step s of a pass computes column s - l + 1
    on lane l from its own previous column, lane l-1's last row and gen
    character of one step earlier (lane 0: the gen window and the row
    buffer), with the in-lane running minimum of the candidates - r; the
    R direction codes of a lane's column packed 2 bits a row into one
    word at (strip, column); lane 31 keeping the pass's last row; then
    the walk through tiles of ``strips`` strips x 32 columns.  Returns
    (score, ops, nsteps) as the kernel's wrapper does."""
    B = len(elen)
    est, gen = est.astype(np.int64), gen.astype(np.int64)
    n = np.clip(elen.astype(np.int64), 0, max_n)
    m = np.clip(glen.astype(np.int64), 0, max_m)
    P = 32 * R
    lane = np.arange(32)
    D = np.zeros((B, -(-max_n // R), max_m), dtype=np.int64)
    top = np.zeros((B, max_m + 1), dtype=np.int64)
    col = np.zeros((B, 32, R), dtype=np.int64)
    bi = np.arange(B)[:, None, None]
    for p0 in range(0, int(n.max(initial=0)), P):
        inpass = (m > 0) & (p0 < n)
        lact = np.minimum(32, (n - p0 + R - 1) // R)
        keep = p0 + P < n
        rows = p0 + lane[:, None] * R + np.arange(R)[None, :] + 1  # (32, R)
        ec = np.where(rows[None] <= n[:, None, None],
                      est[bi, np.clip(rows - 1, 0, max_n - 1)[None]], 0)
        ew = _wild(ec)
        col = np.where(inpass[:, None, None], rows[None], col)
        diag_top = np.broadcast_to(rows[:, 0] - 1, (B, 32)).copy()
        bottom = np.zeros((B, 32), dtype=np.int64)
        gch = np.zeros((B, 32), dtype=np.int64)
        steps = np.where(inpass, m + lact - 1, 0)
        for s in range(int(steps.max(initial=0))):
            j0 = s + 1                      # lane 0's column
            g0 = np.where(j0 <= m, gen[:, min(j0, max_m) - 1], 0)
            t0 = np.where(j0 <= m, j0 if p0 == 0
                          else top[:, min(j0, max_m)], 0)
            up_in = _shfl_up1(bottom)
            up_in[:, 0] = t0
            gch = _shfl_up1(gch)
            gch[:, 0] = g0
            j = s - lane + 1
            act = ((lane[None] < lact[:, None]) & (j[None] >= 1)
                   & (j[None] <= m[:, None]) & inpass[:, None])
            wg = _wild(gch)
            prev, vprev, y = diag_top, up_in, up_in + 1
            word = np.zeros((B, 32), dtype=np.int64)
            new = col.copy()
            for r in range(R):
                L = col[:, :, r]
                match = (gch == ec[:, :, r]) | wg | ew[:, :, r]
                diag = prev + ~match
                left = L + 1
                y = np.minimum(y, np.minimum(diag, left) - r)
                v = y + r
                up = vprev + 1
                d = np.where(left < np.minimum(diag, up), 2,
                             np.where(up < diag, 1, 0))
                word |= d << (2 * r)
                prev, vprev = L, v
                new[:, :, r] = v
            col = np.where(act[:, :, None], new, col)
            bottom = np.where(act, col[:, :, R - 1], bottom)
            diag_top = np.where(act, up_in, diag_top)
            bb, ll = np.nonzero(act)
            D[bb, p0 // R + ll, j[ll] - 1] = word[bb, ll]
            wr = act[:, 31] & keep
            top[wr, j[31]] = bottom[wr, 31]
    score = np.where(n == 0, m, n)
    T = max_n + max_m
    ops = np.full((B, T), 3, dtype=np.int8)
    nsteps = np.zeros(B, dtype=np.int32)
    for b in range(B):
        if n[b] and m[b]:
            last = (n[b] - 1) // P * P
            score[b] = col[b, (n[b] - 1 - last) // R, (n[b] - 1) % R]
        i, j, s = int(n[b]), int(m[b]), 0
        while i > 0 and j > 0:
            st = (i - 1) // R
            tile = np.zeros((strips, 32), dtype=np.int64)
            for q in range(strips):
                for ln in range(32):
                    if st - q >= 0 and j - ln >= 1:
                        tile[q, ln] = D[b, st - q, j - ln - 1]
            i_lo, j_lo, j0 = max((st - strips + 1) * R, 0), max(j - 32, 0), j
            while i > i_lo and j > j_lo:
                d = (tile[st - (i - 1) // R, j0 - j]
                     >> (2 * ((i - 1) % R))) & 3
                ops[b, s] = d
                s += 1
                i -= d != 2
                j -= d != 1
        nsteps[b] = s
    return score.astype(np.int32), ops, nsteps


def nw_model_cases(seed, long_len):
    """nw_cases plus the model's edges: ests longer than a pass of 32
    lanes' strips (``long_len``), e == g, an all-wildcard est, one row
    and one column, and both sides empty."""
    rng = np.random.default_rng(seed)
    e = "".join(rng.choice(ACGT, long_len))
    g = _mutate(rng, e, long_len // 20)[: long_len - 7]
    wild = "".join(rng.choice(WILD, long_len // 2))
    return nw_cases(seed, count=24) + [
        (e, e), (e, g), (g, e + "ACGT"), (e, "A"), ("C", e), (wild, g),
        ("N" * 40, "ACGTACGT"), ("G", "G"), ("", e), (e, "")]


@pytest.mark.parametrize("R,long_len", [(16, 700), (2, 150)])
def test_nw_warp_model_matches_plain_and_jax(R, long_len):
    """The warp design's decomposition (lanes x row strips x skewed
    column sweep, passes through the row buffer, 2-bit words, the tiled
    walk) gives the plain version's and the JAX op's score, ops and
    step counts on every problem; R = 16 is the kernel's, R = 2 runs
    many passes on short ests."""
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    s1, l1, s2, l2 = encode(nw_model_cases(70 + R, long_len), pad=3)
    N, M = s1.shape[1], s2.shape[1]
    assert l1.max() > 32 * R and (l1 == 0).any() and (l2 == 0).any()
    score, ops, nsteps = (t.numpy() for t in align.batch_nw_traceback(
        *_torch(s1, l1, s2, l2), max_n=N, max_m=M))
    score_j, fused = jalign.batch_nw_traceback(s1, l1, s2, l2, max_n=N,
                                               max_m=M)
    ops_j, n_j = jalign.decode_nw_fused(fused, N + M)
    np.testing.assert_array_equal(score, np.asarray(score_j))
    np.testing.assert_array_equal(nsteps, n_j)
    got = nw_warp_model(s1, l1, s2, l2, max_n=N, max_m=M, R=R)
    np.testing.assert_array_equal(got[0], score)
    np.testing.assert_array_equal(got[1], ops)
    np.testing.assert_array_equal(got[2], nsteps)
    for b in range(len(l1)):
        np.testing.assert_array_equal(got[1][b, :n_j[b]], ops_j[b, :n_j[b]])


def test_nw_scratch_is_at_most_the_offloads_cap():
    """nw_kernel's scratch (the 2-bit words and the row buffer) is what
    the offload's sub-batching counts a problem against the launch
    budget (offload.scratch_bytes) for every bucket it forms, and stays
    within N * M bytes, a byte a cell."""
    for N in (16, 64, 256, 1024, 4096, 16384):
        for M in (16, 64, 256, 1024, 4096, 16384):
            nbytes = sum(t.numel() * t.element_size()
                         for t in traceback.nw_scratch(1, N, M, "meta"))
            assert nbytes == offload.scratch_bytes("nw", N, M), (N, M)
            assert nbytes <= N * M, (N, M)


# ---- a numpy model of gap_kernel's warp design -----------------------------

def gap_warp_model(est, elen, gen, glen, *, max_n, max_m, R):
    """numpy model of gap_kernel, all problems at once, one warp of 32
    lanes each: passes of 32 * R est rows, lane l holding rows
    l*R+1 .. l*R+R of a pass; step s of a pass computes column s - l + 1
    on lane l from its own L, G and R at the previous column, lane l-1's
    last L and R rows and gen character of one step earlier (lane 0: the
    gen window and the row buffer), L's and R's left chains and G's
    running maximum in the lane, each value offset as the kernel keeps
    it (L + i + j, G + i + j + 1, R + i + j); the 5 direction bits of a
    lane's column (at R = 2 one word, 5 bits a row; at R = 16 a word of L
    and R, 4 bits a row, and one of G, a bit a row) at slot
    (j - 1 + l) mod max_m of the pass, lanes innermost; lane 31 keeping
    the pass's last L and R rows; then the start matrix and the walk
    through tiles of 32 / R + 1 strips x 32 columns, the matrix picking
    the cell's field by a shift and an xor.  Returns (sm, ops,
    nsteps) as the kernel's wrapper does."""
    B = len(elen)
    est, gen = est.astype(np.int64), gen.astype(np.int64)
    n = np.clip(elen.astype(np.int64), 0, max_n)
    m = np.clip(glen.astype(np.int64), 0, max_m)
    P = 32 * R
    lpp = min(32, -(-max_n // R))
    lane = np.arange(32)
    DLR = np.zeros((B, -(-max_n // P), max_m, lpp), dtype=np.int64)
    DG = np.zeros_like(DLR)
    topL = np.zeros((B, max_m + 1), dtype=np.int64)
    topR = np.zeros_like(topL)
    Lc, Gc, Rc = (np.zeros((B, 32, R), dtype=np.int64) for _ in range(3))
    bi = np.arange(B)[:, None, None]
    for p0 in range(0, int(n.max(initial=0)), P):
        inpass = (m > 0) & (p0 < n)
        lact = np.minimum(32, (n - p0 + R - 1) // R)
        keep = p0 + P < n
        rows = p0 + lane[:, None] * R + np.arange(R)[None, :] + 1  # (32, R)
        ec = np.where(rows[None] <= n[:, None, None],
                      est[bi, np.clip(rows - 1, 0, max_n - 1)[None]], 0)
        ew = _wild(ec)
        lst = np.where(rows[None] == n[:, None, None], 1, 0)
        Lc[inpass] = rows
        Rc[inpass] = rows
        Gc[inpass] = rows + 1
        dL = np.broadcast_to(rows[:, 0] - 1, (B, 32)).copy()
        dR = dL.copy()
        botL, botR, gch = (np.zeros((B, 32), dtype=np.int64)
                           for _ in range(3))
        steps = np.where(inpass, m + lact - 1, 0)
        for s in range(int(steps.max(initial=0))):
            j0 = s + 1                      # lane 0's column
            inj = j0 <= m
            g0 = np.where(inj, gen[:, min(j0, max_m) - 1], 0)
            upL, upR = _shfl_up1(botL), _shfl_up1(botR)
            upL[:, 0] = np.where(inj, topL[:, min(j0, max_m)]
                                 if p0 else j0, 0)
            upR[:, 0] = np.where(inj, topR[:, min(j0, max_m)]
                                 if p0 else j0, 0)
            gch = _shfl_up1(gch)
            gch[:, 0] = g0
            j = s - lane + 1
            act = ((lane[None] < lact[:, None]) & (j[None] >= 1)
                   & (j[None] <= m[:, None]) & inpass[:, None])
            wg = _wild(gch)
            pL, pR, uL, uR = dL, dR, upL, upR
            wlr = np.zeros((B, 32), dtype=np.int64)
            wgb = np.zeros((B, 32), dtype=np.int64)
            nL, nG, nR = Lc.copy(), Gc.copy(), Rc.copy()
            for r in range(R):
                ms2 = np.where((gch == ec[:, :, r]) | wg | ew[:, :, r], 3, 1)
                lc, gc, rc = Lc[:, :, r], Gc[:, :, r], Rc[:, :, r]
                diagL = pL + ms2
                lv = np.maximum(np.maximum(diagL, uL), lc)
                ld = np.where(lv == diagL, 0, np.where(lv == uL, 1, 2))
                gd = np.where(gc < lc + 1, 0, 1)
                diagR, leftR = pR + ms2, rc + lst[:, :, r]
                rv = np.maximum(np.maximum(diagR, uR), np.maximum(gc, leftR))
                rd = np.where(rv == diagR, 0, np.where(
                    rv == leftR, 2, np.where(rv == gc, 3, 1)))
                if R == 2:
                    wlr |= (ld | (rd << 2) | (gd << 4)) << (5 * r)
                else:
                    wlr |= (ld | (rd << 2)) << (4 * r)
                    wgb |= gd << r
                pL, pR, uL, uR = lc, rc, lv, rv
                nL[:, :, r], nG[:, :, r] = lv, np.maximum(gc, lc + 1) + 1
                nR[:, :, r] = rv
            for a, new in ((Lc, nL), (Gc, nG), (Rc, nR)):
                a[...] = np.where(act[:, :, None], new, a)
            botL = np.where(act, Lc[:, :, R - 1], botL)
            botR = np.where(act, Rc[:, :, R - 1], botR)
            dL, dR = np.where(act, upL, dL), np.where(act, upR, dR)
            bb, ll = np.nonzero(act)
            DLR[bb, p0 // P, s % max_m, ll] = wlr[bb, ll]
            DG[bb, p0 // P, s % max_m, ll] = wgb[bb, ll]
            wr = act[:, 31] & keep
            topL[wr, j[31]] = botL[wr, 31]
            topR[wr, j[31]] = botR[wr, 31]
    strips = 32 // R + 1
    T = max_n + max_m
    sm = np.full(B, 2, dtype=np.int32)
    ops = np.zeros((B, T), dtype=np.int8)
    nsteps = np.zeros(B, dtype=np.int32)
    for b in range(B):
        if n[b] and m[b]:
            last = (n[b] - 1) // P * P
            at = ((n[b] - 1 - last) // R, (n[b] - 1) % R)
            lf, gf, rf = Lc[b][at], Gc[b][at] - 1, Rc[b][at]
            sm[b] = (2 if rf >= lf else 0) if rf >= gf else \
                (1 if gf >= lf else 0)
        i, j, s, mat = int(n[b]), int(m[b]), 0, int(sm[b])
        while i > 0 and j > 0:
            st = (i - 1) // R
            tlr = np.zeros((strips, 32), dtype=np.int64)
            tg = np.zeros_like(tlr)
            for q in range(strips):
                for ln in range(32):
                    c = j - ln
                    if st - q >= 0 and c >= 1:
                        sq = st - q
                        at = (b, sq // 32, (c - 1 + sq % 32) % max_m, sq % 32)
                        tlr[q, ln], tg[q, ln] = DLR[at], DG[at]
            i_lo, j_lo, j0 = max((st - strips + 1) * R, 0), max(j - 32, 0), j
            while i > i_lo and j > j_lo:
                q, rr = st - (i - 1) // R, (i - 1) % R
                cell = ((tlr[q, j0 - j] >> (5 * rr)) & 31 if R == 2 else
                        ((tlr[q, j0 - j] >> (4 * rr)) & 15)
                        | (((tg[q, j0 - j] >> rr) & 1) << 4))
                sh, mask = (4, 1) if mat == 1 else (mat, 3)
                d = int((cell >> sh) & mask) ^ (3 if mat == 1 else 0)
                ops[b, s] = d
                s += 1
                i -= d <= 1
                j -= d != 1
                mat -= d == 3
        nsteps[b] = s
    return sm, ops, nsteps


def gap_model_cases(seed, long_len):
    """gap_cases plus the model's edges: an est longer than a pass of 32
    lanes' strips (``long_len``) against its gen with an intron, an
    all-wildcard est, one row and one column, e == g, and both sides
    empty."""
    rng = np.random.default_rng(seed)
    e = "".join(rng.choice(ACGT, long_len))
    cut = long_len // 3
    g = _mutate(rng, e[:cut] + "".join(rng.choice(ACGT, 90)) + e[cut:],
                long_len // 30)
    wild = "".join(rng.choice(WILD, 40))
    return gap_cases(seed, count=20) + [
        (e, g), (e, e), (e[:long_len // 2], g), (wild, g[:120]), (e, "A"),
        ("C", g), ("N" * 30, "ACGTACGT"), ("G", "G"), ("", g), (e, "")]


@pytest.mark.parametrize("R,long_len", [(2, 150), (16, 560)])
def test_gap_warp_model_matches_plain_and_jax(R, long_len):
    """The warp design's decomposition (lanes x row strips x skewed
    column sweep, three matrices with the left chains and G's running
    maximum in the lane, passes through the row buffer, the two
    direction planes at their skewed slots, the tiled walk) gives the
    plain version's and the JAX op's start matrix, ops and step counts
    on every problem; R = 2 is the kernel's for the (64, 256) bucket
    and R = 16 its long-est instance, each with an est of two passes."""
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    s1, l1, s2, l2 = encode(gap_model_cases(80 + R, long_len), pad=3)
    N, M = s1.shape[1], s2.shape[1]
    assert l1.max() > 32 * R and (l1 == 0).any() and (l2 == 0).any()
    sm, ops, nsteps = (t.numpy() for t in align.batch_gap_traceback(
        *_torch(s1, l1, s2, l2), max_n=N, max_m=M))
    sm_j, ops_j, n_j = jalign.decode_gap_fused(
        jalign.batch_gap_traceback(s1, l1, s2, l2, max_n=N, max_m=M), N + M)
    np.testing.assert_array_equal(sm, sm_j)
    np.testing.assert_array_equal(nsteps, n_j)
    got = gap_warp_model(s1, l1, s2, l2, max_n=N, max_m=M, R=R)
    np.testing.assert_array_equal(got[0], sm)
    np.testing.assert_array_equal(got[1], ops)
    np.testing.assert_array_equal(got[2], nsteps)
    for b in range(len(l1)):
        np.testing.assert_array_equal(got[1][b, :n_j[b]], ops_j[b, :n_j[b]])


def test_gap_scratch_is_at_most_the_offloads_cap():
    """gap_kernel's scratch (the two direction planes and the row
    buffer), at the rows a lane the wrapper picks, is what the offload's
    sub-batching counts a problem against the launch budget
    (offload.scratch_bytes) for every bucket it forms, and stays within
    N * M bytes; R = 2 for the (64, 256) bucket of STEP 2's gap
    launches."""
    assert traceback.gap_rows(64) == 2 and traceback.gap_rows(256) == 16
    for N in (16, 64, 256, 1024, 4096, 16384):
        for M in (16, 64, 256, 1024, 4096, 16384):
            R = traceback.gap_rows(N)
            nbytes = sum(t.numel() * t.element_size()
                         for t in traceback.gap_scratch(1, N, M, "meta", R))
            assert nbytes == offload.scratch_bytes("gap", N, M), (N, M)
            assert nbytes <= N * M, (N, M)


# ---- wrappers ---------------------------------------------------------------

WRAPPERS = [
    ("nw", traceback.batch_nw_traceback_cuda, align.batch_nw_traceback),
    ("gap", traceback.batch_gap_traceback_cuda, align.batch_gap_traceback),
]


@pytest.mark.parametrize("name,wrapper,plain", WRAPPERS)
def test_cpu_tensors_run_the_plain_traceback(name, wrapper, plain):
    s1, l1, s2, l2 = encode(gap_cases(50, count=20))
    args = _torch(s1, l1, s2, l2)
    kw = dict(max_n=s1.shape[1], max_m=s2.shape[1])
    limits.reset_launches()
    for got, want in zip(wrapper(*args, **kw), plain(*args, **kw)):
        assert torch.equal(got, want), name
    assert not any(limits.LAUNCHES.values())


def test_cpu_tensors_run_the_plain_rowmin():
    s1, l1, s2, l2 = encode([(g, e) for e, g in gap_cases(51, count=20)])
    args = _torch(s1, l1, s2, l2)
    limits.reset_launches()
    for got, want in zip(
            traceback.batch_edit_rowmin_cuda(*args, max_rows=s2.shape[1]),
            align.batch_edit_rowmin(*args, max_rows=s2.shape[1])):
        assert torch.equal(got, want)
    assert not any(limits.LAUNCHES.values())


def test_non_cpu_tensors_never_run_the_plain_versions(monkeypatch):
    """A tensor off the CPU goes to a kernel or the call raises."""
    def plain(*a, **k):
        raise AssertionError("plain version called for a device tensor")

    for name in ("batch_nw_traceback", "batch_gap_traceback",
                 "batch_edit_rowmin"):
        monkeypatch.setattr(align, name, plain)
    s1, l1, s2, l2 = (t.to("meta")
                      for t in _torch(*encode([("ACGT", "ACG")])))
    with pytest.raises(ValueError, match="no nw kernel"):
        traceback.batch_nw_traceback_cuda(s1, l1, s2, l2, max_n=4, max_m=3)
    with pytest.raises(ValueError, match="no gap kernel"):
        traceback.batch_gap_traceback_cuda(s1, l1, s2, l2, max_n=4, max_m=3)
    with pytest.raises(ValueError, match="no rowmin kernel"):
        traceback.batch_edit_rowmin_cuda(s1, l1, s2, l2, max_rows=3)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "batch",
                                 "width", "too_wide"])
def test_wrapper_rejects_malformed_batches(bad):
    s1, l1, s2, l2 = _torch(*encode(gap_cases(52, count=8)))
    N, M = s1.shape[1], s2.shape[1]
    if bad == "dtype":
        s1 = s1.to(torch.int32)
    elif bad == "shape":
        l1 = l1[:, None]
    elif bad == "contiguous":
        s2 = torch.cat([s2, s2], dim=1)[:, ::2]
    elif bad == "batch":
        l2 = l2[:-1]
    elif bad == "width":
        M += 1
    else:
        wide = traceback.MAX_WIDTH + 1
        s2 = torch.zeros((s1.shape[0], wide), dtype=torch.int8,
                         device="meta")
        s1, l1, l2 = s1.to("meta"), l1.to("meta"), l2.to("meta")
        M = wide
    with pytest.raises(ValueError):
        traceback.batch_gap_traceback_cuda(s1, l1, s2, l2, max_n=N, max_m=M)


# ---- kernels against their plain versions, on the card ----------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,wrapper,plain", WRAPPERS)
@pytest.mark.parametrize("pad", [0, 1000])
def test_traceback_kernels_match_plain_on_card(cuda_device, name, wrapper,
                                               plain, pad):
    s1, l1, s2, l2 = encode(gap_cases(60) + nw_cases(61), pad=pad)
    args = _torch(s1, l1, s2, l2, device=cuda_device)
    kw = dict(max_n=s1.shape[1], max_m=s2.shape[1])
    before = limits.LAUNCHES[name]
    got = wrapper(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w), name
    assert limits.LAUNCHES[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("est_len,gen_len", [(30, 16), (100, 20), (64, 31)])
def test_gap_kernel_narrow_gen_windows_on_card(cuda_device, est_len,
                                               gen_len):
    """gen windows narrower than a warp, where the walk's tile slots
    wrap more than once (R = 2 and R = 16), equal the plain version."""
    rng = np.random.default_rng(est_len + gen_len)
    pairs = [("".join(rng.choice(WILD, int(rng.integers(0, est_len + 1)))),
              "".join(rng.choice(ACGT, int(rng.integers(0, gen_len + 1)))))
             for _ in range(40)] + [("A" * est_len, "A" * gen_len)]
    s1, l1, s2, l2 = encode(pairs)
    args = _torch(s1, l1, s2, l2, device=cuda_device)
    kw = dict(max_n=s1.shape[1], max_m=s2.shape[1])
    got = traceback.batch_gap_traceback_cuda(*args, **kw)
    want = align.batch_gap_traceback(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 3000])
def test_rowmin_kernel_matches_plain_on_card(cuda_device, pad):
    s1, l1, s2, l2 = encode([(g, e) for e, g in gap_cases(62)], pad=pad)
    args = _torch(s1, l1, s2, l2, device=cuda_device)
    R = s2.shape[1]
    before = limits.LAUNCHES["rowmin"]
    vals, pos = traceback.batch_edit_rowmin_cuda(*args, max_rows=R)
    pv, pp = align.batch_edit_rowmin(*args, max_rows=R)
    torch.cuda.synchronize()
    live = (torch.arange(R + 1, device=cuda_device)[None, :]
            <= args[3][:, None].long())
    assert torch.equal(vals[live], pv[live])
    assert torch.equal(pos[live], pp[live])
    assert limits.LAUNCHES["rowmin"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("index", [1, 4, 6, 10, 14, 20])
def test_nw_kernel_main_path_shapes_on_card(cuda_device, index):
    """nw_kernel at launch shapes STEP 2 gives it (measure_nw's 21):
    one problem of (256, 64), the 4096 buckets of TP53 and issue-13, the
    331 problems of (256, 256), the 15 of (64, 256) and the 220 of
    (1024, 1024), equal to the plain version on every problem."""
    from pintron_tpu_torch.measure_nw import (MAIN_PATH_NW_SHAPES,
                                              main_path_nw_batch)
    est, elen, gen, glen, N, M = main_path_nw_batch(
        MAIN_PATH_NW_SHAPES[index], index)
    args = _torch(est, elen, gen, glen, device=cuda_device)
    before = limits.LAUNCHES["nw"]
    got = traceback.batch_nw_traceback_cuda(*args, max_n=N, max_m=M)
    want = align.batch_nw_traceback(*args, max_n=N, max_m=M)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert limits.LAUNCHES["nw"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(8))
def test_gap_kernel_main_path_shapes_on_card(cuda_device, index):
    """gap_kernel at the 8 launch shapes STEP 2 gives it (measure_gap's,
    all in the (64, 256) bucket at R = 2 rows a lane), equal to the
    plain version on every problem."""
    from pintron_tpu_torch.measure_gap import (MAIN_PATH_GAP_SHAPES,
                                               main_path_gap_batch)
    est, elen, gen, glen, N, M = main_path_gap_batch(
        MAIN_PATH_GAP_SHAPES[index], index)
    assert traceback.gap_rows(N) == 2
    args = _torch(est, elen, gen, glen, device=cuda_device)
    before = limits.LAUNCHES["gap"]
    got = traceback.batch_gap_traceback_cuda(*args, max_n=N, max_m=M)
    want = align.batch_gap_traceback(*args, max_n=N, max_m=M)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert limits.LAUNCHES["gap"] == before + 1


# ---- the edit-row sweep of rowmin_kernel and edit_score_kernel -------------
# csrc/rowmin.cu: one sweep, two epilogues; a numpy model of its layout
# against the plain ops and the JAX ops, the wrappers' layout, and (on the
# card) the kernels at the launches the main path gives them

def editrow_model(seq1, len1, seq2, len2, *, max_rows, R, G, rowmin):
    """numpy model of csrc/rowmin.cu's edit_sweep, every problem at once:
    G lanes a problem (32 // G problems a warp, which share the warp's
    loop bounds), passes of G * R pattern rows, lane l holding rows
    l*R+1 .. l*R+R of a pass; step s of a pass computes column s - l + 1
    on lane l from its own rows at the previous column, lane l-1's last
    row of one step earlier (lane 0: the row above the pass, 0 on the
    first pass and read from the row buffer after it) and the text
    character passed along the lanes, every value kept as X = M - i - j
    so that a cell is one three-way minimum; lane G-1 writes the pass's
    last row to the row buffer.  rowmin keeps each row's (least M - i,
    first column) pair, replaced on a strict <, and writes rows 0..len2
    after each pass (the others stay -1); edit_score writes
    M[rows][len1] from the lane holding row ``rows``.  Returns (vals,
    pos) or out."""
    B, N = seq1.shape
    MC = seq2.shape[1]
    K = 32 // G
    Bp = -(-B // K) * K
    live = np.arange(Bp) < B
    t = np.zeros((Bp, N), dtype=np.int64)
    p = np.zeros((Bp, MC), dtype=np.int64)
    t[:B], p[:B] = seq1, seq2
    n = np.zeros(Bp, dtype=np.int64)
    rows = np.zeros(Bp, dtype=np.int64)
    n[:B] = np.clip(len1, 0, N)
    rows[:B] = np.clip(len2, 0, max_rows)

    def warp_max(x):
        return np.repeat(x.reshape(-1, K).max(axis=1), K)

    lane = np.arange(G)
    bi = np.arange(Bp)[:, None, None]
    V = np.full((Bp, max_rows + 1), -1, dtype=np.int64)
    P = np.full_like(V, -1)
    out = np.full(Bp, -1, dtype=np.int64)
    V[live, 0] = P[live, 0] = 0
    out[live & (rows == 0)] = n[live & (rows == 0)]
    rowbuf = np.zeros((Bp, N + 1), dtype=np.int64)
    vals, best, arg = (np.zeros((Bp, G, R), dtype=np.int64)
                       for _ in range(3))
    prows = warp_max(rows)
    for p0 in range(0, int(prows.max(initial=0)), G * R):
        i0 = p0 + lane * R
        lact = np.clip((rows - p0 + R - 1) // R, 0, G)
        keep = p0 + G * R < rows
        first = p0 == 0
        i = i0[:, None] + np.arange(R)[None, :] + 1            # (G, R)
        pc = np.where(i[None] <= rows[:, None, None],
                      p[bi, np.minimum(i, MC)[None] - 1], 0)
        vals[...] = 0
        best[...] = 0
        arg[...] = 0
        d = np.zeros((Bp, G), dtype=np.int64)
        bot = np.zeros((Bp, G), dtype=np.int64)
        tch = np.broadcast_to(np.where(n >= 1, t[:, 0], 0)[:, None],
                              (Bp, G)).copy()
        steps = np.where((lact > 0) & (n > 0), n + lact - 1, 0)
        wsteps = warp_max(steps)
        for s in range(int(wsteps.max(initial=0))):
            run = s < wsteps
            t0 = np.where(s + 1 < n, t[:, min(s + 1, N - 1)], 0)
            t_in = _shfl_up1(tch)
            up = _shfl_up1(bot)
            j0 = s + 1
            up[:, 0] = 0 if first else np.where(
                j0 <= n, rowbuf[:, min(j0, N)], 0)
            j = s - lane + 1
            act = (run[:, None] & (lane[None] < lact[:, None]) & (j >= 1)
                   & (j <= n[:, None]))
            u, dg = up, d
            new = vals.copy()
            for r in range(R):
                v = np.minimum(np.minimum(vals[:, :, r], u),
                               dg + (tch != pc[:, :, r]) - 2)
                dg = vals[:, :, r]
                u = v
                new[:, :, r] = v
                y = v + j[None]
                better = act & (y < best[:, :, r])
                best[:, :, r] = np.where(better, y, best[:, :, r])
                arg[:, :, r] = np.where(better, j[None], arg[:, :, r])
            vals = np.where(act[:, :, None], new, vals)
            bot = np.where(act, u, bot)
            d = np.where(act, up, d)
            w = act[:, G - 1] & keep
            rowbuf[w, j[G - 1]] = bot[w, G - 1]
            tch = np.where(run[:, None], np.where(lane == 0, t0[:, None],
                                                  t_in), tch)
        for b in np.flatnonzero(live & (lact > 0)):
            for ln in range(int(lact[b])):
                for r in range(R):
                    row = p0 + ln * R + r + 1
                    if row > rows[b]:
                        continue
                    V[b, row] = best[b, ln, r] + row
                    P[b, row] = arg[b, ln, r]
                    if row == rows[b]:
                        out[b] = vals[b, ln, r] + row + n[b]
    if rowmin:
        return V[:B], P[:B]
    return out[:B]


def _point_mutate(rng, s, rate):
    s = np.array(list(s))
    hits = rng.random(len(s)) < rate
    s[hits] = rng.choice(ACGT, int(hits.sum()))
    return "".join(s)


def edit_cases(seed, long_pattern):
    """(text, pattern) pairs with the model's edges: len1 = 0, len2 = 0,
    both 0 (a padded problem), texts narrower than a warp, repeats that
    tie a row's minimum at several columns (the first must win), N and
    bytes >= 128, realistic refine-borders pairs (the pattern inside its
    text with point mutations), and one pattern of ``long_pattern`` rows
    (several passes at R = 16)."""
    rng = np.random.default_rng(seed)
    cases = [("", "ACGT"), ("ACGT", ""), ("", ""), ("A", "A"),
             ("ACGTACGT", "T"), ("AAAAAAAAAAAAAAAAAAAA", "AA"),
             ("ACACACACACACACAC", "CA"), ("GATTACA", "GATTACAGATTACA"),
             ("NNNN\xe9A", "AN\xe9"), ("TTTTTTTTTT", "GGGG")]
    for _ in range(31):
        m = int(rng.integers(1, 31))
        pat = "".join(rng.choice(ACGT, m))
        n = int(rng.integers(max(1, m // 2), 61))
        txt = "".join(rng.choice(ACGT, n))
        at = int(rng.integers(0, max(n - m, 0) + 1))
        txt = (txt[:at] + _point_mutate(rng, pat, 0.05) + txt[at:])[:n]
        cases.append((txt, pat))
    pat = "".join(rng.choice(ACGT, long_pattern))
    cases.append(("".join(rng.choice(ACGT, 40)) + _point_mutate(rng, pat, 0.03)
                  [:long_pattern // 3], pat))
    cases.append(("".join(rng.choice(ACGT, 7)), pat))
    return cases


def _encode_bytes(pairs, pad):
    """encode() for strings whose characters are bytes (latin-1)."""
    N = max(max(len(a) for a, _ in pairs), 1) + pad
    M = max(max(len(b) for _, b in pairs), 1) + pad
    s1 = np.zeros((len(pairs), N), dtype=np.uint8)
    s2 = np.zeros((len(pairs), M), dtype=np.uint8)
    l1 = np.zeros(len(pairs), dtype=np.int32)
    l2 = np.zeros(len(pairs), dtype=np.int32)
    for k, (a, b) in enumerate(pairs):
        s1[k, :len(a)] = np.frombuffer(a.encode("latin-1"), dtype=np.uint8)
        s2[k, :len(b)] = np.frombuffer(b.encode("latin-1"), dtype=np.uint8)
        l1[k], l2[k] = len(a), len(b)
    return s1.view(np.int8), l1, s2.view(np.int8), l2


LAYOUTS = [(1, 16), (2, 32), (16, 32)]  # the library's instances


@pytest.mark.parametrize("R,G", LAYOUTS)
def test_rowmin_model_matches_plain_and_jax(R, G):
    """The sweep's decomposition with rowmin's epilogue (lanes x row
    strips x skewed column sweep, the left chain in the lane, passes
    through the row buffer, two problems a warp at G = 16) gives the
    plain op's and the JAX op's minima and first argmins on every live
    row; the long pattern takes 2 passes at R = 16, 2 at (2, 32) and 5
    at (1, 16)."""
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    long_pattern = 560 if R == 16 else 70
    s1, l1, s2, l2 = _encode_bytes(edit_cases(90 + R + G, long_pattern),
                                   pad=3)
    M = s2.shape[1]
    assert l2.max() > G * R and len(l1) % 2 == 1
    vals, pos = align.batch_edit_rowmin(*_torch(s1, l1, s2, l2),
                                        max_rows=M)
    fused = np.asarray(jalign.batch_edit_rowmin(s1, l1, s2, l2,
                                                max_rows=M)).astype(np.int64)
    mv, mp = editrow_model(s1, l1, s2, l2, max_rows=M, R=R, G=G,
                           rowmin=True)
    for b in range(len(l1)):
        live = int(l2[b]) + 1
        np.testing.assert_array_equal(vals.numpy()[b, :live],
                                      fused[b, :live])
        np.testing.assert_array_equal(pos.numpy()[b, :live],
                                      fused[b, M + 1:M + 1 + live])
        np.testing.assert_array_equal(mv[b, :live], vals.numpy()[b, :live])
        np.testing.assert_array_equal(mp[b, :live], pos.numpy()[b, :live])


@pytest.mark.parametrize("R,G", LAYOUTS)
def test_edit_score_model_matches_plain_and_jax(R, G):
    """The same sweep with edit_score's epilogue, at max_rows under and
    over the longest pattern (rows past max_rows are not computed),
    equals the plain op and the JAX op on every problem."""
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    long_pattern = 560 if R == 16 else 70
    s1, l1, s2, l2 = _encode_bytes(edit_cases(70 + R + G, long_pattern),
                                   pad=2)
    for max_rows in (s2.shape[1], 25):
        want = align.batch_edit_distance_score(*_torch(s1, l1, s2, l2),
                                               max_rows=max_rows).numpy()
        jax_out = np.asarray(jalign.batch_edit_distance_score(
            s1, l1, s2, l2, max_rows=max_rows))
        np.testing.assert_array_equal(want, jax_out)
        got = editrow_model(s1, l1, s2, l2, max_rows=max_rows, R=R, G=G,
                            rowmin=False)
        np.testing.assert_array_equal(got, want)


def test_edit_score_model_text_wider_than_16384():
    """edit_score takes every width (no MAX_WIDTH): a text of 16400
    columns at the wrappers' layout equals the plain op and the JAX
    op."""
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    rng = np.random.default_rng(77)
    pat = "".join(rng.choice(ACGT, 12))
    txt = "".join(rng.choice(ACGT, 16400))
    pairs = [(txt, pat), (txt[:16390] + pat[::-1], pat), (txt[:3], pat)]
    s1, l1, s2, l2 = encode(pairs)
    want = align.batch_edit_distance_score(*_torch(s1, l1, s2, l2),
                                           max_rows=16).numpy()
    np.testing.assert_array_equal(want, np.asarray(
        jalign.batch_edit_distance_score(s1, l1, s2, l2, max_rows=16)))
    R, G = kband.edit_layout(16)
    got = editrow_model(s1, l1, s2, l2, max_rows=16, R=R, G=G,
                        rowmin=False)
    np.testing.assert_array_equal(got, want)


def test_layout_follows_the_row_bucket():
    """The wrappers' layout: two problems a warp for the 16-row bucket,
    one pass of a warp for the 64-row bucket, 16 rows a lane beyond; the
    row buffer is allocated only when one pass does not cover the
    bucket."""
    assert kband.edit_layout(0) == kband.edit_layout(16) == (1, 16)
    assert kband.edit_layout(17) == kband.edit_layout(64) == (2, 32)
    assert kband.edit_layout(65) == kband.edit_layout(16384) == (16, 32)
    for max_rows in (0, 1, 16, 64, 256, 512):
        assert kband.edit_rowbuf(8, 64, max_rows,
                                 kband.edit_layout(max_rows), "meta") is None
    buf = kband.edit_rowbuf(8, 64, 1024, kband.edit_layout(1024), "meta")
    assert buf.shape == (8, 65) and buf.dtype == torch.int32
    # rowmin keeps the offload's width limit; edit_score has none
    assert traceback.MAX_WIDTH == 16384


def test_edit_score_wrapper_takes_texts_wider_than_16384():
    """On the CPU the wrapper runs the plain op at any width; the kernel
    path is not capped either (no width check before the launch)."""
    s1, l1, s2, l2 = encode([("ACGT" * 4200, "ACGA"), ("", "")])
    got = kband.batch_edit_distance_score_cuda(*_torch(s1, l1, s2, l2),
                                               max_rows=4)
    assert got.tolist() == [4200 * 4 - 4, 0]  # ACGA is a subsequence
    meta = tuple(x.to("meta") for x in _torch(s1, l1, s2, l2))
    with pytest.raises(ValueError, match="no K-band kernel"):
        kband.batch_edit_distance_score_cuda(*meta, max_rows=4)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(24))
def test_rowmin_kernel_main_path_launches_on_card(cuda_device, index):
    """rowmin_kernel at the 24 launches STEP 2 gives it on TP53 and
    issue-13 (measure_rowmin's), equal to the plain version on every
    live row."""
    from pintron_tpu_torch.measure_rowmin import (MAIN_PATH_RB_SHAPES,
                                                  main_path_rb_batch)
    s1, l1, s2, l2, M = main_path_rb_batch(MAIN_PATH_RB_SHAPES[index],
                                           index)
    args = _torch(s1, l1, s2, l2, device=cuda_device)
    before = limits.LAUNCHES["rowmin"]
    got = traceback.batch_edit_rowmin_cuda(*args, max_rows=M)
    want = align.batch_edit_rowmin(*args, max_rows=M)
    torch.cuda.synchronize()
    live = (torch.arange(M + 1, device=cuda_device)[None, :]
            <= args[3][:, None].long())
    for g, w in zip(got, want):
        assert torch.equal(g[live], w[live])
    assert limits.LAUNCHES["rowmin"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("R,G", LAYOUTS)
def test_edit_kernels_every_layout_on_card(cuda_device, R, G):
    """Both kernels at every layout the library instantiates, on the
    model's cases (a long pattern of several passes, padded and empty
    problems, an odd batch), equal to the plain versions."""
    lib_launch = kband.launch_edit_rows
    s1, l1, s2, l2 = _encode_bytes(edit_cases(90 + R + G, 1100), pad=3)
    args = _torch(s1, l1, s2, l2, device=cuda_device)
    M = s2.shape[1]
    vals = torch.empty((len(l1), M + 1), dtype=torch.int32,
                       device=cuda_device)
    pos = torch.empty_like(vals)
    out = torch.empty(len(l1), dtype=torch.int32, device=cuda_device)
    lib_launch("rowmin", *args, (vals, pos), M, "rowmin", (R, G))
    lib_launch("edit_score", *args, (out,), M, "K-band", (R, G))
    pv, pp = align.batch_edit_rowmin(*args, max_rows=M)
    po = align.batch_edit_distance_score(*args, max_rows=M)
    torch.cuda.synchronize()
    live = (torch.arange(M + 1, device=cuda_device)[None, :]
            <= args[3][:, None].long())
    assert torch.equal(vals[live], pv[live])
    assert torch.equal(pos[live], pp[live])
    assert torch.equal(out, po)


@pytest.mark.cuda
def test_edit_score_kernel_nine_kb_exons_on_card(cuda_device):
    """edit_score_kernel on the four 9 kb exons of the K-band budget
    checks at full length (16384-row bucket, R = 16, 18 passes), equal
    to the plain version."""
    from pintron_tpu_torch.measure_rowmin import nine_kb_exons
    s1, l1, s2, l2, M = nine_kb_exons()
    args = _torch(s1, l1, s2, l2, device=cuda_device)
    got = kband.batch_edit_distance_score_cuda(*args, max_rows=M)
    want = align.batch_edit_distance_score(*args, max_rows=M)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
