"""The check of the device's answers: the problems the program handed to
its device families during the window, with the answers it got back
(recorded by ``benchmark/harness/record.py``), are worked out again
with the benchmark's own plain DPs (``plain_ops.py``) and PWM scores
(``pwm.py``), and compared.

  * K-band: the verdict ``edit distance <= budget`` (a path of cost
    <= budget never leaves the band of that half-width, so the full
    unit-cost edit distance decides the same verdict);
  * endpoint NW and gap alignment: the traceback's op codes and their
    count (and the gap alignment's start matrix), exactly;
  * refine-borders: each pattern row's minimum and first minimal
    column, exactly;
  * STEP 4's edit distances, exactly;
  * STEP 4's PWM scores: the largest gap to the float64 score of the
    matrix, identified by its float32 table, which the check works out
    again from the transcribed matrices.

Which recorded problems are worked out again is drawn from the seed:
the largest of each family always, then the others in a seeded order
while the family's budget of DP cells lasts.  Nothing here imports the
program.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from benchmark.reference import plain_ops as P
from benchmark.reference import pwm as W

# DP cells each family may work out again in one run: the plain DPs do
# about 20-40 M cells a second on one core of the card's machine
BUDGET = {"kband": 6e7, "nw": 1.2e8, "gap": 3e7, "rb": 3e7, "edit": 1e7}
# problems worked out together: one row loop serves the whole batch
BATCH = 16


def cells(family: str, problem) -> int:
    if family == "pwm":
        return problem[0].shape[0]
    a, b = problem[0], problem[1]
    n = (len(a) + 1) * (len(b) + 1)
    return 3 * n if family == "gap" else n


def select(records, seed: int):
    """The records to work out again: per family the largest, then the
    rest in the seed's order within the family's budget; every PWM
    record (its windows cost a few adds each)."""
    rng = random.Random(seed)
    by_family = {}
    for rec in records:
        by_family.setdefault(rec[0], []).append(rec)
    chosen = []
    for family, recs in sorted(by_family.items()):
        if family == "pwm":
            chosen += recs
            continue
        largest = max(range(len(recs)),
                      key=lambda i: cells(family, recs[i][1]))
        rest = [r for i, r in enumerate(recs) if i != largest]
        rng.shuffle(rest)
        spent, budget = 0, BUDGET[family]
        for rec in [recs[largest]] + rest:
            c = cells(family, rec[1])
            if spent and spent + c > budget:
                continue
            chosen.append(rec)
            spent += c
    return chosen


def _groups(recs, key):
    """Records in batches of at most BATCH that share a size class."""
    classes = {}
    for rec in recs:
        classes.setdefault(key(rec), []).append(rec)
    for k in sorted(classes):
        items = classes[k]
        for i in range(0, len(items), BATCH):
            yield items[i:i + BATCH]


def _p2(x: int) -> int:
    v = 16
    while v < x:
        v <<= 1
    return v


def _edit_distances(pairs):
    """Full unit-cost edit distances of (a, b) byte pairs."""
    longer = [(a, b) if len(a) >= len(b) else (b, a) for a, b in pairs]
    N = max(len(a) for a, _b in longer)
    M = max(len(b) for _a, b in longer)
    s1, l1 = P.encode([a for a, _b in longer], N)
    s2, l2 = P.encode([b for _a, b in longer], M)
    d = P.batch_edit_distance_score(s1, l1, s2, l2, max_rows=M)
    return [int(x) for x in d]


def _kband(group):
    d = _edit_distances([(g, e) for _f, (g, e, _ub), _ans in group])
    return [(int(dist <= ub), int(ans))
            for dist, (_f, (_g, _e, ub), ans) in zip(d, group)]


def _edit(group):
    d = _edit_distances([p for _f, p, _ans in group])
    return [(dist, int(ans)) for dist, (_f, _p, ans) in zip(d, group)]


def _traceback(group, gap: bool):
    es = [e for _f, (e, _g), _ans in group]
    gs = [g for _f, (_e, g), _ans in group]
    N, M = max(max(map(len, es)), 1), max(max(map(len, gs)), 1)
    s1, l1 = P.encode(es, N)
    s2, l2 = P.encode(gs, M)
    fn = P.batch_gap_traceback if gap else P.batch_nw_traceback
    r = fn(s1, l1, s2, l2, max_n=N, max_m=M)
    pairs = []
    for k, (_f, _p, ans) in enumerate(group):
        if gap:
            sm, ops, n = r[0][k], r[1][k], r[2][k]
            ref = (int(sm), ops[:int(n)].numpy().tobytes(), int(n))
        else:
            ops, n = r[1][k], r[2][k]
            ref = (ops[:int(n)].numpy().tobytes(), int(n))
        pairs.append((ref, tuple(ans)))
    return pairs


def _rb(group):
    ts = [t for _f, (t, _p), _ans in group]
    ps = [p for _f, (_t, p), _ans in group]
    N, M = max(max(map(len, ts)), 1), max(max(map(len, ps)), 1)
    s1, l1 = P.encode(ts, N)
    s2, l2 = P.encode(ps, M)
    vals, pos = P.batch_edit_rowmin(s1, l1, s2, l2, max_rows=M)
    pairs = []
    for k, (_f, (_t, p), (v, q)) in enumerate(group):
        w = len(p) + 1
        ref = (vals[k, :w].numpy().astype(np.int64).tobytes(),
               pos[k, :w].numpy().astype(np.int64).tobytes())
        got = (np.asarray(v, dtype=np.int64)[:w].tobytes(),
               np.asarray(q, dtype=np.int64)[:w].tobytes())
        pairs.append((ref, got))
    return pairs


def _size_key(rec):
    a, b = rec[1][0], rec[1][1]
    return (_p2(len(a) + 1), _p2(len(b) + 1))


def check(records, seed: int) -> dict:
    """Work the selected records out again.  Returns {"compared":
    {family: problems}, "differing": {family: problems whose answer
    differs}, "pwm_gap": the largest |score - float64 score| (None
    without PWM records), "pwm_windows": windows compared}."""
    torch.set_num_threads(1)
    chosen = select(records, seed)
    compared, differing = {}, {}
    pwm_gap, pwm_windows = None, 0
    runners = {"kband": _kband, "edit": _edit, "rb": _rb,
               "nw": lambda g: _traceback(g, gap=False),
               "gap": lambda g: _traceback(g, gap=True)}
    for family, fn in runners.items():
        recs = [r for r in chosen if r[0] == family]
        for group in _groups(recs, _size_key):
            for ref, got in fn(group):
                compared[family] = compared.get(family, 0) + 1
                if ref != got:
                    differing[family] = differing.get(family, 0) + 1
    for _f, (rows, wpwm, den), scores in (r for r in chosen
                                           if r[0] == "pwm"):
        compared["pwm"] = compared.get("pwm", 0) + 1
        name = W.identify(np.asarray(wpwm), den)
        if name is None:
            differing["pwm"] = differing.get("pwm", 0) + 1
            continue
        gap = float(np.max(np.abs(np.asarray(scores, dtype=np.float64)
                                  - W.scores64(rows, name)),
                           initial=0.0))
        pwm_gap = gap if pwm_gap is None else max(pwm_gap, gap)
        pwm_windows += rows.shape[0]
    return {"compared": compared, "differing": differing,
            "pwm_gap": pwm_gap, "pwm_windows": pwm_windows}
