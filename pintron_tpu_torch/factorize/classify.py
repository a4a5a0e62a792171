"""Stage 4's branch-point (BPS) sweep on a torch device.

The port's twin of ``pintron_tpu.factorize.classify.precompute_bps_device``
(classify-intron.c:575-618 over every intron of the registry at once).
For every (start, end) intron and both search ranges ([14, 30] and
[30, 200]), every candidate window is scored in one batch per matrix
(``offload.pwm_scores_batched``: ``pwm_kernel`` on a GPU, its plain
version on the CPU, or the service).  The winner is then made exact on
the host: every position whose float32 score is within 1e-5 of the
float32 maximum is scored again with the reference's float64
``mat_inspector_score``, and the reference's scan rule (``>=`` keeps
the later position) picks among the exact maxima.

The results go to the reference module's ``_BPS_OVERRIDE``, pinned to
this locus by ``_BPS_OVERRIDE_GEN``; its
``classify_genomic_intron_start_end`` reads them through
``exists_good_bps`` while its ``gen`` is that object, so consuming them
is bit-identical to the host path.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

import pintron_tpu.factorize.classify as _ref
from pintron_tpu.factorize.seq_util import real_substring
from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.ops.pwm import _BASE, pwm_tables

EPS = 1e-5
MATRICES = ("BPS_9", "BPS_10")
RANGES = ((14, 30), (30, 200))


def precompute_bps_device(gen: str,
                          pairs: Iterable[Tuple[int, int]]) -> Optional[int]:
    """Fill the reference's BPS overrides for the introns ``pairs`` of
    the locus ``gen``.  Returns the number of windows scored on the
    device, or None when a batch was cut short by the wedge latch (the
    table is then left empty and pinned to ``gen``; the caller un-pins
    it)."""
    # overrides are per locus: wipe a previous locus's and pin the
    # table to this gen object
    _ref._BPS_OVERRIDE.clear()
    _ref._BPS_OVERRIDE_GEN = gen

    gen_len = len(gen)
    tables = {name: pwm_tables(name) for name in MATRICES}
    # the locus encoded once, with the host scorer's base mapping, and
    # one zero column past its end: a window running off the genome is
    # padded with code 0, as the reference's zero-initialised rows
    codes = _BASE[np.frombuffer(gen.encode("latin1"), dtype=np.uint8)]
    codes = np.append(np.where(codes >= 0, codes, 3), 0).astype(np.int8)

    batches = {name: [] for name in MATRICES}
    for (start, end) in pairs:
        L = end - start + 1
        if L <= 0:
            continue
        if end >= gen_len:
            # the consumer cuts intron_sequence with real_substring,
            # which truncates at the genome end: let the key miss, so
            # the host path (which clamps) answers
            continue
        for (rs, re) in RANGES:
            if re > L or L < rs:
                continue   # the host path answers trivially
            positions = np.arange(max(0, L - re), L - rs + 1)
            for name in MATRICES:
                wl = tables[name][0].shape[1]
                idx = start + positions[:, None] + np.arange(wl)[None, :]
                rows = codes[np.minimum(idx, gen_len)]
                batches[name].append(((start, end, rs, re), positions, rows))

    n_windows = 0
    sweep = {}   # (key, name) -> (positions, f32 scores)
    for name, items in batches.items():
        if not items:
            continue
        wpwm, den = tables[name]
        allrows = np.concatenate([rows for _, _, rows in items], axis=0)
        scores = offload.pwm_scores_batched(allrows, wpwm, den)
        if scores is None:
            return None
        n_windows += allrows.shape[0]
        pos = 0
        for key, positions, _rows in items:
            sweep[(key, name)] = (positions,
                                  scores[pos:pos + len(positions)])
            pos += len(positions)

    def exact_search(key, name):
        positions, f32s = sweep[(key, name)]
        m = float(np.max(f32s))
        best_pos, best, first = -1, 0.0, True
        iseq = gen[key[0]:key[1] + 1]
        for r, i in enumerate(positions.tolist()):
            if f32s[r] < m - EPS:
                continue
            sb = _ref.mat_inspector_score(real_substring(i, 12, iseq), name)
            if first or sb >= best:
                best, best_pos, first = sb, i, False
        return best_pos, best

    for key in dict.fromkeys(k for k, _name in sweep):
        b9, s9 = exact_search(key, "BPS_9")
        b10, s10 = exact_search(key, "BPS_10")
        _ref._BPS_OVERRIDE[key] = _ref._combine_bps(b9, s9, b10, s10)
    return n_windows
