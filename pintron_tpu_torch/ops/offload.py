"""Device evaluation of the est-fact K-band problem batches.

The port's counterpart of the K-band part of the JAX package's
``ops/offload.py``.
The native collect pass (``est_collect_noisy`` in dp.c) lists every
noisy-exon K-band check the filter cascade will need (reference:
est-factorizations.c:1828-1899 -> compute-alignments.c:319-453);
``eval_kband`` evaluates the whole cross-EST batch with the K-band
kernels (``pintron_tpu_torch.ops.kband``, bit-equal to the C
``kband_core``), and the stage pre-fills the verdicts into the native
memo (``epm_fill_noisy``) so the cascade memo-hits every exon.

Routing mirrors ``ep_kband`` (dp.c) exactly:
  * equal sequences           -> ok (no DP)
  * zero error budget         -> not ok
  * length gap > budget       -> not ok
  * band covers the matrix    -> full edit distance (batched)
  * otherwise                 -> K-band DP (batched)

The device is a module setting made by the caller (``set_device``).  On
a CPU device the wrappers run the plain PyTorch versions.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pintron_tpu_torch.ops.align import from_numpy_batch
from pintron_tpu_torch.ops.kband import (banded_edit_distance_cuda,
                                         batch_edit_distance_score_cuda)


def _p2(x: int, lo: int = 16) -> int:
    v = lo
    while v < x:
        v <<= 1
    return v


def _p4(x: int, lo: int = 16) -> int:
    """Power-of-four bucket for the sequence-length axes: few distinct
    shapes, so a typical batch is one band and one full launch."""
    v = lo
    while v < x:
        v <<= 2
    return v


def _encode(seqs: Sequence[bytes], width: int, rows: int = 0):
    """Pack byte strings into a padded int8 code batch (bytes >= 128
    wrap negative; the kernels compare codes for equality only).
    ``rows`` pads the batch axis with all-zero problems."""
    B = max(len(seqs), rows)
    out = np.zeros((B, width), dtype=np.int8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s, dtype=np.uint8)
        out[i, : len(b)] = b.astype(np.int8)
        lens[i] = len(b)
    return out, lens


# running counters for benchmarks/diagnostics: problems seen, problems
# evaluated on the device, DP cells computed there
STATS = {"problems": 0, "device_problems": 0, "device_cells": 0,
         "batches": 0, "device_runs": 0, "device_timeouts": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


_DEVICE = None


def set_device(device) -> None:
    """Select the torch device the K-band batches run on."""
    global _DEVICE
    _DEVICE = torch.device(device)


# ---- bounded dispatch ----------------------------------------------------
# A hung device must not hang the pipeline: every K-band batch runs under
# device_call(), a wall-clock-bounded worker thread.  On timeout
# (PINTRON_DEVICE_TIMEOUT_S, default 600 s) the call reports None, the
# process-wide wedge latch flips, and later device calls short-circuit
# to None; callers treat None as "memo not filled", so the native
# cascade recomputes each miss with the byte-identical host DP.  Any
# other failure (a kernel that does not build or launch, a bad batch)
# is raised to the caller: the port never moves work to the CPU because
# a kernel failed.

_WEDGED = False


def device_wedged() -> bool:
    return _WEDGED


def device_call(fn, *args, what: str = "device batch"):
    """Run fn(*args) bounded by the device dispatch timeout.  Returns
    its result, or None on timeout (wedge latch set); re-raises what
    fn raised."""
    global _WEDGED
    if _WEDGED:
        return None
    timeout = float(os.environ.get("PINTRON_DEVICE_TIMEOUT_S", "600"))
    if timeout <= 0:  # explicit opt-out: unbounded inline call
        return fn(*args)
    box: dict = {}

    def work():
        try:
            box["ok"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=work, daemon=True,
                         name="pintron-device-dispatch")
    t.start()
    t.join(timeout)
    if t.is_alive():
        _WEDGED = True
        STATS["device_timeouts"] += 1
        logging.getLogger("pintron").warning(
            "%s exceeded the %.0fs device dispatch timeout; the host DP "
            "computes the rest of this process's checks", what, timeout)
        return None
    if "err" in box:
        raise box["err"]
    return box.get("ok")


def eval_kband(problems: List[Tuple[bytes, bytes, int]]):
    """Bounded entry point: evaluate the batch on the device set with
    ``set_device``, or return None when the device is wedged (the
    caller skips the memo pre-fill and the native cascade recomputes on
    host).  A failed batch raises."""
    if _DEVICE is None:
        raise RuntimeError("offload.set_device() was not called")
    return device_call(_eval_kband_device, problems, _DEVICE,
                       what="K-band device batch")


def _eval_kband_device(problems: List[Tuple[bytes, bytes, int]],
                       device: torch.device) -> np.ndarray:
    """Evaluate a batch of (gen_window, est_window, max_err) K-band
    problems on ``device``.  Returns int64 ok flags with ep_kband's
    exact semantics (dp.c:3862-3878)."""
    # Trivial verdicts (equal strings, zero budget, length gap over
    # budget: ep_kband's short-circuits) are answered here; only the
    # residue needing a real DP reaches the device.
    ok = np.zeros(len(problems), dtype=np.int64)
    rest = []
    for i, (g, e, ub) in enumerate(problems):
        if len(g) == len(e) and g == e:
            ok[i] = 1
            continue
        if ub == 0:
            continue
        a, b = (g, e) if len(g) >= len(e) else (e, g)
        if len(a) - len(b) > ub:
            continue
        rest.append((i, a, b, ub))
    STATS["problems"] += len(problems)
    if not rest:
        return ok

    full_groups = {}
    band_groups = {}
    for i, a, b, ub in rest:
        n = len(a)
        # every problem with n <= 1024 shares ONE bucket padded to 1024;
        # only longer outliers get their own power-of-four class
        key = 1024 if n <= 1024 else _p4(n)
        if 2 * ub + 1 >= n:
            full_groups.setdefault(key, []).append((i, a, b, ub))
        else:
            band_groups.setdefault(key, []).append((i, a, b, ub))

    # Launch every group before reading any result back: launches are
    # asynchronous, so later groups' host-side encoding overlaps
    # earlier groups' device work.
    pending = []
    for N, items in sorted(full_groups.items()):
        M = _p4(max(len(b) for _, _, b, _ in items))
        Bp = _p2(len(items), lo=64)
        s1, l1 = _encode([a for _, a, _, _ in items], N, rows=Bp)
        s2, l2 = _encode([b for _, _, b, _ in items], M, rows=Bp)
        with torch.profiler.record_function("pintron_kband_full"):
            r = batch_edit_distance_score_cuda(
                *from_numpy_batch(s1, l1, s2, l2, device=device),
                max_rows=M)
        pending.append((items, r))
        STATS["device_problems"] += len(items)
        STATS["device_cells"] += sum(
            len(a) * len(b) for _, a, b, _ in items)
        STATS["batches"] += 1

    for N, items in sorted(band_groups.items()):
        M = _p4(max(len(b) for _, _, b, _ in items))
        K = _p2(max(ub for _, _, _, ub in items), lo=2)
        Bp = _p2(len(items), lo=64)
        s1, l1 = _encode([a for _, a, _, _ in items], N, rows=Bp)
        s2, l2 = _encode([b for _, _, b, _ in items], M, rows=Bp)
        band = np.zeros(Bp, dtype=np.int32)
        band[:len(items)] = [ub for _, _, _, ub in items]
        with torch.profiler.record_function("pintron_kband_band"):
            r = banded_edit_distance_cuda(
                *from_numpy_batch(s1, l1, s2, l2, band, device=device),
                max_rows=M, k_max=K)
        pending.append((items, r))
        STATS["device_problems"] += len(items)
        STATS["device_cells"] += sum(
            len(b) * (2 * ub + 1) for _, _a, b, ub in items)
        STATS["batches"] += 1

    for items, r in pending:
        rn = r.cpu().numpy()
        for (i, _a, _b, ub), dist in zip(items, rn):
            ok[i] = int(dist) <= ub

    return ok
