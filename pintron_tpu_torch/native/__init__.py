"""Native (C) host kernels with lazy build + ctypes binding.

The reference implements its alignment inner loops in C; so do we.  The
shared object is compiled on first use into ``build/native/`` at the
root of the checkout (the repo itself stays source-only; ``build/`` is
ignored by git) and loaded via ctypes.  The JAX package builds the same
source into a cache of its own, so the two libraries, and their C
globals (the result memo, the gap lookaside), stay apart in a process
that loads both.  If no C compiler is available the callers fall back
to the NumPy implementations in
``pintron_tpu_torch.factorize.alignments``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "dp.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "native")


def _build_and_load():
    with open(_SRC, "rb") as f:
        src = f.read()
    hdr = os.path.join(os.path.dirname(__file__), "pwm_tables.h")
    if os.path.exists(hdr):
        with open(hdr, "rb") as f:
            src += f.read()
    tag = hashlib.sha256(src + b"|O3native").hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libpintron_dp-{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        built = False
        for flags in (["-O3", "-march=native", "-funroll-loops"],
                      ["-O2"]):
            for cc in ("cc", "gcc", "clang"):
                try:
                    subprocess.run([cc, *flags, "-fPIC", "-shared", _SRC,
                                    "-o", tmp, "-lm"], check=True,
                                   capture_output=True)
                    os.replace(tmp, so_path)
                    built = True
                    break
                except (subprocess.CalledProcessError, FileNotFoundError):
                    continue
            if built:
                break
        if not built:
            return None
    lib = ctypes.CDLL(so_path)
    lib.kband_core.restype = ctypes.c_int64
    lib.kband_core.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int64]
    lib.nw_align.restype = ctypes.c_int64
    lib.nw_align.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_void_p]
    lib.refine_intron_core.restype = ctypes.c_int64
    lib.refine_intron_core.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64,      # gen
         ctypes.c_char_p, ctypes.c_int64]      # est
        + [ctypes.c_int64] * 8                 # donor/acceptor factors
        + [ctypes.c_int64] * 5                 # sp_est/intron/gen, min_intron, first
        + [ctypes.POINTER(ctypes.c_int64)])    # out4
    lib.longest_affix.restype = ctypes.c_int64
    lib.longest_affix.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_double,
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.edit_total.restype = ctypes.c_int64
    lib.edit_total.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_char_p, ctypes.c_int64]
    lib.edit_matrix.restype = None
    lib.edit_matrix.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_void_p]
    lib.lcf_dp.restype = ctypes.c_int64
    lib.lcf_dp.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_int64),
                           ctypes.POINTER(ctypes.c_int64)]
    lib.bps_search.restype = ctypes.c_int64
    lib.bps_search.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_double,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_double)]
    lib.gap_align_fill.restype = None
    lib.gap_align_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.st_build.restype = ctypes.c_int64
    lib.st_build.argtypes = ([ctypes.c_char_p, ctypes.c_int64]
                             + [ctypes.c_void_p] * 13)
    lib.vertex_scan.restype = ctypes.c_int64
    lib.vertex_scan.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64,      # text
         ctypes.c_char_p, ctypes.c_int64]      # pattern
        + [ctypes.c_void_p] * 5                # start end parent slink depth
        + [ctypes.c_void_p]                    # single_char
        + [ctypes.c_void_p] * 3                # lo hi occ
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]  # coff cchar cnode
        + [ctypes.c_void_p, ctypes.c_int64]    # alph_index256, alph_size
        + [ctypes.c_double, ctypes.c_int64]    # rate, min_len
        + [ctypes.c_void_p] * 3                # out p t l
        + [ctypes.c_int64])                    # cap
    lib.meg_build.restype = ctypes.c_int64
    lib.meg_build.argtypes = (
        [ctypes.c_void_p] * 3                  # in p t l
        + [ctypes.c_int64] * 2                 # n_in, plen
        + [ctypes.c_int64] * 3                 # min_factor, max/min intron
        + [ctypes.c_double] * 2                # prefix/suffix rates
        + [ctypes.c_int64, ctypes.c_double]    # max_pairings, max_freq
        + [ctypes.c_int64] * 2                 # trans_red, short_edge_comp
        + [ctypes.c_void_p] * 6                # out p t l col off adj
        + [ctypes.c_void_p]                    # flags
        + [ctypes.c_int64] * 2)                # cap_v, cap_e
    lib.meg_factorizations.restype = ctypes.c_int64
    lib.meg_factorizations.argtypes = (
        [ctypes.c_void_p] * 6                  # vp vt vl vcol adj_off adj
        + [ctypes.c_int64] * 2                 # nv, ncols
        + [ctypes.c_char_p, ctypes.c_int64]    # gen, gen_len
        + [ctypes.c_int64] * 2                 # min_factor, min_intron
        + [ctypes.c_double]                    # deadline (monotonic s)
        + [ctypes.c_void_p] * 2                # out_off, out_f
        + [ctypes.c_int64] * 2                 # cap_facts, cap_factors
        + [ctypes.c_void_p])                   # need2
    lib.meg_format.restype = ctypes.c_int64
    lib.meg_format.argtypes = (
        [ctypes.c_void_p] * 6                  # vp vt vl vcol adj_off adj
        + [ctypes.c_int64] * 3                 # nv, ncols, mode
        + [ctypes.c_char_p, ctypes.c_int64])   # out, cap
    lib.scan_ag_after_right.restype = None
    lib.scan_ag_after_right.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p]
    lib.scan_acceptor_before_left.restype = None
    lib.scan_acceptor_before_left.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char, ctypes.c_char, ctypes.c_int64, ctypes.c_void_p]
    lib.scan_acceptor_after_left.restype = ctypes.c_int64
    lib.scan_acceptor_after_left.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char, ctypes.c_char, ctypes.c_int64, ctypes.c_int64]
    lib.scan_ag_before_right.restype = ctypes.c_int64
    lib.scan_ag_before_right.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64]
    lib.dust_score_c.restype = ctypes.c_double
    lib.dust_score_c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.refine_borders_core.restype = None
    lib.refine_borders_core.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.gap_align_run.restype = None
    lib.gap_align_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.nw_align_run.restype = ctypes.c_int64
    lib.nw_align_run.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.est_process.restype = ctypes.c_int64
    lib.est_process.argtypes = (
        [ctypes.c_void_p] * 6                  # vp vt vl vcol adj_off adj
        + [ctypes.c_int64] * 2                 # nv, ncols
        + [ctypes.c_char_p, ctypes.c_int64]    # gen
        + [ctypes.c_char_p, ctypes.c_int64]    # est (masked)
        + [ctypes.c_char_p, ctypes.c_int64]    # est original
        + [ctypes.c_int64, ctypes.c_int64, ctypes.c_double]
        #   min_factor_len, min_intron_length, deadline
        + [ctypes.c_double, ctypes.c_int64, ctypes.c_double,
           ctypes.c_int64, ctypes.c_int64]
        #   complexity, max_site_diff, max_cov_diff, max_gap_diff, max_nf
        + [ctypes.c_int64] * 3                 # sp_est, sp_intron, sp_gen
        + [ctypes.c_void_p] * 4                # out off, f, polya, polyad
        + [ctypes.c_int64] * 2                 # cap_facts, cap_factors
        + [ctypes.c_void_p])                   # counts
    lib.est_process_cands.restype = ctypes.c_int64
    lib.est_process_cands.argtypes = (
        list(lib.est_process.argtypes)
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64])
    #   pre_off, pre_f, pre_n (caller-owned candidate arrays)
    lib.est_collect_noisy.restype = ctypes.c_int64
    lib.est_collect_noisy.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # cands
        + [ctypes.c_char_p, ctypes.c_int64]    # gen
        + [ctypes.c_char_p, ctypes.c_int64]    # est (masked)
        + [ctypes.c_char_p, ctypes.c_int64]    # est original
        + [ctypes.c_int64, ctypes.c_double]    # est_length, complexity
        + [ctypes.c_void_p, ctypes.c_int64]    # out records (9/i64), cap
        + [ctypes.c_void_p])                   # meta[2]: need, seq_id
    lib.epm_fill_noisy.restype = ctypes.c_int64
    lib.epm_fill_noisy.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64]      # gen
        + [ctypes.c_char_p, ctypes.c_int64]    # est (masked)
        + [ctypes.c_char_p, ctypes.c_int64]    # est original
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64])
    #   coords (4/i64), ok flags, n
    if hasattr(lib, "est_collect_gaps"):
        lib.est_collect_gaps.restype = ctypes.c_int64
        lib.est_collect_gaps.argtypes = (
            list(lib.est_process.argtypes)[:25]
            #   ... through sp_est/sp_intron/sp_gen (no out buffers)
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            #   pre_off, pre_f, pre_n
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
        #   gaps_out (9/i64 records), cap, meta[1]: need
        lib.est_collect_endpoints.restype = ctypes.c_int64
        lib.est_collect_endpoints.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # cands
            + [ctypes.c_char_p, ctypes.c_int64]    # gen
            + [ctypes.c_char_p, ctypes.c_int64]    # est (masked)
            + [ctypes.c_char_p, ctypes.c_int64]    # est original
            + [ctypes.c_int64]                     # est_length
            + [ctypes.c_void_p, ctypes.c_int64]    # out records (9/i64)
            + [ctypes.c_void_p])                   # meta[2]
        lib.epm_fill_endpoints.restype = ctypes.c_int64
        lib.epm_fill_endpoints.argtypes = (
            [ctypes.c_char_p, ctypes.c_int64]      # gen
            + [ctypes.c_char_p, ctypes.c_int64]    # est (masked)
            + [ctypes.c_char_p, ctypes.c_int64]    # est original
            + [ctypes.c_void_p, ctypes.c_int64]    # records, n
            + [ctypes.c_void_p, ctypes.c_void_p]   # ops (int8), nsteps
            + [ctypes.c_int64])                    # ops row stride
        lib.epm_fill_rb.restype = ctypes.c_int64
        lib.epm_fill_rb.argtypes = (
            [ctypes.c_char_p, ctypes.c_int64]      # gen
            + [ctypes.c_char_p, ctypes.c_int64]    # est (masked)
            + [ctypes.c_char_p, ctypes.c_int64]    # est original
            + [ctypes.c_void_p, ctypes.c_int64]    # records (9/i64), n
            + [ctypes.c_void_p] * 4                # minpp pospp minsp possp
            + [ctypes.c_int64])                    # stride
    if hasattr(lib, "est_collect_introns"):
        lib.est_collect_introns.restype = ctypes.c_int64
        lib.est_collect_introns.argtypes = (
            list(lib.est_process.argtypes)[:25]
            #   ... through sp_est/sp_intron/sp_gen (no out buffers)
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            #   pre_off, pre_f, pre_n
            + [ctypes.c_void_p, ctypes.c_int64]    # recs_out (13/i64), cap
            + [ctypes.c_void_p, ctypes.c_int64]    # arena, arena_cap
            + [ctypes.c_void_p])                   # meta[3]: need, arena,
        #   windows over the bound
        lib.ri_lookaside_set.restype = ctypes.c_int64
        lib.ri_lookaside_set.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64]      # records (13/i64), n
            + [ctypes.c_void_p]                    # window arena
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            #   sm0 (i64), ops (int8), nsteps (i64)
            + [ctypes.c_int64])                    # ops row stride
        lib.ri_lookaside_clear.restype = None
        lib.ri_lookaside_clear.argtypes = []
        lib.ri_dev_set_bounds.restype = None
        lib.ri_dev_set_bounds.argtypes = [ctypes.c_int64, ctypes.c_int64]
        #   the widest est and gen windows the gap collect emits
    lib.ep_nw_miss_get.restype = None
    lib.ep_nw_miss_get.argtypes = [ctypes.c_void_p]
    lib.ep_nw_miss_reset.restype = None
    lib.ep_nw_miss_reset.argtypes = []
    lib.unit_process.restype = ctypes.c_int64
    lib.unit_process.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64]        # tree text
        + [ctypes.c_void_p] * 12                 # tree arrays
        + [ctypes.c_void_p, ctypes.c_int64]      # alph_index256, alph_size
        + [ctypes.c_char_p, ctypes.c_int64]      # gen working seq
        + [ctypes.c_char_p, ctypes.c_int64]      # gen original seq
        + [ctypes.c_int64]                       # gen pref_N_length
        + [ctypes.c_void_p, ctypes.c_void_p]     # icfg, dcfg
        + [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]  # blob, emeta, n
        + [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p])  # out, cap, meta
    lib.worker_run.restype = ctypes.c_int64
    lib.worker_run.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64]        # tree text
        + [ctypes.c_void_p] * 12                 # tree arrays
        + [ctypes.c_void_p, ctypes.c_int64]      # alph_index256, alph_size
        + [ctypes.c_char_p, ctypes.c_int64]      # gen working seq
        + [ctypes.c_char_p, ctypes.c_int64]      # gen original seq
        + [ctypes.c_int64]                       # gen pref_N_length
        + [ctypes.c_void_p, ctypes.c_void_p]     # icfg, dcfg
        + [ctypes.c_char_p, ctypes.c_void_p,     # path, claim counter
           ctypes.c_int64, ctypes.c_int64]       # w, n
        + [ctypes.POINTER(ctypes.c_void_p),      # out: data buffer
           ctypes.POINTER(ctypes.c_void_p)])     # out: unit meta
    lib.up_buf_free.restype = None
    lib.up_buf_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """Return the loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_and_load()
        except Exception:
            _LIB = None
    return _LIB


# Reusable scratch buffers for the string-returning kernels.  The
# pipeline is single-threaded per process (parallelism is process-based),
# so one pair of char buffers plus an int64 out-array per process is
# safe and avoids a create_string_buffer round-trip per call.
_SCRATCH_CAP = 0
_SCRATCH = None


# Grow-only numpy scratch arrays with cached base pointers: numpy's
# ``arr.ctypes`` property builds a helper object per access (~µs), which
# dominates small native calls; each worker process is single-threaded so
# one keyed slot per use-site is safe.
_NP_SCRATCH = {}


def dp_census():
    """Host-computed DP cells per family since the last reset (the
    native counters in dp.c): the host side of the device share of DP
    cells that STEP 2's ``est-fact device flow:`` line reports.  Returns
    a dict, or None when the native library (or an old build) lacks the
    counters."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "dp_census_get"):
        return None
    import numpy as np
    lib.dp_census_get.restype = None
    lib.dp_census_get.argtypes = [ctypes.c_void_p]
    out = np.zeros(5, dtype=np.int64)
    lib.dp_census_get(out.ctypes.data)
    names = ("kband", "edit", "nw", "gap_align", "refine_borders")
    return {n: int(v) for n, v in zip(names, out)}


def dp_census_reset() -> None:
    lib = get_lib()
    if lib is not None and hasattr(lib, "dp_census_reset"):
        lib.dp_census_reset()


# ep_nw_miss's sites and kinds (dp.c)
NW_MISS_SITES = ("noisy_collect", "gaps_collect", "introns_collect",
                 "cascade")
NW_MISS_KINDS = ("head", "tail", "single_tail")


def ep_nw_misses():
    """The endpoint cut's host NW alignments that missed the tag-1/2
    memo since the last reset (dp.c ``ep_nw_miss``): {(site, kind):
    (alignments, cells)} over NW_MISS_SITES x NW_MISS_KINDS, and the
    memo's wipes under "wipes"."""
    import numpy as np
    lib = get_lib()
    out = np.zeros(len(NW_MISS_SITES) * len(NW_MISS_KINDS) * 2 + 1,
                   dtype=np.int64)
    lib.ep_nw_miss_get(out.ctypes.data)
    counts = out[:-1].reshape(len(NW_MISS_SITES), len(NW_MISS_KINDS), 2)
    res = {(site, kind): tuple(int(v) for v in counts[i, j])
           for i, site in enumerate(NW_MISS_SITES)
           for j, kind in enumerate(NW_MISS_KINDS)}
    res["wipes"] = int(out[-1])
    return res


def ep_nw_misses_reset() -> None:
    get_lib().ep_nw_miss_reset()


def np_scratch(key: str, n: int):
    """Return (int64 array of size >= n, base pointer)."""
    import numpy as np
    hit = _NP_SCRATCH.get(key)
    if hit is None or hit[0].size < n:
        arr = np.empty(max(n, 4096), dtype=np.int64)
        hit = (arr, arr.ctypes.data)
        _NP_SCRATCH[key] = hit
    return hit


def get_scratch(cap: int):
    """Return (est_buf, gen_buf, out8) char/int64 scratch with at least
    ``cap`` writable chars in each char buffer."""
    global _SCRATCH_CAP, _SCRATCH
    if cap >= _SCRATCH_CAP:
        _SCRATCH_CAP = max(2 * cap + 64, 1 << 12)
        _SCRATCH = (ctypes.create_string_buffer(_SCRATCH_CAP),
                    ctypes.create_string_buffer(_SCRATCH_CAP),
                    (ctypes.c_int64 * 8)())
    return _SCRATCH
