"""Stage 3: minimum factorization agreement (set cover).

Rebuild of min-factorization (main-min-factorization.c, color_matrix.c,
simplify_matrix.c, min_factorization.c, io-factorizations.c).  Reads
`raw-multifasta-out.txt`-format factorizations, builds the EST x
genomic-window binary matrix, simplifies with forcing rules, solves the
exact minimum-cardinality cover by increasing-size combination search,
and emits each EST's best covered factorization (out-agree.txt format).

Factorization bit-rows are kept as Python ints (bitmask per genomic
window) — the combination search is pure bit algebra.
"""

from __future__ import annotations

from typing import List, Optional, TextIO, Tuple

from pintron_tpu_torch.factorize.types import Factor, Factorization


class EstFactorizations:
    def __init__(self, est_id: str):
        self.est_id = est_id
        self.factorizations: List[Factorization] = []
        self.polya: List[bool] = []
        self.polyadenil: List[bool] = []
        self.bin_factorizations: List[int] = []


def read_factorizations(fh: TextIO) -> List[EstFactorizations]:
    """io-factorizations.c:194-235: consecutive records with the same id
    are grouped into one EST."""
    ests: List[EstFactorizations] = []
    current: Optional[EstFactorizations] = None
    fact: Optional[Factorization] = None
    polya = 0
    polyadenil = 0

    def close_fact():
        nonlocal fact, polya, polyadenil
        if fact is not None:
            current.factorizations.append(fact)
            current.polya.append(polya == 1)
            current.polyadenil.append(polyadenil == 1)
        fact = None
        polya = 0
        polyadenil = 0

    for raw in fh:
        line = raw.rstrip("\n")
        if line.startswith(">"):
            est_id = line[1:]
            close_fact()
            if current is None or current.est_id != est_id:
                current = EstFactorizations(est_id)
                ests.append(current)
            fact = []
            polya = 0
            polyadenil = 0
        elif line.startswith("#"):
            if line.startswith("#polya="):
                try:
                    polya = int(line[7:].split()[0])
                except ValueError:
                    pass
            elif line.startswith("#polyad="):
                try:
                    polyadenil = int(line[8:].split()[0])
                except ValueError:
                    pass
        elif line and line[0].isdigit() and fact is not None:
            parts = line.split()
            if len(parts) >= 4:
                try:
                    e1, e2, g1, g2 = (int(parts[0]), int(parts[1]),
                                      int(parts[2]), int(parts[3]))
                except ValueError:
                    continue
                if e1 == 0:
                    e1 = 1
                if e2 == 0:
                    e2 = 1
                fact.append(Factor(e1, e2, g1, g2))
    close_fact()
    return ests


def update_windows(windows: List[Tuple[int, int]], factor: Factor
                   ) -> List[Tuple[int, int]]:
    """color_matrix.c:124-324: maintain a sorted list of merged genomic
    windows."""
    fs, fe = factor.gen_start, factor.gen_end
    if not windows:
        windows.append((fs, fe))
        return windows

    # find the window where the factor start falls (windows are kept
    # sorted and disjoint, so the linear "first k with fs <= we" scan is
    # a bisection on the window ends)
    import bisect
    k = bisect.bisect_left(windows, fs, key=lambda w: w[1])
    if k >= len(windows):
        windows.append((fs, fe))
        return windows
    i_start = k
    start_inside = fs >= windows[k][0]

    k = bisect.bisect_left(windows, fe, key=lambda w: w[1])
    if k < len(windows):
        i_end = k
        end_inside = fe >= windows[k][0]
    else:
        i_end = None
        end_inside = False

    if i_end is not None and not end_inside and i_end == 0:
        windows.insert(0, (fs, fe))
        return windows

    if not start_inside and not end_inside:
        if i_end is not None and i_start == i_end:
            # factor lies between two windows without overlap
            windows.insert(i_start, (fs, fe))
        else:
            # factor covers one or more windows, extending both sides
            end_ws = windows[i_end][0] if i_end is not None else None
            windows[i_start] = (fs, fe)
            k = i_start + 1
            while k < len(windows):
                if end_ws is not None and windows[k][0] >= end_ws:
                    break
                del windows[k]
    else:
        if start_inside:
            if end_inside:
                if i_start != i_end:
                    end_we = windows[i_end][1]
                    end_ws = windows[i_end][0]
                    windows[i_start] = (windows[i_start][0], end_we)
                    k = i_start + 1
                    while k < len(windows):
                        if windows[k][0] > end_ws:
                            break
                        del windows[k]
            else:
                end_ws = windows[i_end][0] if i_end is not None else None
                windows[i_start] = (windows[i_start][0], fe)
                k = i_start + 1
                while k < len(windows):
                    if i_end is not None and windows[k][0] >= end_ws:
                        break
                    del windows[k]
        else:
            end_we = windows[i_end][1]
            end_ws = windows[i_end][0]
            windows[i_start] = (fs, end_we)
            k = i_start + 1
            while k < len(windows):
                if windows[k][0] > end_ws:
                    break
                del windows[k]
    return windows


def windows_list_create(ests: List[EstFactorizations]
                        ) -> List[Tuple[int, int]]:
    windows: List[Tuple[int, int]] = []
    for est in ests:
        for fact in est.factorizations:
            for f in fact:
                update_windows(windows, f)
    return windows


def color_matrix_create(ests: List[EstFactorizations]
                        ) -> List[Tuple[int, int]]:
    """color_matrix_create in windows mode (main-min-factorization.c:58)."""
    import bisect
    windows = windows_list_create(ests)
    nw = len(windows)
    for est in ests:
        for fact in est.factorizations:
            bv = 0
            for f in fact:
                # first window with we >= gen_end; windows are sorted
                # and disjoint, so no later window can contain either —
                # the reference's fallback is the last index
                k = bisect.bisect_left(windows, f.gen_end,
                                       key=lambda w: w[1])
                if k < nw and windows[k][0] <= f.gen_start \
                        and windows[k][1] >= f.gen_end:
                    pos = k
                else:
                    pos = nw - 1
                bv |= 1 << pos
            est.bin_factorizations.append(bv)
    return windows


class Simplification:
    def __init__(self, n_factors: int, n_ests: int):
        self.factors_used = 0       # bitmask
        self.factors_not_used = 0
        self.ests_ok = 0
        self.n_factors = n_factors
        self.n_ests = n_ests


def simplification(ests: List[EstFactorizations], n_factors: int
                   ) -> Simplification:
    """simplify_matrix.c:137-250 fixpoint of forcing rules."""
    p = Simplification(n_factors, len(ests))
    mask = (1 << n_factors) - 1
    while True:
        el_column = False
        for est in ests:
            # simplify_column: factor present in EVERY factorization of
            # this EST -> surely used.  AND-reduce the rows: a bit set
            # in every row and not yet used is newly forced (all() over
            # an empty row list is vacuously true, like the reference).
            common = mask
            for bv in est.bin_factorizations:
                common &= bv
            new = common & ~p.factors_used & mask
            if new:
                p.factors_used |= new
                elim = True
            else:
                elim = False
            el_column = elim  # reference keeps only the LAST est's flag

        el_row = False
        for n_est, est in enumerate(ests):
            elim = False
            for bv in est.bin_factorizations:
                if bv & ~p.factors_used == 0:
                    if not (p.ests_ok >> n_est & 1):
                        p.ests_ok |= 1 << n_est
                        elim = True
            el_row = elim

        # columns with no bit set in any factorization of any
        # still-unsatisfied EST are surely unused (for a column already
        # in factors_used the per-est check never runs in the
        # reference, leaving all_zero true — but such columns are
        # filtered right after, so the OR over active rows is exact)
        active_or = 0
        for n_est, est in enumerate(ests):
            if not (p.ests_ok >> n_est & 1):
                for bv in est.bin_factorizations:
                    active_or |= bv
        new_nu = ~active_or & ~p.factors_used & ~p.factors_not_used & mask
        el_col_zero = bool(new_nu)
        p.factors_not_used |= new_nu

        if not (el_column or el_row or el_col_zero):
            break
    return p


def min_fact(simplified_rows: List[List[int]], n_cols: int) -> int:
    """min_factorization.c:475-500 + create_combinations: exact cover by
    increasing cardinality, lexicographic combination order."""
    def evaluate(comb: int) -> bool:
        for rows in simplified_rows:
            if not any(bv & ~comb == 0 for bv in rows):
                return False
        return True

    def combinations(s: int, k: int, comb: int) -> Optional[int]:
        if k == 1:
            for cont in range(s, n_cols):
                c2 = comb | (1 << cont)
                if evaluate(c2):
                    return c2
            return None
        for cont in range(s, n_cols - (k - 1)):
            res = combinations(cont + 1, k - 1, comb | (1 << cont))
            if res is not None:
                return res
        return None

    # start = max over ESTs of min factors per factorization
    start = 0
    for rows in simplified_rows:
        m = 0
        for bv in rows:
            c = bin(bv).count("1")
            if m == 0 or c < m:
                m = c
        if m > start:
            start = m

    while True:
        res = combinations(0, start, 0)
        if res is not None:
            return res
        start += 1


def run_min_factorization(in_fh: TextIO, out_fh: TextIO) -> None:
    """The stage entry point: stdin -> stdout equivalent."""
    ests = read_factorizations(in_fh)
    windows = color_matrix_create(ests)
    n_factors = len(windows)
    psimp = simplification(ests, n_factors)

    all_ok = all(psimp.ests_ok >> k & 1 for k in range(len(ests)))
    if not all_ok:
        # build the simplified matrix: unresolved ESTs x unresolved columns
        free_cols = [i for i in range(n_factors)
                     if not (psimp.factors_used >> i & 1)
                     and not (psimp.factors_not_used >> i & 1)]
        col_map = {c: k for k, c in enumerate(free_cols)}
        simplified_rows = []
        for n_est, est in enumerate(ests):
            if psimp.ests_ok >> n_est & 1:
                continue
            rows = []
            for bv in est.bin_factorizations:
                nb = 0
                for c in free_cols:
                    if bv >> c & 1:
                        nb |= 1 << col_map[c]
                rows.append(nb)
            simplified_rows.append(rows)
        result = min_fact(simplified_rows, len(free_cols))
        # inglobe: merge the result back into factors_used
        for k, c in enumerate(free_cols):
            if result >> k & 1:
                psimp.factors_used |= 1 << c

    # print best covered factorization per EST
    # (min_factorization.c:326-384)
    for est in ests:
        best_factorization = 0
        best_coverage = 0
        best_n_exons = 1 << 62
        for idx, (bv, fact) in enumerate(zip(est.bin_factorizations,
                                             est.factorizations), start=1):
            if bv & ~psimp.factors_used == 0:
                coverage = sum(f.est_end + 1 - f.est_start for f in fact)
                n_exons = len(fact)
                if (best_coverage < coverage
                        or (best_coverage == coverage
                            and best_n_exons > n_exons)):
                    best_coverage = coverage
                    best_n_exons = n_exons
                    best_factorization = idx
        out_fh.write(f">{est.est_id}\n")
        if best_factorization:
            fact = est.factorizations[best_factorization - 1]
            polya = est.polya[best_factorization - 1]
            polyadenil = est.polyadenil[best_factorization - 1]
            out_fh.write(f"#polya={1 if polya else 0}\n"
                         f"#polyad={1 if polyadenil else 0}\n")
            for f in fact:
                out_fh.write(f"{f.est_start}\t {f.est_end}\t "
                             f"{f.gen_start}\t {f.gen_end}\n")


def run_min_factorization_files(in_path: str, out_path: str) -> None:
    """STEP 3 over its files: ``raw-multifasta-out.txt`` in,
    ``out-agree.txt`` out (the call the guard server makes by name)."""
    with open(in_path) as fin, open(out_path, "w") as fout:
        run_min_factorization(fin, fout)
