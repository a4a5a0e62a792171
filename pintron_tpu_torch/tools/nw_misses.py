"""Where STEP 2's host NW cells come from: the endpoint cut's
alignments that miss the memo the device flow pre-fills.

    python -m pintron_tpu_torch.tools.nw_misses \
        [--device cuda|cuda:N|cpu] [case ...]

Each case runs STEP 2's device flow twice through
``check_stage2.check_case`` (fresh memo, byte-checked against the
goldens): with every family on the card, and with the NW family on the
host DP (``PINTRON_DEVICE_NW=0``).  In the first run the native
counters of ``ep_handle_endpoints``'s memo misses
(``native.ep_nw_misses``) are read at the start of each round's NW
phase (``est_fact._offload_endpoints``) and at the end, so each round
shows the NW problems its phase collected (on the card, byte-equal,
too wide) and the host NW alignments that missed the tag-1/2 memo
afterwards, by call site (the noisy, rb and gap collects' cascade
replays, the cascade itself) and kind (the head, the tail of a
multi-factor candidate, the tail of a one-factor candidate), with their
cells, and the memo's wipes, in all and after the phase's fill (a wipe
then drops the pre-filled results).  The second run gives the host NW cells
with no NW problem on the card.  Counts are exact on every device.

The default cases are the four loci with NW problems over the JAX
package's traceback bound: 788, issue-2, issue-13 and gtf5.  One line
a round and a case; the last line is the whole result as JSON.  The
exit code is 1 when a run fails its byte check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CASES = ("test-788", "test-issue-2", "test-issue-13", "test_gtf5")


def _delta(now: dict, then: dict) -> dict:
    return {k: (tuple(a - b for a, b in zip(v, then[k]))
                if isinstance(v, tuple) else v - then[k])
            for k, v in now.items()}


def _round_entry(misses: dict, stats: dict) -> dict:
    """One round: its NW problems and its misses {site: {kind: [n,
    cells]}} (zeros left out)."""
    by_site = {}
    for key, counts in misses.items():
        if key != "wipes" and counts[0]:
            by_site.setdefault(key[0], {})[key[1]] = list(counts)
    return {"nw_problems": stats["nw_problems"],
            "nw_collected": stats["nw_collected"],
            "nw_too_wide": stats["nw_too_wide"],
            "misses": by_site, "miss_cells": sum(
                v[1] for site in by_site.values() for v in site.values()),
            "wipes": misses["wipes"]}


def census(case: str, device="cuda") -> dict:
    """The two runs of one case: {"case", "status", "rounds" (the
    forced run's, one entry a round), "host_nw_cells" (the forced
    run's), "nw_at_0_host_nw_cells", "differs"}."""
    from pintron_tpu_torch import native
    from pintron_tpu_torch.ops import offload
    from pintron_tpu_torch.stages import est_fact
    from pintron_tpu_torch.tools.check_stage2 import check_case

    marks = []
    filled = []     # the memo's wipes when each round's NW fill ended
    collected = [0]
    offload_endpoints = est_fact._offload_endpoints

    def mark():
        marks.append((native.ep_nw_misses(),
                      {"nw_problems": offload.STATS["nw_problems"],
                       "nw_too_wide": offload.STATS["nw_too_wide"],
                       "nw_collected": collected[0]}))

    def counted_eval_nw(problems):
        collected[0] += len(problems)
        return eval_nw(problems)

    def round_start(*args, **kw):
        mark()
        try:
            return offload_endpoints(*args, **kw)
        finally:
            filled.append(native.ep_nw_misses()["wipes"])

    eval_nw = offload.eval_nw
    native.ep_nw_misses_reset()
    est_fact._offload_endpoints = round_start
    offload.eval_nw = counted_eval_nw
    try:
        forced = check_case(case, device)
        mark()
    finally:
        est_fact._offload_endpoints = offload_endpoints
        offload.eval_nw = eval_nw
    res = {"case": case, "status": forced["status"],
           "differs": forced.get("differs", [])}
    if forced["status"] == "SKIP":
        return res
    res["rounds"] = [
        dict(_round_entry(_delta(m1, m0), _delta(s1, s0)),
             wipes_after_fill=m1["wipes"] - w)
        for (m0, s0), (m1, s1), w in zip(marks, marks[1:], filled)]
    res["host_nw_cells"] = forced["host_cells"].get("nw", 0)
    old = os.environ.get("PINTRON_DEVICE_NW")
    os.environ["PINTRON_DEVICE_NW"] = "0"
    try:
        at0 = check_case(case, device)
    finally:
        if old is None:
            os.environ.pop("PINTRON_DEVICE_NW")
        else:
            os.environ["PINTRON_DEVICE_NW"] = old
    res["nw_at_0_host_nw_cells"] = at0["host_cells"].get("nw", 0)
    if at0["status"] != "OK":
        res["status"] = "FAIL"
        res["differs"] = res["differs"] + [f"NW at 0: {d}"
                                           for d in at0["differs"]]
    return res


def round_lines(res: dict) -> list:
    lines = []
    for r, rnd in enumerate(res.get("rounds", []), 1):
        sites = "; ".join(
            f"{site} " + ", ".join(f"{kind} {n} ({cells} cells)"
                                   for kind, (n, cells) in kinds.items())
            for site, kinds in rnd["misses"].items()) or "none"
        lines.append(
            f"{res['case']} round {r}: NW collected {rnd['nw_collected']}, "
            f"on the card {rnd['nw_problems']}, too wide "
            f"{rnd['nw_too_wide']}; memo misses {sites}; "
            f"{rnd['miss_cells']} cells; memo wipes {rnd['wipes']} "
            f"({rnd['wipes_after_fill']} after the NW fill)")
    if "host_nw_cells" in res:
        lines.append(f"{res['case']}: host NW cells {res['host_nw_cells']} "
                     f"forced, {res['nw_at_0_host_nw_cells']} with NW at 0; "
                     f"{res['status']}")
    else:
        lines.append(f"{res['case']}: {res['status']}")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cases", nargs="*", help=f"golden cases (default: "
                   f"{' '.join(CASES)})")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default), cuda:N or cpu")
    args = p.parse_args(argv)
    from pintron_tpu_torch.ops import offload
    offload.check_card(args.device)
    results = []
    for case in args.cases or CASES:
        res = census(case, args.device)
        for line in round_lines(res):
            print(line, flush=True)
        results.append(res)
    print(json.dumps(results, sort_keys=True))
    return 1 if any(r["status"] == "FAIL" for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
