"""The port's kernels' device time, in ms a locus: ``kband_kernel``,
``nw_kernel``, ``gap_kernel``, ``rowmin_kernel``, ``edit_score_kernel``
and ``pwm_kernel`` by name, from CUPTI in the process that owns the
card (the device service, where there is one), in the window."""

KERNELS = ("kband_kernel", "nw_kernel", "gap_kernel", "rowmin_kernel",
           "edit_score_kernel", "pwm_kernel")


def read(ctx):
    tl = ctx["timeline"]
    if not tl or not ctx["runs"]:
        return None
    lo, hi = ctx["window"]
    secs = sum(min(e, hi) - max(s, lo) for s, e, name in tl["device"]
               if e > lo and s < hi and any(k in name for k in KERNELS))
    return 1000.0 * secs / len(ctx["runs"]) if secs > 0 else None
