"""The card's share of STEP 2's DP cells, in %: the device cells (the
offload's counter, read at the benchmark's span around STEP 2, fork
workers' included) over the device cells and the host DP cells (the
native census on the ``est-fact device flow:`` line), summed over the
window's loci.  An exact count."""


def read(ctx):
    dev = host = 0
    for r in ctx["runs"]:
        if r["step2_device_cells"] is None or r["flow"] is None:
            continue
        dev += r["step2_device_cells"]
        host += sum(r["flow"]["host_dp_cells"].values())
    return 100.0 * dev / (dev + host) if dev + host else None
