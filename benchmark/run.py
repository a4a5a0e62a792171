"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload CELL --seed N --seconds S \
        --trace 0|1

Measures ``pintron_tpu_torch`` (STEPs 1-8 per locus on one CUDA card)
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``, each number the check compared beside its limit.
Exits non-zero, printing no result, without enough CUDA devices or
when ``jax``, ``jaxlib``, ``flax`` or ``pintron_tpu`` was loaded.
``benchmark/harness/runner.py`` says what a run does.
"""

import os
import sys
import time

T_START = time.monotonic()


def _age() -> float:
    """Seconds since this process started (/proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    AGE = _age()
    # the checkout's root, not this directory, is where imports resolve
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # count the cards without a CUDA context: STEP 2's workers fork
    # from this process in the service's cells
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    from benchmark.harness.cli import main
    sys.exit(main(sys.argv[1:], T_START, AGE))
