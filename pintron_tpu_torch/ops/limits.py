"""What the offload reads of the kernels without loading them: their
size limits and the launch counts.  Nothing here imports torch, so a
service client (``PINTRON_TORCH_SERVICE``), which routes its problems
by these limits and reports these counts but launches nothing, never
loads torch.

``KMAX`` and ``MAX_WIDTH`` are the limits of ``ops/kband.py`` and
``ops/traceback.py``, which take them from here.  ``LAUNCHES`` counts
kernel launches per kernel, for the wrappers of ``ops/kband.py``,
``ops/traceback.py`` and ``ops/pwm.py`` (each ``kband.LAUNCHES``, the
same dict).  Launches come from the offload's executor thread and its
dispatch threads, so the count is taken under a lock.
"""

from __future__ import annotations

import threading

# the widest band kband_kernel takes: W = 2*k_max+1 <= 33 cells a lane
# of 32 lanes (csrc/kband.cu), the reference's widest budget route
KMAX = 512

# the widest DP row (text window, gen window) the rowmin, nw and gap
# kernels are given: the offload leaves wider problems to the host DPs
# (its evaluated masks), as the JAX flow does, so that the two flows
# count the same device problems
MAX_WIDTH = 16384

LAUNCHES = {"kband": 0, "edit_score": 0, "nw": 0, "gap": 0,
            "rowmin": 0, "pwm": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
