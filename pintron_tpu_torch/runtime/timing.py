"""Phase timers, wall-clock timeouts and resource logging.

Rebuild of the reference's observability layer:
* named interval timers with nested ("parallel") support
  (src/my_time.c, include/my_time.h:40-106);
* wall-clock timeouts used to abort per-EST factorization
  (my_time.h:100-106, compute-est-fact.c:241-286);
* event + memory checkpoints `description\\ttime\\tstatm` to
  `info-pid-<pid>.log` (src/util.c:221-268);
* getrusage summary at exit (util.c:184-208);
* the card's name and power limit, written beside every device time
  (``card_line``).
"""

from __future__ import annotations

import logging
import os
import resource
import subprocess
import time
from typing import Dict, Optional

log = logging.getLogger("pintron.timing")


class PhaseTimer:
    """Named interval timer (MYTIME_create_with_name / start / stop /
    LOG).  Accumulates across start/stop pairs like the reference."""

    def __init__(self, name: str):
        self.name = name
        self.accumulated = 0.0
        self._started: Optional[float] = None

    def start(self) -> "PhaseTimer":
        self._started = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._started is not None:
            self.accumulated += time.perf_counter() - self._started
            self._started = None
        return self.accumulated

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def log(self, level=logging.INFO):
        log.log(level, "Timer %s: %.6fs", self.name, self.accumulated)


class TimerRegistry:
    """Named timer set with nesting, like the reference's parallel
    timers (my_time.h:73-99)."""

    def __init__(self):
        self._timers: Dict[str, PhaseTimer] = {}

    def __getitem__(self, name: str) -> PhaseTimer:
        if name not in self._timers:
            self._timers[name] = PhaseTimer(name)
        return self._timers[name]

    def log_all(self):
        for t in self._timers.values():
            t.log()


class Timeout:
    """Wall-clock timeout (MYTIME_timeout_create/expired): the
    factorization retry ladder polls `expired` and re-seeds with longer
    factors when it fires."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.deadline = time.monotonic() + seconds if seconds > 0 else None

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline


def _statm() -> str:
    try:
        with open("/proc/self/statm") as f:
            return f.read().strip()
    except OSError:
        return ""


def log_info_extended(description: str, path: Optional[str] = None) -> None:
    """util.c:log_info_extended: `description\\tunix_time\\tstatm` appended
    to info-pid-<pid>.log (or `path`)."""
    fname = path or f"info-pid-{os.getpid()}.log"
    with open(fname, "a") as f:
        f.write(f"{description}\t{int(time.time())}\t{_statm()}\n")


def resource_usage_log(level=logging.INFO) -> None:
    """util.c:resource_usage_log: getrusage + statm summary."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    log.log(level, "user time: %.3fs  system time: %.3fs  maxrss: %d kB  "
            "statm: %s", ru.ru_utime, ru.ru_stime, ru.ru_maxrss, _statm())


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no GPU")
    return lines[0]
