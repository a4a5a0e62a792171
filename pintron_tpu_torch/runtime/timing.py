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
  (``card_line``);
* the span recorder (``span``, ``trace_on`` ... ``trace_take``): the
  port's named stretches of work for torch.profiler, and kept in memory
  with their parents, processes and threads while recording is on;
* a process's start-up (``startup``): from the process's start to its
  first locus, the span ``pintron_startup``.
"""

from __future__ import annotations

import functools
import itertools
import json
import logging
import os
import resource
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd.profiler import record_function

from pintron_tpu_torch import IMPORT_START

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


# ---- the span recorder -----------------------------------------------------
# ``span(name, **attrs)`` names a stretch of the port's work.  It always
# enters torch.profiler's ``record_function(name)``, so a CUPTI trace
# (``PINTRON_TORCH_PROFILE``, the benchmark's traced runs) shows it.
# While recording is on (``trace_on``) it is also kept in this process's
# memory as a ``Span``: times on time.monotonic(), whose CLOCK_MONOTONIC
# is one clock for every process of the machine (the benchmark lays the
# CUPTI timeline onto it), and the innermost span open in this thread
# as its parent.  Work handed to another thread names its caller's open
# span as parent through ``bind``.  Nothing is written while the port
# runs: ``trace_take`` hands the kept spans over.  A forked child starts
# with none kept and the open stack it inherited, and sends its own back
# for the parent's ``trace_add``.  With recording off a span costs one
# test of the flag beyond its record_function.

PROFILE_ENV = "PINTRON_TORCH_PROFILE"


class Span(NamedTuple):
    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    pid: int
    thread: int
    attrs: dict


_RECORDING = False
# the spans kept, each a list in Span's order: opening one allocates
# after its start is read and closing one nothing after its end is read,
# so a collection that the recorder sets off falls inside a span, not in
# a gap between two
_KEPT: List[list] = []
_PID = os.getpid()
_IDS = itertools.count(1)
_LOCAL = threading.local()
_ID = 3   # the id's place in a kept span


def _after_fork() -> None:
    global _KEPT, _PID, _STARTED, _STARTUP
    _KEPT = []
    _PID = os.getpid()
    # a forked child's start-up is its parent's, not its own
    _STARTED, _STARTUP = True, None


os.register_at_fork(after_in_child=_after_fork)


def _stack() -> list:
    """This thread's open spans (the recorded ones), innermost last."""
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def _new_id() -> int:
    # unique across the processes of a run: the pid in the high bits
    return (_PID << 32) | next(_IDS)


class span(record_function):
    """``with span(name, **attrs):`` or ``@span(name, **attrs)`` (a
    fresh span each call).  ``attrs`` are kept with the span; ``note``
    adds to the innermost open one."""

    _rec = None   # the kept span's list while it is recorded

    def __init__(self, name: str, **attrs):
        super().__init__(name)
        self.attrs = attrs

    @property
    def id(self) -> Optional[int]:
        """The span's id once it was opened with recording on."""
        return self._rec[_ID] if self._rec is not None else None

    def __call__(self, fn):
        name, attrs, kind = self.name, self.attrs, type(self)

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with kind(name, **attrs):
                return fn(*args, **kwargs)
        return inner

    def _open(self) -> None:
        t = time.monotonic()
        st = _stack()
        self._rec = [self.name, t, 0.0, _new_id(),
                     st[-1]._rec[_ID] if st else None, _PID,
                     threading.get_native_id(), self.attrs]
        st.append(self)

    def _close(self) -> None:
        self._rec[2] = time.monotonic()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        _KEPT.append(self._rec)

    # the clock is read outside the record_function, so that a span
    # holds its own instrumentation, as its parent does
    def __enter__(self):
        if _RECORDING:
            self._open()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._rec is not None:
                self._close()


class timed_span(span):
    """A span that always reads the clock, once at each end
    (``start``, ``end``), for a caller that keeps the time as well."""

    def __enter__(self):
        if _RECORDING:
            self._open()
            self.start = self._rec[1]
        else:
            self.start = time.monotonic()
        return record_function.__enter__(self)

    def __exit__(self, *exc):
        try:
            return record_function.__exit__(self, *exc)
        finally:
            if self._rec is not None:
                self._close()
                self.end = self._rec[2]
            else:
                self.end = time.monotonic()


def recording() -> bool:
    return _RECORDING


def trace_on() -> None:
    global _RECORDING
    _RECORDING = True


def trace_off() -> None:
    global _RECORDING
    _RECORDING = False


def trace_take() -> List[Span]:
    """The spans kept so far in this process (and added from its
    children); clears them."""
    global _KEPT
    kept, _KEPT = _KEPT, []
    return [Span(*s) for s in kept]


def trace_add(spans) -> None:
    """Fold in the spans a child process sent back."""
    _KEPT.extend(list(s) for s in spans)


def record(name: str, start: float, end: float,
           parent: Optional[int] = None, **attrs) -> Optional[int]:
    """Keep a span whose ends were read elsewhere (one that crosses
    threads, as a service request from its arrival to its reply); returns
    its id, or None with recording off."""
    if not _RECORDING:
        return None
    sid = _new_id()
    _KEPT.append([name, start, end, sid, parent, _PID,
                  threading.get_native_id(), attrs])
    return sid


def note(**attrs) -> None:
    """Add ``attrs`` to the innermost span open in this thread (with
    recording on)."""
    if _RECORDING:
        st = _stack()
        if st:
            st[-1].attrs.update(attrs)


def bind(fn):
    """``fn`` made to run, in whichever thread calls it, under the span
    open here now (with recording on; else ``fn`` itself)."""
    if not _RECORDING:
        return fn
    st = _stack()
    if not st:
        return fn
    parent = st[-1]

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        mine = _stack()
        mine.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            mine.remove(parent)
    return bound


def write_spans(directory: str, spans) -> str:
    """``spans`` as ``<directory>/spans-<pid>.jsonl``, a span a line;
    returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"spans-{os.getpid()}.jsonl")
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s._asdict()) + "\n")
    return path


# ---- a process's start-up ------------------------------------------------
# The pipeline calls ``startup(t)`` as a process's first locus opens at
# ``t``: the process's start-up runs from its start (the OS's record of
# it, else the package's import) to ``t``.  With recording on at that
# call it is kept as the span ``pintron_startup`` (attrs: ``package_s``,
# the package's import with its torch, timed from the package's first
# line until this module, which holds torch, is loaded; ``pid``).  Only
# the first call keeps anything, recording on or off, and a forked child
# never does.

_IMPORTED = time.monotonic()   # torch and this module loaded
_STARTED = False               # a locus opened here, or this is a fork
_STARTUP: Optional[tuple] = None   # (start, end) once it did


def _process_start() -> float:
    """This process's start on time.monotonic(): ``/proc/self/stat``'s
    start time against ``/proc/uptime``, both truncated, taken at the
    latest they allow, so never before the true start; the package's
    import where they cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        now = time.monotonic()
        least_age = up - (ticks + 1) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return IMPORT_START
    return min(IMPORT_START, now - max(0.0, least_age))


def startup(end: float) -> None:
    """At a process's first locus, opened at ``end``: keep its start-up,
    and record it as ``pintron_startup`` with recording on."""
    global _STARTED, _STARTUP
    if _STARTED:
        return
    _STARTED = True
    _STARTUP = (_process_start(), end)
    record("pintron_startup", *_STARTUP, package_s=_IMPORTED - IMPORT_START,
           pid=_PID)


def startup_seconds() -> Optional[float]:
    """This process's start-up in seconds once its first locus opened,
    else None."""
    return None if _STARTUP is None else _STARTUP[1] - _STARTUP[0]
