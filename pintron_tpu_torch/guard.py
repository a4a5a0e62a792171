"""The pipeline's resource guard (reference pintron.py:878-906: a stage
under ``ulimit -t``/``-v``, and its wall-clock watchdog).

``run_guarded`` runs a stage in a child process with RLIMIT_CPU (and
RLIMIT_AS growth when a memory guard is set) and a wall-clock watchdog
in the caller.  On a timeout or a non-zero exit it removes the stage's
declared artifacts, so that a later ``--resume`` cannot pick up a
truncated checkpoint, and raises.  The child comes from one of two
places:

  * a stage named by module, function and arguments (``served``: STEP
    3) is forked by this process's guard server, ``python -m
    pintron_tpu_torch.guard``, started by exec (not by fork) at the
    first pipeline call.  The server imports the stage's module and
    never torch, so each fork copies a small image, where a fork of the
    process that maps torch and the CUDA context cost 142-250 ms a
    locus on the H100's host (PERF.md);
  * any other stage (``--device host``'s STEPs 2 and 4) is forked from
    the caller, and so is a served stage when no server can be had.

The server serves one request at a time over a pair of pipes, a JSON
line each way, and hands each to a child it forked after the last
reply, so that no fork lies on the caller's path.  A request is
``{"module", "function", "args", "cpu_s", "mem_mb"}``; the server
answers ``{"pid"}`` once the child has it and
``{"pid", "exit", "start", "end"}`` when the child has ended: its exit
code (negative for a signal) and its own times on ``time.monotonic()``
around the stage, or nulls where it never reached the stage.  The
server exits when its request pipe closes.  A process owns the server
it started, and a process forked later starts its own.  A server found
dead is restarted once a process; after that, or where none can be
started, a served stage is forked from the caller.  ``STATS`` counts
each.

The server runs this module, so it imports nothing of torch at the top.
"""

from __future__ import annotations

import atexit
import importlib
import json
import os
import resource
import select
import signal
import subprocess
import sys
import time
import traceback

# how often the guard server engaged in this process (a fork inherits
# the counts)
STATS = {"served": 0, "server_starts": 0, "restarts": 0,
         "fallback_forks": 0}

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TERM_GRACE_S = 10.0   # the watchdog's wait after its SIGTERM


def set_limits(cpu_s: int, mem_mb: int) -> None:
    """The child's own limits: RLIMIT_CPU of ``cpu_s`` (hard 10 s more)
    and, with ``mem_mb`` > 0, RLIMIT_AS at what the child maps now plus
    ``mem_mb``: a cap on growth, since a child forked from a process
    with torch loaded inherits gigabytes of mappings the reference's
    fresh C process never had."""
    try:
        resource.setrlimit(resource.RLIMIT_CPU, (cpu_s, cpu_s + 10))
        if mem_mb > 0:
            cur = 0
            try:
                with open("/proc/self/statm") as f:
                    cur = int(f.read().split()[0]) * resource.getpagesize()
            except (OSError, ValueError, IndexError):
                pass
            mem = cur + mem_mb * 1024 * 1024
            resource.setrlimit(resource.RLIMIT_AS, (mem, mem))
    except (ValueError, OSError):
        pass


def _send(fd: int, data: bytes) -> None:
    while data:
        data = data[os.write(fd, data):]


def _write(fd: int, obj) -> None:
    _send(fd, (json.dumps(obj) + "\n").encode())


def _kill(pid, sig=signal.SIGKILL) -> None:
    if pid is not None:
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            pass


# ---- the server ------------------------------------------------------------

def _spare_child(closing: tuple, request: int, report: int) -> None:
    """A child forked ahead of its request: it waits for the request on
    ``request`` and acknowledges it on ``report``, then sets the limits,
    runs the stage, writes its times on ``report`` and exits with the
    code ``multiprocessing`` gives a Process; never returns."""
    for fd in closing:
        os.close(fd)
    code = 1
    try:
        data = b""
        while chunk := os.read(request, 65536):
            data += chunk
        if not data:   # the server ended before a request came
            code = 0
            return
        os.write(report, b"+")   # taken: the server answers "started"
        signal.signal(signal.SIGINT, signal.default_int_handler)
        req = json.loads(data)
        set_limits(req["cpu_s"], req["mem_mb"])
        fn = getattr(importlib.import_module(req["module"]),
                     req["function"])
        start = time.monotonic()
        try:
            fn(*req["args"])
        finally:
            _write(report, [start, time.monotonic()])
        code = 0
    except SystemExit as e:
        if e.code is None:
            code = 0
        elif isinstance(e.code, int):
            code = e.code
        else:
            sys.stderr.write(f"{e.code}\n")
    except BaseException:   # noqa: BLE001 - the child's exit reports it
        traceback.print_exc()
    finally:
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        finally:
            os._exit(code)


def _fork_spare(closing: tuple):
    """A spare child: (pid, its request pipe, its report pipe)."""
    req_r, req_w = os.pipe()
    rep_r, rep_w = os.pipe()
    pid = os.fork()
    if pid == 0:
        _spare_child(closing + (req_w, rep_r), req_r, rep_w)
    os.close(req_r)
    os.close(rep_w)
    return pid, req_w, rep_r


def _hand(spare, request: bytes, closing: tuple):
    """Give ``request`` to the spare child, or to a fresh one where it
    died while it waited; returns the spare that acknowledged it."""
    for _ in range(2):
        pid, req_w, report = spare
        try:
            _send(req_w, request)
        except BrokenPipeError:
            pass
        os.close(req_w)
        if os.read(report, 1) == b"+":
            return spare
        os.close(report)
        os.waitpid(pid, 0)
        spare = _fork_spare(closing)
    raise RuntimeError("no child of the guard server took the request")


def serve(requests: int, replies: int) -> None:
    """Answer the requests read from the pipe ``requests`` on the pipe
    ``replies``, one at a time, until the request pipe closes.  Each
    request goes to a spare child forked after the last reply, so that
    the fork is off the caller's path."""
    spare = _fork_spare((requests, replies))
    buf = b""
    while True:
        while b"\n" not in buf:
            chunk = os.read(requests, 65536)
            if not chunk:
                os.close(spare[1])
                os.close(spare[2])
                os.waitpid(spare[0], 0)
                return
            buf += chunk
        line, buf = buf.split(b"\n", 1)
        spare = _hand(spare, line, (requests, replies))
        pid, report = spare[0], spare[2]
        _write(replies, {"pid": pid})
        _, status = os.waitpid(pid, 0)
        os.set_blocking(report, False)
        try:
            times = json.loads(os.read(report, 4096) or b"null")
        except (BlockingIOError, ValueError):
            times = None
        os.close(report)
        start, end = times or (None, None)
        _write(replies, {"pid": pid,
                         "exit": os.waitstatus_to_exitcode(status),
                         "start": start, "end": end})
        try:
            # here, so that every later child finds it imported
            importlib.import_module(json.loads(line)["module"])
        except Exception:   # noqa: BLE001 - a child imports it again
            pass            # and reports the error in its exit
        spare = _fork_spare((requests, replies))


def main() -> int:
    # Ctrl-C reaches the caller's whole process group: the caller stops
    # the stage, and the server ends with its request pipe
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    requests, replies = os.dup(0), os.dup(1)
    null = os.open(os.devnull, os.O_RDONLY)
    os.dup2(null, 0)
    os.close(null)
    os.dup2(2, 1)   # what a stage prints goes to stderr, not the replies
    serve(requests, replies)
    return 0


# ---- the caller's side -----------------------------------------------------

class _Server:
    """A process's guard server: started by exec, restarted once."""

    def __init__(self):
        self.owner = os.getpid()
        self.proc = None
        self.starts = 0
        self.failed = False
        self._buf = b""
        atexit.register(self.close)

    def live(self) -> bool:
        """Whether a server runs, started (or restarted once) here if
        need be; returns without waiting for it to be ready."""
        if self.proc is not None and self.proc.poll() is None:
            return True
        if self.failed or self.starts >= 2:
            return False
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "pintron_tpu_torch.guard"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
                bufsize=0)
        except OSError:
            self.failed = True
            return False
        if self.proc is not None:
            self.proc.stdin.close()
            self.proc.stdout.close()
            STATS["restarts"] += 1
        self.proc, self._buf = proc, b""
        self.starts += 1
        STATS["server_starts"] += 1
        return True

    def send(self, req: dict) -> bool:
        try:
            _write(self.proc.stdin.fileno(), req)
            return True
        except OSError:
            return False

    def reply(self, deadline: float):
        """The next reply, or None at ``deadline``; EOFError when the
        server has gone."""
        fd = self.proc.stdout.fileno()
        while b"\n" not in self._buf:
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                return None
            chunk = os.read(fd, 4096)
            if not chunk:
                raise EOFError("the guard server has gone")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def close(self) -> None:
        """Close the request pipe, so that the server exits, and reap
        it (in the process that started it)."""
        if self.proc is None or self.owner != os.getpid():
            return
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.kill()
        self.proc.stdout.close()
        self.proc = None


_SERVER = None   # this process's _Server


def _server() -> _Server:
    global _SERVER
    if _SERVER is None or _SERVER.owner != os.getpid():
        _SERVER = _Server()
    return _SERVER


def start() -> None:
    """Start this process's guard server unless it runs; returns once
    the server is exec'd, so its start overlaps the caller's work."""
    _server().live()


def stop() -> None:
    """Stop this process's guard server; the next served stage starts
    a new one."""
    global _SERVER
    if _SERVER is not None and _SERVER.owner == os.getpid():
        _SERVER.close()
    _SERVER = None


def run_guarded(step: int, fn, cpu_s: int, wall_s: float, mem_mb: int = 0,
                artifacts=(), served=None) -> None:
    """Run a stage in a child under the guard: RLIMIT_CPU ``cpu_s``
    (and RLIMIT_AS growth ``mem_mb`` when above 0); terminated after
    ``wall_s`` of wall time.  With ``served`` = (module, function, args)
    the guard server's child makes that call, and ``fn`` runs in a fork
    of this process only when no server answers; without it ``fn`` runs
    in a fork of this process.  On a timeout or a non-zero exit the
    ``artifacts`` (paths) are removed and RuntimeError raised.  Spans:
    ``pintron_fork`` (processes, via: ``server`` or ``fork``) over the
    request or the fork, ``pintron_fork_wait`` over the wait, and the
    child's ``pintron_step<step>_child`` under the first."""
    outcome = None
    if served is not None:
        outcome = _run_served(step, served, cpu_s, mem_mb, wall_s)
        if outcome is None:
            STATS["fallback_forks"] += 1
    if outcome is None:
        outcome = _run_forked(step, fn, cpu_s, mem_mb, wall_s)
    timed_out, exitcode = outcome
    if timed_out or exitcode != 0:
        for path in artifacts:
            try:
                os.remove(path)
            except OSError:
                pass
        raise RuntimeError(
            "stage exceeded its resource guard or failed "
            + ("(wall-clock timeout)" if timed_out
               else f"(exit {exitcode})"))


def _run_served(step: int, served, cpu_s: int, mem_mb: int, wall_s: float):
    """``served`` in a child of the guard server: (timed out, exit
    code), or None when no server answers.  A server lost in the middle
    of a request takes its child with it, and the request is made again
    on the restarted server."""
    from pintron_tpu_torch.runtime import timing

    module, function, args = served
    req = {"module": module, "function": function, "args": list(args),
           "cpu_s": cpu_s, "mem_mb": mem_mb}
    srv = _server()
    while srv.live():
        with timing.span("pintron_fork", processes=1, via="server") as fork:
            sent = srv.send(req)
        if not sent:
            srv.kill()
            continue
        pid = done = None
        timed_out = False
        try:
            with timing.span("pintron_fork_wait"):
                limit = time.monotonic() + wall_s
                started = srv.reply(limit)
                if started is not None:
                    pid = started["pid"]
                    done = srv.reply(limit)
                if done is None:   # the watchdog
                    timed_out = True
                    if pid is not None:
                        _kill(pid, signal.SIGTERM)
                        done = srv.reply(time.monotonic() + _TERM_GRACE_S)
                    if done is None:   # a hung child or server: both go
                        _kill(pid)
                        srv.kill()
        except EOFError:
            _kill(pid)
            srv.kill()
            continue
        except BaseException:
            _kill(pid)
            srv.kill()
            raise
        if done is None:
            return True, None
        STATS["served"] += 1
        if done["start"] is not None and fork.id is not None:
            timing.trace_add([[f"pintron_step{step}_child", done["start"],
                               done["end"], (pid << 32) | 1, fork.id, pid,
                               pid, {}]])
        return timed_out, done["exit"]
    return None


def _run_forked(step: int, fn, cpu_s: int, mem_mb: int, wall_s: float):
    """``fn`` in a fork of this process: (timed out, exit code).  With
    recording on, the child sends its spans back over a pipe before it
    exits."""
    import multiprocessing

    from pintron_tpu_torch.runtime import timing

    def child():
        set_limits(cpu_s, mem_mb)
        try:
            with timing.span(f"pintron_step{step}_child"):
                fn()
        finally:
            if pw is not None:
                pw.send(timing.trace_take())

    ctx = multiprocessing.get_context("fork")
    pr = pw = None
    if timing.recording():
        pr, pw = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=child)
    with timing.span("pintron_fork", processes=1, via="fork"):
        proc.start()
    limit = time.monotonic() + wall_s
    with timing.span("pintron_fork_wait"):
        if pr is not None:
            pw.close()
            # the spans arrive before the child can exit, or EOF if it
            # died
            if pr.poll(wall_s):
                try:
                    timing.trace_add(pr.recv())
                except (EOFError, OSError):
                    pass
            pr.close()
        proc.join(timeout=max(0.0, limit - time.monotonic()))
    timed_out = proc.is_alive()
    if timed_out:
        proc.terminate()
        proc.join(timeout=_TERM_GRACE_S)
    return timed_out, proc.exitcode


if __name__ == "__main__":
    sys.exit(main())
