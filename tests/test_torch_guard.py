"""STEP 3's resource guard through the guard server
(``pintron_tpu_torch.guard``) on the CPU: the child is the server's,
without torch; a stand-in that overruns its wall limit or exits 1 loses
its artifacts and raises the fork path's error; a process forked later
starts its own server; a killed server is restarted once, then the
stage is forked; AMBN's STEP 3 through the server equals the inline
run's and the golden; the spans keep the fork path's tree.  About 10 s."""

import json
import multiprocessing
import os
import shutil
import signal
import sys
import time

import pytest

from pintron_tpu_torch import guard
from pintron_tpu_torch.runtime import timing
from pintron_tpu_torch.stages.min_factorization import \
    run_min_factorization_files

STEP3 = ("pintron_tpu_torch.stages.min_factorization",
         "run_min_factorization_files")

# a stand-in stage on the server's path: STEP 3, then what its process
# holds
PROBE = '''
import json, os, sys
from pintron_tpu_torch.stages.min_factorization import \\
    run_min_factorization_files


def step3(raw, out, report):
    run_min_factorization_files(raw, out)
    with open(report, "w") as f:
        json.dump({"torch": "torch" in sys.modules, "pid": os.getpid(),
                   "ppid": os.getppid()}, f)
'''


@pytest.fixture
def probe(tmp_path, monkeypatch, golden):
    """A fresh server that can import the probe, and AMBN's STEP 3
    input: (raw, out, report) paths."""
    mods = tmp_path / "mods"
    mods.mkdir()
    (mods / "guard_probe.py").write_text(PROBE)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(mods), os.environ.get("PYTHONPATH")) if p))
    shutil.copy(golden("test-AMBN") / "raw-multifasta-out.txt", tmp_path)
    guard.stop()
    yield tuple(str(tmp_path / n) for n in
                ("raw-multifasta-out.txt", "out-agree.txt", "report.json"))
    guard.stop()


def _served_probe(paths):
    guard.run_guarded(3, None, 60, 60, served=("guard_probe", "step3",
                                               paths))
    with open(paths[2]) as f:
        return json.load(f)


def _server_pid():
    return guard._SERVER.proc.pid


def test_the_step3_child_is_the_servers_and_holds_no_torch(probe, golden):
    assert "torch" in sys.modules
    guard.start()
    before = dict(guard.STATS)
    seen = _served_probe(probe)
    assert seen["torch"] is False
    assert seen["ppid"] == _server_pid() != os.getpid()
    assert seen["pid"] not in (os.getpid(), _server_pid())
    assert guard.STATS["served"] == before["served"] + 1
    assert guard.STATS["fallback_forks"] == before["fallback_forks"]
    with open(probe[1], "rb") as f:
        assert f.read() == (golden("test-AMBN") / "out-agree.txt") \
            .read_bytes()


@pytest.mark.parametrize("kind", ["overrun", "exit1"])
def test_a_failed_stand_in_loses_its_artifacts_and_raises(kind, tmp_path):
    """Through the server and through the fork the same RuntimeError;
    the overrun is stopped at its 1 s wall limit."""
    guard.stop()
    served, fn = {
        "overrun": (("time", "sleep", (60,)), lambda: time.sleep(60)),
        "exit1": (("sys", "exit", (1,)), lambda: sys.exit(1)),
    }[kind]
    errors = []
    try:
        for how in ("server", "fork"):
            artifact = tmp_path / f"out-{how}.txt"
            artifact.write_text("truncated")
            before = dict(guard.STATS)
            t0 = time.monotonic()
            with pytest.raises(RuntimeError) as err:
                guard.run_guarded(3, fn, 60, 1, artifacts=(str(artifact),),
                                  served=served if how == "server" else None)
            assert time.monotonic() - t0 < 12
            assert not artifact.exists()
            assert guard.STATS["served"] == before["served"] + (
                how == "server")
            assert guard.STATS["fallback_forks"] == before["fallback_forks"]
            errors.append(str(err.value))
    finally:
        guard.stop()
    assert errors[0] == errors[1] == (
        "stage exceeded its resource guard or failed "
        + ("(wall-clock timeout)" if kind == "overrun" else "(exit 1)"))


def test_a_process_forked_later_starts_its_own_server(probe):
    guard.start()
    parent_server = _server_pid()
    r, w = multiprocessing.get_context("fork").Pipe(duplex=False)

    def child():
        try:
            seen = _served_probe(probe)
            w.send((seen, _server_pid(), guard._SERVER.owner))
        finally:
            guard.stop()

    proc = multiprocessing.get_context("fork").Process(target=child)
    proc.start()
    assert r.poll(30)
    seen, child_server, owner = r.recv()
    proc.join(30)
    assert not proc.is_alive() and proc.exitcode == 0
    assert owner == proc.pid
    assert child_server != parent_server
    assert seen["ppid"] == child_server
    # the parent's server still serves it
    assert _server_pid() == parent_server
    assert _served_probe(probe)["ppid"] == parent_server


def test_a_killed_server_is_restarted_once_then_the_stage_forks(probe,
                                                                golden):
    guard.start()
    gold = (golden("test-AMBN") / "out-agree.txt").read_bytes()
    before = dict(guard.STATS)
    first = _server_pid()
    os.kill(first, signal.SIGKILL)
    guard._SERVER.proc.wait(10)
    seen = _served_probe(probe)
    assert seen["ppid"] == _server_pid() != first
    assert guard.STATS["restarts"] == before["restarts"] + 1
    assert guard.STATS["server_starts"] == before["server_starts"] + 1
    assert guard.STATS["served"] == before["served"] + 1
    with open(probe[1], "rb") as f:
        assert f.read() == gold

    os.kill(_server_pid(), signal.SIGKILL)
    guard._SERVER.proc.wait(10)
    os.remove(probe[1])
    guard.run_guarded(3, lambda: run_min_factorization_files(*probe[:2]),
                      60, 60, served=STEP3 + (probe[:2],))
    assert guard.STATS["restarts"] == before["restarts"] + 1
    assert guard.STATS["fallback_forks"] == before["fallback_forks"] + 1
    assert guard.STATS["served"] == before["served"] + 1
    with open(probe[1], "rb") as f:
        assert f.read() == gold


def test_ambn_step3_through_the_server_equals_the_inline_run(probe,
                                                              golden):
    raw, out = probe[:2]
    inline = out + ".inline"
    run_min_factorization_files(raw, inline)
    guard.run_guarded(3, None, 60, 60, served=STEP3 + ((raw, out),))
    with open(out, "rb") as f, open(inline, "rb") as g:
        served = f.read()
        assert served == g.read()
    assert served == (golden("test-AMBN") / "out-agree.txt").read_bytes()


def test_the_served_childs_span_lies_under_its_request(probe):
    raw, out = probe[:2]
    timing.trace_take()
    timing.trace_on()
    try:
        with timing.span("pintron_step3") as step3:
            guard.run_guarded(3, None, 60, 60, served=STEP3 + ((raw, out),))
    finally:
        timing.trace_off()
    spans = timing.trace_take()
    (fork,) = [s for s in spans if s.name == "pintron_fork"]
    (wait,) = [s for s in spans if s.name == "pintron_fork_wait"]
    (child,) = [s for s in spans if s.name == "pintron_step3_child"]
    assert fork.attrs == {"processes": 1, "via": "server"}
    assert fork.parent == wait.parent == step3.id
    assert child.parent == fork.id
    assert child.pid not in (os.getpid(), _server_pid())
    assert fork.end <= wait.start <= child.end <= wait.end
    assert child.start <= child.end


def _children_of(pid, wait_s=10.0):
    """The pids whose parent is ``pid``, waiting for one to appear."""
    t0 = time.monotonic()
    while True:
        kids = []
        for p in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{p}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            if ppid == pid:
                kids.append(int(p))
        if kids or time.monotonic() - t0 > wait_s:
            return kids
        time.sleep(0.02)


def test_a_spare_child_killed_idle_is_replaced_and_none_outlives_stop(
        probe, golden):
    """The server forks each child before its request; one that dies
    while it waits is replaced, and stopping the server ends the spare
    waiting then."""
    guard.start()
    server = _server_pid()
    (spare,) = _children_of(server)
    os.kill(spare, signal.SIGKILL)
    seen = _served_probe(probe)
    assert seen["ppid"] == server and seen["pid"] != spare
    with open(probe[1], "rb") as f:
        assert f.read() == (golden("test-AMBN") / "out-agree.txt") \
            .read_bytes()
    (waiting,) = _children_of(server)
    guard.stop()
    assert not os.path.exists(f"/proc/{server}")
    assert not os.path.exists(f"/proc/{waiting}")
