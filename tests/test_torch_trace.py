"""The port's span recorder (``pintron_tpu_torch.runtime.timing``) on the
CPU: nothing kept with recording off; on AMBN with ``device="cpu"`` the
STEPs, the GTF and the cleanup under one ``pintron_locus`` that they
cover, STEP 2's phases under STEP 2, STEP 3's forked child from its own
pid inside STEP 3, and ``PINTRON_TORCH_PROFILE``'s span file; STEP 2
sharded over 2 fork workers through a CPU device service that records
(each worker's spans sent back, every request's arrival before its
evaluation); spans named in a ``torch.profiler`` trace with their
parents where torch is loaded, and kept by the recorder in a process
that never loads it; the recorder's parents across threads and forks; a
process's start-up, ``pintron_startup``, kept at its first locus alone
and never in a forked child."""

import glob
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

import pintron_tpu_torch
from pintron_tpu_torch import pipeline
from pintron_tpu_torch.native import get_lib
from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.runtime import timing
from pintron_tpu_torch.stages import est_fact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = tuple(f"pintron_step{n}" for n in range(1, 9)) + (
    "pintron_gtf", "pintron_cleanup")


@pytest.fixture(autouse=True)
def _recorder_left_off():
    timing.trace_off()
    timing.trace_take()
    yield
    timing.trace_off()
    timing.trace_take()


def _locus(gold, work):
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    return work


def _run_pipeline(work):
    pipeline.pintron_pipeline(workdir=str(work), output_filename="full.json",
                              gtf_filename="pintron-all-isoforms.gtf",
                              gene="AMBN", organism="human",
                              keep_intermediate=True, device="cpu")


def _ancestors(span, by_id):
    out = []
    while span.parent in by_id:
        span = by_id[span.parent]
        out.append(span.name)
    return out


@pytest.fixture(scope="module")
def traced_locus(golden, tmp_path_factory):
    """AMBN's pipeline with recording on: its spans by name."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    os.environ.pop("PINTRON_DEVICE", None)
    work = _locus(golden("test-AMBN"),
                  tmp_path_factory.mktemp("traced") / "ambn")
    fresh = os.environ.get("PINTRON_FRESH_MEMO")
    os.environ["PINTRON_FRESH_MEMO"] = "1"   # the device batches run
    timing.trace_take()
    timing.trace_on()
    try:
        _run_pipeline(work)
    finally:
        timing.trace_off()
        if fresh is None:
            os.environ.pop("PINTRON_FRESH_MEMO")
        else:
            os.environ["PINTRON_FRESH_MEMO"] = fresh
    spans = timing.trace_take()
    assert (work / "full.json").read_bytes() == \
        (golden("test-AMBN") / "full.json").read_bytes()
    return spans


def test_recording_off_keeps_no_span(golden, tmp_path, monkeypatch):
    if get_lib() is None:
        pytest.skip("native library unavailable")
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    _run_pipeline(_locus(golden("test-AMBN"), tmp_path / "ambn"))
    assert not timing.recording()
    assert timing.trace_take() == []


def test_the_steps_are_children_of_one_locus(traced_locus):
    (locus,) = [s for s in traced_locus if s.name == "pintron_locus"]
    assert locus.parent is None
    assert locus.attrs == {"gene": "AMBN", "records": 25}
    children = {s.name for s in traced_locus if s.parent == locus.id}
    assert children == set(STEPS)
    for s in traced_locus:
        if s.name in STEPS:
            assert locus.start <= s.start <= s.end <= locus.end


def test_the_children_of_the_locus_cover_it(traced_locus):
    (locus,) = [s for s in traced_locus if s.name == "pintron_locus"]
    covered = sum(s.end - s.start for s in traced_locus
                  if s.parent == locus.id)
    assert covered >= 0.98 * (locus.end - locus.start)


def test_step2_phases_lie_under_step2(traced_locus):
    by_id = {s.id: s for s in traced_locus}
    phases = [s for s in traced_locus if s.name.startswith("pintron_step2_")]
    assert {s.name for s in phases} >= {
        "pintron_step2_meg_enum", "pintron_step2_collect_noisy",
        "pintron_step2_cascade", "pintron_step2_nw_phase"}
    for s in phases:
        assert "pintron_step2" in _ancestors(s, by_id), s


def test_device_batches_name_their_caller_across_threads(traced_locus):
    """The batches run on device_call's dispatch thread (and the K-band
    executor's): each names the span open where it was sent."""
    by_id = {s.id: s for s in traced_locus}
    nw = [s for s in traced_locus if s.name == "pintron_nw"]
    assert nw
    for s in nw:
        assert by_id[s.parent].name == "pintron_step2_nw_phase"
        assert s.thread != by_id[s.parent].thread
    for s in traced_locus:
        if s.name.startswith("pintron_kband_"):
            assert "pintron_step2" in _ancestors(s, by_id)
        if s.name in ("pintron_pwm", "pintron_edit"):
            assert "pintron_step4" in _ancestors(s, by_id)


def test_step3_child_comes_from_another_pid_inside_step3(traced_locus):
    """The child's parent is the fork that made it; the parent's wait
    and join hold the child."""
    by_id = {s.id: s for s in traced_locus}
    (step3,) = [s for s in traced_locus if s.name == "pintron_step3"]
    (child,) = [s for s in traced_locus if s.name == "pintron_step3_child"]
    fork = by_id[child.parent]
    assert fork.name == "pintron_fork" and fork.parent == step3.id
    (wait,) = [s for s in traced_locus if s.name == "pintron_fork_wait"
               and s.parent == step3.id]
    assert child.pid != step3.pid == fork.pid == os.getpid()
    assert step3.start <= fork.start <= fork.end <= wait.start
    assert wait.start <= child.end <= wait.end <= step3.end


def test_the_steps_5_to_8_have_their_phases(traced_locus):
    by_id = {s.id: s for s in traced_locus}
    for step, n in (("pintron_step5", 3), ("pintron_step6", 4),
                    ("pintron_step7", 4), ("pintron_step8", 4)):
        phases = [s for s in traced_locus
                  if s.name.startswith(step + "_")]
        assert len(phases) == n, step
        assert all(by_id[s.parent].name == step for s in phases)
    assert "pintron_step8_link" in {s.name for s in traced_locus}


def test_the_profile_variable_writes_the_span_file(golden, tmp_path,
                                                   monkeypatch):
    if get_lib() is None:
        pytest.skip("native library unavailable")
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.setenv(timing.PROFILE_ENV, str(tmp_path / "prof"))
    _run_pipeline(_locus(golden("test-AMBN"), tmp_path / "ambn"))
    assert not timing.recording()
    pid = os.getpid()
    assert (tmp_path / "prof" / f"pintron-{pid}.json").is_file()
    with open(tmp_path / "prof" / f"spans-{pid}.jsonl") as f:
        spans = [json.loads(line) for line in f]
    names = {s["name"] for s in spans}
    assert set(STEPS) | {"pintron_locus", "pintron_step3_child"} <= names
    assert {"start", "end", "id", "parent", "pid", "thread", "attrs"} \
        <= set(spans[0])


# ---- STEP 2 sharded through a recording service ----------------------------

def _env(prof_dir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PINTRON_DEVICE", offload.SERVICE_ENV)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env[timing.PROFILE_ENV] = prof_dir
    return env


@pytest.fixture(scope="module")
def sharded(golden, tmp_path_factory):
    """AMBN's STEP 2 over 2 fork workers (gate lowered) through a CPU
    service started with PINTRON_TORCH_PROFILE, recording on in the
    client: (the client's spans, the service's)."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    root = tmp_path_factory.mktemp("sharded")
    sock = os.path.join(tempfile.mkdtemp(prefix="torch-trace-"), "dev.sock")
    ready = sock + ".ready"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pintron_tpu_torch.devservice", "--socket",
         sock, "--device", "cpu", "--ready-file", ready],
        env=_env(str(root / "prof")), cwd=REPO)
    saved = {k: os.environ.get(k) for k in (
        "PINTRON_DEVICE", "PINTRON_FRESH_MEMO", "PINTRON_EST_WORKERS",
        offload.SERVICE_ENV)}
    min_records = est_fact.FORK_MIN_RECORDS
    try:
        t0 = time.monotonic()
        while not os.path.exists(ready):
            assert proc.poll() is None, "device service exited"
            assert time.monotonic() - t0 < 60, "device service not ready"
            time.sleep(0.05)
        os.environ.pop("PINTRON_DEVICE", None)
        os.environ.update({"PINTRON_FRESH_MEMO": "1",
                           "PINTRON_EST_WORKERS": "2",
                           offload.SERVICE_ENV: sock})
        est_fact.FORK_MIN_RECORDS = 1
        work = _locus(golden("test-AMBN"), root / "ambn")
        timing.trace_take()
        timing.trace_on()
        try:
            est_fact.run_est_fact(str(work), device="cpu")
        finally:
            timing.trace_off()
        client = timing.trace_take()
    finally:
        est_fact.FORK_MIN_RECORDS = min_records
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        from multiprocessing.connection import Client
        try:
            conn = Client(sock, family="AF_UNIX", authkey=offload.AUTHKEY)
            conn.send(("shutdown", None))
            conn.poll(30)
            conn.close()
        finally:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    (path,) = glob.glob(str(root / "prof" / "spans-*.jsonl"))
    with open(path) as f:
        service = [timing.Span(**json.loads(line)) for line in f]
    return client, service


def test_fork_workers_send_their_spans_back(sharded):
    client, _service = sharded
    by_id = {s.id: s for s in client}
    workers = [s for s in client if s.name == "pintron_est_worker"]
    assert sorted(s.attrs["worker"] for s in workers) == [0, 1]
    assert len({s.pid for s in workers}) == 2
    assert os.getpid() not in {s.pid for s in workers}
    for w in workers:
        assert w.attrs["nworkers"] == 2 and w.attrs["cpu_s"] > 0
        assert by_id[w.parent].name == "pintron_fork"
        below = {s.name for s in client if w.name in _ancestors(s, by_id)
                 and s.pid == w.pid}
        assert "pintron_service_call" in below
        assert any(n.startswith("pintron_step2_") for n in below)


def test_measure_step2_reads_the_workers_from_their_spans(sharded):
    from pintron_tpu_torch.measure_step2 import _worker_records
    client, _service = sharded
    call = min(s.start for s in client)
    records = _worker_records(client, call)
    calls = sum(1 for s in client if s.name == "pintron_service_call")
    assert len(records) == 2
    assert sum(r["requests"] for r in records) == calls
    for r in records:
        assert r["start_ms"] >= 0 and r["cpu_ms"] > 0
        assert 0 < r["wait_ms"] < r["wall_ms"]


def test_service_requests_arrive_before_their_evaluation(sharded):
    client, service = sharded
    evals = {s.id: s for s in service if s.name == "pintron_service_eval"}
    requests = [s for s in service if s.name == "pintron_service_request"]
    assert evals and requests
    for r in requests:
        e = evals[r.attrs["eval"]]
        assert r.start <= e.start <= e.end <= r.end
        assert r.attrs["wait"] == pytest.approx(e.start - r.start)
        assert r.attrs["op"] == e.attrs["op"]
    assert sum(e.attrs["requests"] for e in evals.values()) == len(requests)
    # every round trip a client made is one request the service served
    calls = [s for s in client if s.name == "pintron_service_call"]
    assert len(calls) == len(requests)
    # one clock for every process: each request arrived while a client's
    # round trip of its op was open
    for r in requests:
        assert any(c.start <= r.start <= c.end and c.attrs["op"]
                   == r.attrs["op"] for c in calls), r


# ---- the recorder itself ------------------------------------------------------

def test_a_decorated_span_shows_in_a_torch_profiler_trace():
    """With torch loaded, a span is a host event of a running profiler
    under its own name: a decorated one each call, and one opened with
    ``with`` the parent of the spans inside it, over their interval."""
    @timing.span("pintron_test_decorated")
    def work(x):
        return x + 1

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert work(torch.ones(3)).sum().item() == 6
        with timing.timed_span("pintron_test_outer"):
            assert work(torch.ones(3)).sum().item() == 6
    events = prof.events()
    names = [e.name for e in events]
    assert names.count("pintron_test_decorated") == 2
    (outer,) = [e for e in events if e.name == "pintron_test_outer"]
    inner = [e for e in events if e.name == "pintron_test_decorated"
             and e.cpu_parent is not None]
    assert [e.cpu_parent.name for e in inner] == ["pintron_test_outer"]
    assert outer.time_range.start <= inner[0].time_range.start \
        <= inner[0].time_range.end <= outer.time_range.end
    assert timing.trace_take() == []


_RECORD_WITHOUT_TORCH = """
import json, sys
from pintron_tpu_torch.runtime import timing
timing.trace_on()
with timing.span("outer", k=1) as outer:
    with timing.timed_span("middle"):
        @timing.span("inner", j=2)
        def work():
            timing.note(x=3)
        work()
timing.record("recorded", 0.0, 1.0, parent=outer.id, r=4)
timing.trace_off()
spans = [s._asdict() for s in timing.trace_take()]
print(json.dumps({"spans": spans, "torch": sorted(
    m for m in sys.modules if m == "torch" or m.startswith("torch."))}))
"""


def test_the_recorder_keeps_spans_without_torch():
    """In a fresh interpreter that never loads torch, the recorder keeps
    nested spans (``with``, timed, decorated, recorded) with their
    parents, attributes and intervals, as it does with torch."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _RECORD_WITHOUT_TORCH],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["torch"] == []
    spans = {s["name"]: s for s in out["spans"]}
    assert sorted(spans) == ["inner", "middle", "outer", "recorded"]
    outer, middle, inner = spans["outer"], spans["middle"], spans["inner"]
    assert outer["parent"] is None
    assert middle["parent"] == outer["id"]
    assert inner["parent"] == middle["id"]
    assert spans["recorded"]["parent"] == outer["id"]
    assert outer["attrs"] == {"k": 1} and middle["attrs"] == {}
    assert inner["attrs"] == {"j": 2, "x": 3}
    assert spans["recorded"]["attrs"] == {"r": 4}
    assert outer["start"] <= middle["start"] <= inner["start"] \
        <= inner["end"] <= middle["end"] <= outer["end"]
    assert len({s["pid"] for s in out["spans"]}) == 1


def test_an_unbound_thread_starts_its_own_tree():
    timing.trace_on()
    with timing.span("outer"):
        def thread():
            with timing.span("inner"):
                pass
        t = threading.Thread(target=thread)
        t.start()
        t.join(30)
        assert not t.is_alive()
    spans = {s.name: s for s in timing.trace_take()}
    assert spans["inner"].parent is None
    assert spans["outer"].parent is None


def test_a_bound_call_parents_its_spans_on_the_caller():
    timing.trace_on()
    seen = {}
    with timing.span("caller", k=1) as caller:
        def work():
            with timing.span("callee"):
                timing.note(x=2)
            seen["thread"] = threading.get_native_id()
        t = threading.Thread(target=timing.bind(work))
        t.start()
        t.join(30)
        assert not t.is_alive()
    spans = {s.name: s for s in timing.trace_take()}
    assert spans["callee"].parent == caller.id
    assert spans["callee"].thread == seen["thread"] != spans["caller"].thread
    assert spans["callee"].attrs == {"x": 2}
    assert spans["caller"].attrs == {"k": 1}
    assert spans["caller"].start <= spans["callee"].start \
        <= spans["callee"].end <= spans["caller"].end


def test_a_forked_child_keeps_its_parents_and_starts_empty():
    timing.trace_on()
    r, w = multiprocessing.get_context("fork").Pipe(duplex=False)
    with timing.span("parent") as parent:
        with timing.span("before"):
            pass

        def child():
            with timing.span("in_child"):
                pass
            w.send(timing.trace_take())

        p = multiprocessing.get_context("fork").Process(target=child)
        p.start()
        timing.trace_add(r.recv())
        p.join(30)
        assert p.exitcode == 0
    spans = timing.trace_take()
    assert sorted(s.name for s in spans) == ["before", "in_child", "parent"]
    (kid,) = [s for s in spans if s.name == "in_child"]
    assert kid.parent == parent.id and kid.pid == p.pid
    assert len({s.id for s in spans}) == 3


def test_recording_off_costs_no_kept_span_and_no_clock():
    with timing.span("off") as sp:
        assert sp.id is None
    assert timing.record("off", 0.0, 1.0) is None
    timing.note(x=1)
    assert timing.trace_take() == []
    with timing.timed_span("timed") as tsp:
        pass
    assert tsp.id is None and tsp.end >= tsp.start
    assert timing.trace_take() == []


# ---- a process's start-up ----------------------------------------------------

@pytest.fixture
def fresh_process(monkeypatch):
    """The recorder as a process that has opened no locus has it."""
    monkeypatch.setattr(timing, "_STARTED", False)
    monkeypatch.setattr(timing, "_STARTUP", None)


def _traced(work):
    timing.trace_take()
    timing.trace_on()
    try:
        _run_pipeline(work)
    finally:
        timing.trace_off()
    return timing.trace_take()


@pytest.fixture(scope="module")
def first_two_loci(golden, tmp_path_factory):
    """AMBN's pipeline twice with recording on, in a process that had
    opened no locus: (the first locus's spans, the second's, the
    start-up's seconds after both)."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    os.environ.pop("PINTRON_DEVICE", None)
    root = tmp_path_factory.mktemp("startup")
    saved = timing._STARTED, timing._STARTUP
    timing._STARTED, timing._STARTUP = False, None
    try:
        loci = [_traced(_locus(golden("test-AMBN"), root / f"ambn{n}"))
                for n in range(2)]
        return loci[0], loci[1], timing.startup_seconds()
    finally:
        timing._STARTED, timing._STARTUP = saved


def test_the_first_locus_records_the_start_up_up_to_its_own(first_two_loci):
    first, _second, seconds = first_two_loci
    (startup,) = [s for s in first if s.name == "pintron_startup"]
    (locus,) = [s for s in first if s.name == "pintron_locus"]
    assert startup.start < locus.start == startup.end
    assert startup.start <= pintron_tpu_torch.IMPORT_START
    assert startup.parent is None
    assert startup.pid == startup.attrs["pid"] == os.getpid()
    assert 0 < startup.attrs["package_s"] < startup.end - startup.start
    assert seconds == startup.end - startup.start


def test_a_second_locus_records_no_start_up(first_two_loci):
    _first, second, _seconds = first_two_loci
    names = [s.name for s in second]
    assert names.count("pintron_locus") == 1
    assert "pintron_startup" not in names


def test_a_start_up_unrecorded_at_the_first_locus_is_never_recorded(
        golden, tmp_path, monkeypatch, fresh_process):
    if get_lib() is None:
        pytest.skip("native library unavailable")
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    _run_pipeline(_locus(golden("test-AMBN"), tmp_path / "off"))
    assert timing.trace_take() == []
    kept = timing.startup_seconds()
    assert kept > 0
    names = [s.name for s in _traced(_locus(golden("test-AMBN"),
                                            tmp_path / "on"))]
    assert "pintron_locus" in names and "pintron_startup" not in names
    assert timing.startup_seconds() == kept


def test_a_forked_child_records_no_start_up(fresh_process):
    """A child forked before its parent's first locus keeps no start-up;
    the parent still keeps its own."""
    ctx = multiprocessing.get_context("fork")
    r, w = ctx.Pipe(duplex=False)
    timing.trace_on()

    def child():
        timing.startup(time.monotonic())
        w.send((timing.trace_take(), timing.startup_seconds()))

    p = ctx.Process(target=child)
    p.start()
    assert r.poll(30), "the child sent nothing"
    sent = r.recv()
    p.join(30)
    assert p.exitcode == 0
    assert sent == ([], None)
    t = time.monotonic()
    timing.startup(t)
    (startup,) = timing.trace_take()
    assert startup.name == "pintron_startup" and startup.end == t
    assert startup.start < t
