"""The port's device service (``pintron_tpu_torch.devservice``) on the
CPU: round trips equal to the local entries for all six ops, the
``evaluated`` masks sliced per client, errors raised in the client (no
host fallback), STEP 2 sharded over fork workers through the service,
and the batch driver with ``--device cpu``: two loci, and a manifest of
three at its defaults (a job a locus, one EST worker each, each job's
start-up in its line and its spans).  Inputs are made from a seed with
numpy; the loci come from ``tests/golden/``."""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from pintron_tpu_torch.native import get_lib
from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.ops.pwm import pwm_tables
from pintron_tpu_torch.runtime import timing
from pintron_tpu_torch.stages import est_fact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA = np.array(list("ACGT"))
STAGE2 = ("raw-multifasta-out.txt", "processed-ests.txt", "megs.txt",
          "processed-megs.txt", "meg-edges.txt")
# STEPs 2-4's artifacts, as the benchmark's check compares them
STEP_ARTIFACTS = STAGE2 + ("out-agree.txt", "out-after-intron-agree.txt",
                           "predicted-introns.txt")
COUNTS = ("problems", "device_problems", "device_cells", "nw_problems",
          "gap_problems", "rb_problems")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PINTRON_DEVICE", offload.SERVICE_ENV)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def service():
    sock = os.path.join(tempfile.mkdtemp(prefix="torch-svc-test-"),
                        "dev.sock")
    ready = sock + ".ready"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pintron_tpu_torch.devservice", "--socket",
         sock, "--device", "cpu", "--ready-file", ready], env=_env(),
        cwd=REPO)
    t0 = time.monotonic()
    while not os.path.exists(ready):
        assert proc.poll() is None, "device service exited"
        assert time.monotonic() - t0 < 60, "device service not ready"
        time.sleep(0.05)
    yield sock
    from multiprocessing.connection import Client
    try:
        conn = Client(sock, family="AF_UNIX", authkey=offload.AUTHKEY)
        conn.send(("shutdown", None))
        assert conn.poll(30)
        report = conn.recv()[1]
        conn.close()
        assert report["stats"]["requests"] > 0
        # each of the two error tests sends one bad request
        assert report["stats"]["errors"] <= 2
    finally:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise


@pytest.fixture
def local(monkeypatch):
    monkeypatch.delenv(offload.SERVICE_ENV, raising=False)
    monkeypatch.setattr(offload, "_DEVICE", torch.device("cpu"))
    offload.reset_stats()
    return offload


@pytest.fixture
def via(service, local, monkeypatch):
    """Run a call through the service, then locally; return both
    results and both runs' counters."""
    def run(fn, *args):
        monkeypatch.setenv(offload.SERVICE_ENV, service)
        offload.reset_stats()
        remote = fn(*args)
        remote_stats = dict(offload.STATS)
        monkeypatch.delenv(offload.SERVICE_ENV)
        offload.reset_stats()
        here = fn(*args)
        return remote, here, remote_stats, dict(offload.STATS)
    return run


def kband_problems(seed=5, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(5, 180))
        g = "".join(rng.choice(ALPHA, ln)).encode()
        e = bytearray(g)
        for _ in range(int(rng.integers(0, 6))):
            e[int(rng.integers(0, ln))] = ord(str(rng.choice(ALPHA)))
        out.append((g, bytes(e), int(rng.integers(0, 8))))
    return out


def pair_problems(seed, count=40):
    rng = np.random.default_rng(seed)
    probs = []
    for i in range(count):
        e = "".join(rng.choice(ALPHA, int(rng.integers(1, 80)))).encode()
        g = e if i % 3 == 0 else "".join(
            rng.choice(ALPHA, int(rng.integers(1, 300)))).encode()
        probs.append((e, g))
    # one oversized problem of each kind (a gen window wider than the
    # kernels' MAX_WIDTH), left to the host
    probs.insert(7, ("".join(rng.choice(ALPHA, 2000)).encode(),
                     "".join(rng.choice(ALPHA, 17000)).encode()))
    return probs


def test_kband_and_edit_via_service_match_local(via):
    problems = kband_problems()
    pairs = [(g[:15], e[:15]) for g, e, _ in problems]
    for fn, arg in ((offload.eval_kband, problems),
                    (offload.eval_edit_batch, pairs)):
        remote, here, rs, hs = via(fn, arg)
        np.testing.assert_array_equal(remote, here)
        assert {k: rs[k] for k in COUNTS} == {k: hs[k] for k in COUNTS}
    assert hs["edit_problems"] > 0


@pytest.mark.parametrize("family", ["nw", "gap", "rb"])
def test_traceback_families_via_service_match_local(via, family):
    """The service and this process route alike: the one problem over
    the kernels' bound left to the host (counted in <family>_too_wide),
    and for NW and gap one of 1500 x 1500, over the JAX package's bound,
    evaluated."""
    problems = pair_problems({"nw": 1, "gap": 2, "rb": 3}[family])
    if family == "rb":
        problems = [(g, e) for e, g in problems]
        problems[7] = ("".join(np.random.default_rng(4).choice(
            ALPHA, 17000)).encode(), b"ACGT")
    else:
        rng = np.random.default_rng(5)
        problems.append(tuple("".join(rng.choice(ALPHA, 1500)).encode()
                              for _ in range(2)))
    remote, here, rs, hs = via(getattr(offload, f"eval_{family}"),
                               problems)
    counts = COUNTS + (f"{family}_too_wide",)
    assert {k: rs[k] for k in counts} == {k: hs[k] for k in counts}
    assert hs[f"{family}_too_wide"] == 1
    evaluated = here[-1]
    assert evaluated.tolist() == [i != 7 for i in range(len(problems))]
    for got, want in zip(remote, here):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_rb_tables_via_service_equal_the_host_rows(service, local,
                                                   monkeypatch):
    from pintron_tpu.factorize.alignments import edit_distance_full
    rng = np.random.default_rng(9)
    probs = [("".join(rng.choice(ALPHA, int(rng.integers(4, 120)))).encode(),
              "".join(rng.choice(ALPHA, int(rng.integers(1, 60)))).encode())
             for _ in range(20)]
    monkeypatch.setenv(offload.SERVICE_ENV, service)
    vals, pos, evaluated = offload.eval_rb(probs)
    assert evaluated.all()
    for i, (t, p) in enumerate(probs):
        M = edit_distance_full(t.decode(), p.decode())
        assert vals[i, :len(p) + 1].tolist() == M.min(axis=1).tolist()
        assert pos[i, :len(p) + 1].tolist() == M.argmin(axis=1).tolist()


def test_pwm_via_service_matches_local(via):
    rng = np.random.default_rng(13)
    for name in ("BPS_9", "BPS_10"):
        wpwm, den = pwm_tables(name)
        rows = rng.integers(0, 4, (777, wpwm.shape[1])).astype(np.int8)
        remote, here, rs, hs = via(offload.pwm_scores_batched, rows, wpwm,
                                   den)
        assert remote.dtype == np.float32
        np.testing.assert_array_equal(remote, here)
        assert rs["pwm_windows"] == hs["pwm_windows"] == 777


def test_unknown_op_raises_in_the_client(service, local, monkeypatch):
    monkeypatch.setenv(offload.SERVICE_ENV, service)
    with pytest.raises(RuntimeError, match="no-such-op"):
        offload.service_eval("no-such-op", None, torch.device("cpu"))


def test_service_queues_as_many_dialling_clients_as_the_system_allows(
        tmp_path):
    """The service's accept queue is SOMAXCONN long, not the default
    one: where a full queue fails a connect at once (gVisor), a batch's
    jobs dialling together must all get through.  ``ss`` reads a
    listening socket's queue length as its Send-Q."""
    import socket

    from pintron_tpu_torch.devservice import listen
    if shutil.which("ss") is None:
        pytest.skip("needs ss to read the socket's queue length")
    path = str(tmp_path / "dev.sock")
    listener = listen(path)
    try:
        out = subprocess.run(["ss", "-xlH"], capture_output=True, text=True,
                             check=True).stdout
    finally:
        listener.close()
    queue_len = [int(ln.split()[3]) for ln in out.splitlines()
                 if path in ln.split()]
    assert queue_len == [socket.SOMAXCONN]


def test_clients_dialling_at_once_all_connect(service, local):
    """64 clients dial the service at the same moment; each takes its
    handshake."""
    import threading
    go, served, errors = threading.Event(), [], []

    def dial():
        go.wait()
        try:
            conn, device = offload._dial(service)
            conn.close()
            served.append(device)
        except OSError as e:
            errors.append(e)

    threads = [threading.Thread(target=dial) for _ in range(64)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and served == ["cpu"] * 64


def test_cuda_client_on_a_cpu_service_raises(service, local, monkeypatch):
    """A client checks the service's device on connecting: a cuda run
    never lands on a cpu service, whether it selects its device or
    sends a batch."""
    monkeypatch.setenv(offload.SERVICE_ENV, service)
    assert offload.service_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="runs on cpu"):
        offload.use_device("cuda")
    monkeypatch.setattr(offload, "_DEVICE", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="runs on cpu"):
        offload.eval_kband(kband_problems(n=4))
    assert offload.STATS["batches"] == 0


def test_failed_service_batch_raises_and_latches_nothing(service, local,
                                                         monkeypatch):
    """A batch the service cannot evaluate (weights that do not fit the
    windows) comes back as an error, which the entry raises: no host
    path stands in for it."""
    monkeypatch.setenv(offload.SERVICE_ENV, service)
    wpwm, den = pwm_tables("BPS_9")
    rows = np.zeros((5, 10), dtype=np.int8)
    with pytest.raises(RuntimeError, match="device service: ValueError"):
        offload.pwm_scores_batched(rows, wpwm, den)
    assert offload.STATS["device_timeouts"] == 0


def _workdir(gold, work):
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    return work


def test_step2_sharded_through_the_service(service, golden, tmp_path,
                                           local, monkeypatch):
    """AMBN's STEP 2 over 2 fork workers feeding the service (gate
    lowered): byte-identical, and the merged counters equal a
    single-process run's."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    gold = golden("test-AMBN")
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.setenv("PINTRON_FRESH_MEMO", "1")
    monkeypatch.setenv("PINTRON_EST_WORKERS", "2")
    monkeypatch.setattr(est_fact, "FORK_MIN_RECORDS", 1)
    monkeypatch.setenv(offload.SERVICE_ENV, service)
    calls = []
    forked = est_fact._run_units_device_forked
    monkeypatch.setattr(est_fact, "_run_units_device_forked",
                        lambda *a: calls.append(a[-1]) or forked(*a))
    work = _workdir(gold, tmp_path / "sharded")
    est_fact.run_est_fact(str(work), device="cpu")
    sharded = dict(offload.STATS)
    assert calls == [2]
    for name in STAGE2:
        assert (work / name).read_bytes() == (gold / name).read_bytes(), \
            name
    monkeypatch.delenv(offload.SERVICE_ENV)
    offload.reset_stats()
    est_fact.run_est_fact(str(_workdir(gold, tmp_path / "single")),
                          device="cpu")
    assert sharded["device_runs"] == offload.STATS["device_runs"] == 1
    assert {k: sharded[k] for k in COUNTS} == \
        {k: offload.STATS[k] for k in COUNTS}
    assert min(sharded[k] for k in COUNTS) > 0


def test_batch_driver_on_the_cpu_service(golden, tmp_path):
    """Two loci through python -m pintron_tpu_torch.batch --device cpu:
    both ok, both byte-identical to the goldens."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    cases = (("test-788", "AAMP"), ("test-AMBN", "AMBN"))
    rows = [f"{tmp_path / case}\t{golden(case) / 'genomic.txt'}\t"
            f"{golden(case) / 'ests.txt'}\t{gene}\thuman"
            for case, gene in cases]
    manifest = tmp_path / "jobs.tsv"
    manifest.write_text("\n".join(rows) + "\n")
    r = subprocess.run(
        [sys.executable, "-m", "pintron_tpu_torch.batch", "--manifest",
         str(manifest), "--jobs", "2", "--device", "cpu", "--summary",
         str(tmp_path / "sum.jsonl")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in
             (tmp_path / "sum.jsonl").read_text().splitlines()]
    summary = lines[-1]
    assert summary["ok"] == 2 and summary["failed"] == 0
    offload_stats = summary["service"]["offload"]
    assert offload_stats["pwm_windows"] > 0
    assert offload_stats["edit_problems"] > 0
    assert offload_stats["nw_problems"] > 0
    for case, _gene in cases:
        gold = golden(case)
        work = tmp_path / case
        assert (work / "pintron-full-output.json").read_bytes() == \
            (gold / "full.json").read_bytes(), case
        assert (work / "pintron-all-isoforms.gtf").read_bytes() == \
            (gold / "pintron-all-isoforms.gtf").read_bytes(), case


# three small loci at batch.py's defaults, a job a locus, each with its
# record count (the ``records`` of its ``pintron_locus`` span)
MANIFEST = (("test-788", "AAMP", 10), ("test-AMBN", "AMBN", 25),
            ("test-mattia1", "AAMP", 41))


@pytest.fixture(scope="module")
def manifest_run(golden, tmp_path_factory):
    """python -m pintron_tpu_torch.batch --device cpu --jobs 3 -k over
    three golden loci, one EST worker each, with PINTRON_TORCH_PROFILE
    set: (the root, the summary's lines, each span file's spans)."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    root = tmp_path_factory.mktemp("manifest")
    rows = [f"{root / case}\t{golden(case) / 'genomic.txt'}\t"
            f"{golden(case) / 'ests.txt'}\t{gene}\thuman"
            for case, gene, _n in MANIFEST]
    (root / "jobs.tsv").write_text("\n".join(rows) + "\n")
    env = _env()
    env["PINTRON_EST_WORKERS"] = "1"
    env[timing.PROFILE_ENV] = str(root / "prof")
    r = subprocess.run(
        [sys.executable, "-m", "pintron_tpu_torch.batch", "--manifest",
         str(root / "jobs.tsv"), "--jobs", "3", "--device", "cpu", "-k",
         "--summary", str(root / "sum.jsonl")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in
             (root / "sum.jsonl").read_text().splitlines()]
    spans = []
    for path in sorted((root / "prof").glob("spans-*.jsonl")):
        with open(path) as f:
            spans.append([json.loads(ln) for ln in f])
    return root, lines, spans


@pytest.mark.parametrize("case,gene,records", MANIFEST,
                         ids=[m[0] for m in MANIFEST])
def test_batch_manifest_at_its_defaults_matches_the_goldens(
        manifest_run, golden, case, gene, records):
    """Each job of a three-locus manifest, three at once: its STEP 2-4
    artifacts and finals equal the goldens, its line carries its
    start-up, and its spans hold one ``pintron_startup``, ending where
    its locus starts."""
    root, lines, spans = manifest_run
    assert lines[-1]["ok"] == len(MANIFEST) and lines[-1]["failed"] == 0
    gold, work = golden(case), root / case
    for name in STEP_ARTIFACTS:
        assert (work / name).read_bytes() == (gold / name).read_bytes(), \
            name
    assert (work / "pintron-full-output.json").read_bytes() == \
        (gold / "full.json").read_bytes()
    assert (work / "pintron-all-isoforms.gtf").read_bytes() == \
        (gold / "pintron-all-isoforms.gtf").read_bytes()
    (line,) = [ln for ln in lines[:-1] if ln["workdir"] == str(work)]
    assert line["ok"] and line["gene"] == gene
    assert line["startup_s"] > 0
    # the job's span file: the one whose locus has this locus's records
    (mine,) = [f for f in spans if any(
        s["name"] == "pintron_locus" and s["attrs"]["records"] == records
        for s in f)]
    (startup,) = [s for s in mine if s["name"] == "pintron_startup"]
    (locus,) = [s for s in mine if s["name"] == "pintron_locus"]
    assert startup["start"] < startup["end"] == locus["start"]
    assert startup["attrs"]["pid"] == startup["pid"] == locus["pid"]
    assert line["startup_s"] == pytest.approx(
        startup["end"] - startup["start"], abs=2e-3)
