"""The port's STEP 2 on real data over a mesh and over several
processes, on the CPU: AMBN's STEP 2 with ``PINTRON_TORCH_MESH=8``, and
``parallel.multihost``'s two ranks on disjoint EST shards, their batches
on one CPU device service, a gloo group that all-reduces their counts
and all-gathers their candidate intron sets, and the parent's merge,
byte for byte the goldens; the native host mode likewise; the index
the ranks attach, the run's own and of this package's layout; a
rank that fails or never reaches the group failing the run with nothing
left running; and ``graft_entry.dryrun_multichip``, which runs both."""

import json
import logging
import os
import shutil
import tempfile
import textwrap
import time

import numpy as np
import pytest
import torch

from pintron_tpu_torch.graft_entry import dryrun_multichip
from pintron_tpu_torch.index import gst
from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.parallel import multihost
from pintron_tpu_torch.regression import STAGE2_ARTIFACTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("nw_problems", "gap_problems", "rb_problems")


@pytest.fixture(autouse=True)
def cpu_run(monkeypatch):
    """One intra-op thread here, in the service and in the ranks (the
    plain ops are many tiny calls, and OpenMP teams spinning against the
    other test workers' stall them), and no service or mesh of the
    caller's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv(offload.SERVICE_ENV, raising=False)
    monkeypatch.delenv(offload.MESH_ENV, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workdir(golden, tmp_path, name, case="test-788"):
    gold = golden(case)
    work = tmp_path / name
    work.mkdir()
    for fn in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / fn, work / fn)
    return gold, work


def _assert_golden(gold, work):
    for name in STAGE2_ARTIFACTS:
        assert (gold / name).read_bytes() == (work / name).read_bytes(), \
            f"{name} differs from golden"


def _left_running():
    """This process's children that are a rank or a device service."""
    me = str(os.getpid())
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if ppid == me and ("parallel.multihost" in cmd
                           or "devservice" in cmd):
            left.append(cmd)
    return left


def test_mesh_step2_on_ambn_is_byte_identical(golden, tmp_path,
                                              monkeypatch, caplog):
    """STEP 2 with PINTRON_TORCH_MESH=8 on the CPU: the goldens byte for
    byte, the mesh in the device-flow line, and the real K-band batch
    it collected gives the same verdicts over 8 shards and over 1."""
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    case = golden("test-AMBN")
    for fn in ("genomic.txt", "ests.txt"):
        shutil.copy(case / fn, tmp_path / fn)
    captured = []
    orig = offload.eval_kband

    def capture(problems):
        ok = orig(problems)
        captured.append((list(problems), ok))
        return ok

    monkeypatch.setattr(offload, "eval_kband", capture)
    monkeypatch.setenv(offload.MESH_ENV, "8")
    monkeypatch.setenv("PINTRON_FRESH_MEMO", "1")
    caplog.set_level(logging.INFO, logger="pintron")
    sharded0 = offload.STATS["mesh_batches"]
    run_est_fact(str(tmp_path), device="cpu")
    assert offload.STATS["mesh_batches"] > sharded0
    for name in STAGE2_ARTIFACTS:
        assert (case / name).read_bytes() == (tmp_path / name).read_bytes(), \
            f"{name} differs under the 8-shard mesh"
    flow = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("est-fact device flow: ")]
    assert json.loads(flow[-1].split(": ", 1)[1])["mesh"] == 8
    assert captured, "no real problem reached the device"
    monkeypatch.setenv(offload.MESH_ENV, "1")
    for problems, ok_mesh in captured:
        np.testing.assert_array_equal(
            ok_mesh, offload._eval_kband_device(problems,
                                                torch.device("cpu")))


def test_collective_run_is_byte_identical(golden, tmp_path, monkeypatch):
    """Two ranks through a CPU service on 788: the goldens byte for
    byte, both ranks agree on the reduced counts and the merged intron
    set, and every family the one-process device flow runs on the
    device runs there in the ranks too (the JAX parent turns NW, gap and
    rb off in its workers, ROADMAP C5)."""
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    gold, one = _workdir(golden, tmp_path, "one")
    monkeypatch.setenv("PINTRON_FRESH_MEMO", "1")
    offload.reset_stats()
    run_est_fact(str(one), device="cpu")
    single = dict(offload.STATS)
    assert any(single[k] > 0 for k in FAMILIES)

    _gold, work = _workdir(golden, tmp_path, "mh")
    # a temporary directory of the run's own, short enough for the
    # service's AF_UNIX socket path (tmp_path may not be)
    tmp = tempfile.mkdtemp(prefix="mh")
    monkeypatch.setenv("TMPDIR", tmp)
    monkeypatch.setattr(tempfile, "tempdir", tmp)
    try:
        report = multihost.run_est_fact_multiprocess(str(work), 2,
                                                     device="cpu")
        # the index, the group's store and the service's socket went
        # with the run
        assert os.listdir(tmp) == []
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _assert_golden(gold, work)
    assert report["collective"] and report["device"] == "cpu"
    ranks = report["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert sum(r["units"] for r in ranks) == 10
    for r in ranks:
        assert r["global_counts"] == report["global_counts"]
    assert report["global_counts"][0] == sum(r["local_problems"]
                                             for r in ranks)
    assert report["merged_candidate_introns"] >= max(
        r["local_candidates"] for r in ranks) > 0
    for k in FAMILIES:
        if single[k] > 0:
            assert sum(r["stats"][k] for r in ranks) > 0, k
    assert report["service"]["stats"]["requests"] > 0
    assert _left_running() == []


def test_host_mode_is_byte_identical(golden, tmp_path):
    gold, work = _workdir(golden, tmp_path, "mhh")
    report = multihost.run_est_fact_multiprocess(str(work), 2,
                                                 collective=False)
    _assert_golden(gold, work)
    assert report["collective"] is False and report["service"] is None
    assert sum(r["units"] for r in report["ranks"]) == 10
    assert "global_counts" not in report


def test_a_rank_attaches_only_its_runs_index(tmp_path, monkeypatch):
    """No index cache outlives a run, so neither package attaches an
    index the other wrote (ROADMAP C5): the parent writes the index into
    the run's own directory, and a rank refuses one whose ``.ready``
    names another layout than INDEX_FORMAT."""
    gen = b"ACGTTGCA" * 64
    prefix = str(tmp_path / "index")
    multihost._write_index(gen, prefix)
    multihost._wait_index(prefix, time.time() + 5)
    assert gst.SuffixTree.load(prefix).text == gst.SuffixTree(gen).text
    monkeypatch.setattr(gst, "INDEX_FORMAT", gst.INDEX_FORMAT + "-next")
    with pytest.raises(RuntimeError, match="layout"):
        multihost._wait_index(prefix, time.time() + 5)


# (what the parent raises, the run's timeout): a rank that exits fails
# the run at once; one that never joins the group fails it at the timeout
FAULTS = {"exit": ("exited with 3", 300.0), "hang": ("did not finish", 25.0)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_failed_rank_fails_the_run(golden, tmp_path, monkeypatch, fault):
    """Rank 1 exits with 3, or sleeps, as soon as it starts (a
    sitecustomize.py on the ranks' PYTHONPATH), while rank 0 runs its
    shard and waits in the group: the parent raises within the run's
    timeout, and no rank or service is left."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(f"""
        import json, os, sys, time

        if "--child" in sys.argv:
            spec = json.loads(sys.argv[sys.argv.index("--child") + 1])
            if spec["rank"] == 1:
                if {fault!r} == "exit":
                    os._exit(3)
                time.sleep(3600)
    """))
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}{os.pathsep}{REPO}")
    _gold, work = _workdir(golden, tmp_path, "mh")
    match, timeout = FAULTS[fault]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        multihost.run_est_fact_multiprocess(str(work), 2, device="cpu",
                                            timeout=timeout)
    assert time.monotonic() - t0 < timeout + 20
    assert _left_running() == []
    assert not (work / "megs.txt").exists()


def test_dryrun_multichip_on_the_cpu():
    """The AMBN pipeline over a 2-shard mesh and over two processes:
    byte for byte the goldens (dryrun_multichip raises otherwise)."""
    before = os.environ.get(offload.MESH_ENV)
    report = dryrun_multichip(2, "cpu")
    assert os.environ.get(offload.MESH_ENV) == before
    assert report["mesh"] == 2 and report["step2_s"] > 0
    assert report["mesh_batches"] > 0
    mp = report["multiprocess"]
    assert [r["rank"] for r in mp["ranks"]] == [0, 1]
    assert mp["global_counts"][1] > 0
