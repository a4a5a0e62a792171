"""The port's golden sweep (``pintron_tpu_torch.tools.check_stage2``,
``check_e2e`` and ``check_batch_sweep``) on the CPU: STEP 2 on golden
loci with the plain PyTorch ops, byte-identical to the goldens and with
the JAX package's forced-mode counters; a ``cuda`` run without a card
refused before anything is written; a run with no device problem
failed; the finals' classification, which a shifted coordinate or a
stage-5 candidate unlike its host run turns into ``diff``; and the
batch driver through a CPU device service against one-at-a-time host
runs."""

import os
import shutil
import subprocess
import sys

import pytest
from test_torch_est_fact import FAMILY_COUNTS, _jax_forced_counts

from pintron_tpu_torch.pipeline import pintron_pipeline
from pintron_tpu_torch.stages import est_fact
from pintron_tpu_torch.tools import check_batch_sweep, check_e2e, check_stage2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clean_env(monkeypatch):
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.delenv("PINTRON_TORCH_SERVICE", raising=False)


@pytest.mark.parametrize("case", ["test-mattia1", "test-mattia3",
                                  "test-CPB2"])
def test_check_case_cpu_matches_golden_and_jax_counts(case, golden, tmp_path,
                                                      clean_env, monkeypatch):
    res = check_stage2.check_case(case, "cpu")
    assert res["status"] == "OK", res["differs"]
    assert min(res["families"].values()) > 0, res["families"]
    assert res["stats"]["device_runs"] == 1
    # the plain ops launch no kernel; the buckets are those launched
    assert set(res["launches"].values()) == {0}
    assert all(res["buckets"][fam] for fam in ("nw", "gap", "rb"))
    assert "PINTRON_FRESH_MEMO" not in os.environ
    assert {k: res["stats"][k] for k in FAMILY_COUNTS} == \
        _jax_forced_counts(golden(case), tmp_path, monkeypatch)


def test_check_stage2_cuda_without_a_card_writes_nothing(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PINTRON_DEVICE"}
    env.update(TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "pintron_tpu_torch.tools.check_stage2",
         "test-mattia1"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert "is_available() is false" in r.stderr
    assert "OK" not in r.stdout
    assert os.listdir(tmp_path) == []


def test_check_case_fails_when_no_problem_reaches_the_device(clean_env,
                                                             monkeypatch):
    """A device run that leaves offload.STATS without a device problem
    fails, whatever its bytes: the guard against a silent host run."""
    host_run = est_fact.run_est_fact
    monkeypatch.setattr(est_fact, "run_est_fact",
                        lambda work, device: host_run(work, device="host"))
    res = check_stage2.check_case("test-mattia1", "cpu")
    assert res["status"] == "FAIL"
    assert res["differs"] == [check_stage2.NO_DEVICE]
    shutil.rmtree(res["work"])
    shutil.rmtree(res["gold"])


@pytest.fixture(scope="module")
def mattia1_runs(tmp_path_factory):
    """mattia1's pipeline with --device cpu (the CLI) and with
    device="host" (in this process), intermediates kept."""
    root = tmp_path_factory.mktemp("e2e")
    gold = root / "gold"
    assert check_stage2.unpack("test-mattia1", str(gold))
    runs = {}
    for mode in ("cpu", "host"):
        runs[mode] = root / mode
        runs[mode].mkdir()
        for fn in check_stage2.INPUTS:
            shutil.copy(gold / fn, runs[mode] / fn)
    check_e2e.run_pipeline(str(runs["cpu"]), "AAMP", "cpu")
    pintron_pipeline(workdir=str(runs["host"]), output_filename="full.json",
                     gene="AAMP", organism="human", keep_intermediate=True,
                     device="host")
    return gold, runs


def _shift_gtf(work, dest):
    """A copy of a run with one exon start of its GTF moved by one."""
    shutil.copytree(work, dest)
    gtf = dest / check_e2e.FINALS[1]
    lines = gtf.read_text().splitlines(keepends=True)
    cols = lines[0].split("\t")
    cols[3] = str(int(cols[3]) + 1)
    lines[0] = "\t".join(cols)
    gtf.write_text("".join(lines))
    return dest


@pytest.mark.parametrize("host", [False, True])
def test_classify_case_cpu_run_is_byte(host, mattia1_runs):
    gold, runs = mattia1_runs
    host_work = str(runs["host"]) if host else None
    assert check_e2e.classify_case(str(runs["cpu"]), str(gold), "AAMP",
                                   host_work) == ("byte-identical", "byte")


@pytest.mark.parametrize("host", [False, True])
def test_classify_case_shifted_coordinate_is_diff(host, mattia1_runs,
                                                  tmp_path):
    """The stage-5 branch must not absorb a real change of the finals,
    with or without a host run beside it."""
    gold, runs = mattia1_runs
    work = _shift_gtf(runs["cpu"], tmp_path / "shifted")
    label, bucket = check_e2e.classify_case(
        str(work), str(gold), "AAMP", str(runs["host"]) if host else None)
    assert bucket == "diff", label


def test_classify_case_stage5_candidate_held_to_its_host_run(mattia1_runs,
                                                            tmp_path):
    """A run whose finals leave the golden's but whose stage-5 class
    holds is stage5-class only when its finals equal its host run's."""
    gold, runs = mattia1_runs
    work = _shift_gtf(runs["cpu"], tmp_path / "candidate")
    same = tmp_path / "same-host"
    same.mkdir()
    for fn in check_e2e.FINALS:
        shutil.copy(work / fn, same / fn)
    assert check_e2e.classify_case(str(work), str(gold), "AAMP",
                                   str(same)) == (
        "stage5-class (verified, == host)", "stage5-class")
    label, bucket = check_e2e.classify_case(str(work), str(gold), "AAMP",
                                            str(runs["host"]))
    assert bucket == "diff" and "--device host" in label, label


def test_classify_case_wrong_gene_label_is_diff(mattia1_runs):
    gold, runs = mattia1_runs
    label, bucket = check_e2e.classify_case(str(runs["cpu"]), str(gold),
                                            "AMBN", str(runs["host"]))
    assert bucket == "diff" and "gene" in label, label


def test_classify_case_stage2_artifact_change_is_diff(mattia1_runs, tmp_path):
    gold, runs = mattia1_runs
    work = tmp_path / "megs"
    shutil.copytree(runs["cpu"], work)
    with open(work / "megs.txt", "a") as f:
        f.write("\n")
    label, bucket = check_e2e.classify_case(str(work), str(gold), "AAMP",
                                            str(runs["host"]))
    assert bucket == "diff" and "megs.txt" in label, label


def test_sweep_cpu_batch_equals_solo(clean_env):
    res = check_batch_sweep.sweep(["test-mattia1", "test-mattia3",
                                   "test-issue-31"], "cpu", jobs=2)
    assert res["ok"], res
    assert res["skipped"] == ["test-issue-31"]
    assert sorted(res["cases"]) == ["test-mattia1", "test-mattia3"]
    for c in res["cases"].values():
        assert c["differs"] == [] and c["bucket"] == "byte", c
    summary = res["summary"]
    assert summary["ok"] == 2 and summary["device"] == "cpu"
    # every locus's batches went through the one CPU service
    stats = summary["service"]["stats"]
    assert min(stats[k] for k in ("nw_problems", "gap_problems",
                                  "rb_problems", "pwm_windows")) > 0, stats
