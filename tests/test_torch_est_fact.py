"""The port's STEP 2 (``pintron_tpu_torch.stages.est_fact``) on the CPU:
the device flow with the plain PyTorch ops must reproduce the golden
stage-2 artifacts byte for byte, with every DP family's results really
coming from the device batches, as many of them as the JAX package's
device flow sends to its device."""

import shutil
import threading

import pytest
import torch

from pintron_tpu_torch.native import get_lib
from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.stages import est_fact

STAGE2 = ("raw-multifasta-out.txt", "processed-ests.txt", "megs.txt",
          "processed-megs.txt", "meg-edges.txt")


def _workdir(golden, case, tmp_path):
    gold = golden(case)
    work = tmp_path / case
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    return gold, work


def _assert_stage2_equal(gold, work):
    for name in STAGE2:
        assert (work / name).read_bytes() == (gold / name).read_bytes(), \
            f"{name} differs from golden"


@pytest.fixture
def device_flow(monkeypatch):
    lib = get_lib()
    if lib is None or not hasattr(lib, "est_collect_noisy"):
        pytest.skip("native collect entry unavailable")
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.setenv("PINTRON_FRESH_MEMO", "1")
    offload.reset_stats()
    return offload


FAMILY_COUNTS = ("nw_problems", "gap_problems", "rb_problems",
                 "device_problems", "device_cells")


def _jax_forced_counts(gold, tmp_path, monkeypatch, host_families=()):
    """Run pintron_tpu's device flow (JAX on the CPU) with every family
    forced on, but those in ``host_families`` (kband, nw, gap, rb) at 0,
    and return its offload counters."""
    pytest.importorskip("jax")
    import pintron_tpu.native as jax_native
    import pintron_tpu.ops.offload as jax_off
    import pintron_tpu.stages.est_fact as jax_est_fact
    work = tmp_path / "jax"
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    for flag in ("", "_NW", "_GAP", "_RB", "_KBAND"):
        monkeypatch.setenv(f"PINTRON_DEVICE{flag}",
                           "0" if flag[1:].lower() in host_families else "1")
    monkeypatch.setattr(jax_off, "STATS", dict.fromkeys(jax_off.STATS, 0))
    try:
        jax_est_fact.run_est_fact(str(work))
    finally:
        for flag in ("", "_NW", "_GAP", "_RB", "_KBAND"):
            monkeypatch.delenv(f"PINTRON_DEVICE{flag}")
        # a warm native memo would leave a later run of the same locus
        # in this process without device problems
        jax_lib = jax_native.get_lib()
        if jax_lib is not None and hasattr(jax_lib, "ep_memo_wipe"):
            jax_lib.ep_memo_wipe()
    _assert_stage2_equal(gold, work)
    return {k: jax_off.STATS.get(k, 0) for k in FAMILY_COUNTS}


@pytest.mark.parametrize("case", ["test-AMBN", "test-TP53"])
def test_stage2_cpu_device_byte_identical(case, golden, tmp_path,
                                          device_flow, monkeypatch):
    gold, work = _workdir(golden, case, tmp_path)
    est_fact.run_est_fact(str(work), device="cpu")
    stats = dict(device_flow.STATS)
    assert min(stats[k] for k in FAMILY_COUNTS) > 0, stats
    assert stats["device_runs"] == 1
    assert stats["device_timeouts"] == 0
    _assert_stage2_equal(gold, work)
    assert {k: stats[k] for k in FAMILY_COUNTS} == \
        _jax_forced_counts(gold, tmp_path, monkeypatch)


def _only_on_the_card(family, monkeypatch):
    """Route every family but ``family`` to the host DP, so that no real
    batch runs under a test's 1 s watchdog (788's NW batch takes
    seconds in the plain version)."""
    for fam in offload.FAMILIES:
        if fam != family:
            monkeypatch.setenv(offload.family_env(fam), "0")


def test_hung_kband_batch_stops_the_stage(golden, tmp_path, device_flow,
                                          monkeypatch):
    """A hung K-band batch trips the watchdog and stops STEP 2: the
    native cascade never recomputes its checks on the host."""
    _gold, work = _workdir(golden, "test-788", tmp_path)
    _only_on_the_card("kband", monkeypatch)
    release = threading.Event()
    monkeypatch.setattr(device_flow, "_eval_kband_device",
                        lambda *_a: release.wait(30))
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "1")
    try:
        with pytest.raises(device_flow.DeviceTimeout,
                           match="K-band device batch"):
            est_fact.run_est_fact(str(work), device="cpu")
    finally:
        release.set()
    assert device_flow.STATS["device_timeouts"] == 1
    assert not (work / "raw-multifasta-out.txt").exists()


# test-788 evaluates its one chunk inline, TP53 its two chunks on the
# executor thread
@pytest.mark.parametrize("case", ["test-788", "test-TP53"])
def test_failing_batch_raises_out_of_the_stage(case, golden, tmp_path,
                                               device_flow, monkeypatch):
    """A K-band batch that fails (build, launch, shape) stops STEP 2;
    the host DP never stands in for it."""
    _gold, work = _workdir(golden, case, tmp_path)

    def boom(*_a):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(device_flow, "_eval_kband_device", boom)
    with pytest.raises(RuntimeError, match="kernel fault"):
        est_fact.run_est_fact(str(work), device="cpu")
    assert device_flow.STATS["device_timeouts"] == 0
    assert not (work / "raw-multifasta-out.txt").exists()


FAMILIES = ["_eval_nw_device", "_eval_gap_device", "_eval_rb_device"]


@pytest.mark.parametrize("entry", FAMILIES)
def test_failing_family_batch_raises_out_of_the_stage(entry, golden,
                                                      tmp_path, device_flow,
                                                      monkeypatch):
    """A failing NW, gap or refine-borders batch stops STEP 2."""
    _gold, work = _workdir(golden, "test-788", tmp_path)

    def boom(*_a):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(device_flow, entry, boom)
    with pytest.raises(RuntimeError, match="kernel fault"):
        est_fact.run_est_fact(str(work), device="cpu")
    assert device_flow.STATS["device_timeouts"] == 0
    assert not (work / "raw-multifasta-out.txt").exists()


@pytest.mark.parametrize("entry", FAMILIES)
def test_hung_family_batch_stops_the_stage(entry, golden, tmp_path,
                                          device_flow, monkeypatch):
    """A hung NW, gap or refine-borders batch trips the watchdog and
    stops STEP 2: the host DP never computes the rest."""
    _gold, work = _workdir(golden, "test-788", tmp_path)
    _only_on_the_card(entry.split("_")[2], monkeypatch)
    release = threading.Event()
    monkeypatch.setattr(device_flow, entry, lambda *_a: release.wait(30))
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "1")
    try:
        with pytest.raises(device_flow.DeviceTimeout):
            est_fact.run_est_fact(str(work), device="cpu")
    finally:
        release.set()
    assert device_flow.STATS["device_timeouts"] == 1
    assert not (work / "raw-multifasta-out.txt").exists()


def test_missing_native_entry_raises(monkeypatch):
    class Partial:
        est_collect_noisy = epm_fill_noisy = None

    monkeypatch.setattr(est_fact, "get_lib", lambda: Partial())
    with pytest.raises(RuntimeError, match="epm_fill_rb"):
        est_fact._native_lib()


def test_host_path_when_no_device(golden, tmp_path, monkeypatch):
    """device="host": the port's copy of the native host path (the fork
    pool), no device batch."""
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.setenv("PINTRON_EST_WORKERS", "2")
    gold, work = _workdir(golden, "test-AMBN", tmp_path)
    offload.reset_stats()
    est_fact.run_est_fact(str(work), device="host")
    assert offload.STATS["device_problems"] == 0
    _assert_stage2_equal(gold, work)


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        est_fact.run_est_fact(str(tmp_path), device="cuda")


def test_jax_device_flag_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("PINTRON_DEVICE", "1")
    with pytest.raises(RuntimeError, match="PINTRON_DEVICE"):
        est_fact.run_est_fact(str(tmp_path), device="cpu")
