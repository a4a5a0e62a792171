"""The port's bench (``pintron_tpu_torch.bench``) on the CPU at one
repetition: one JSON line with the headline and every device channel,
the stored baseline, and a channel that fails (or a child that times
out, or fails after its last channel) named in ``device_channels_error``
with a non-zero exit."""

import json
import os
import textwrap

import pytest
import torch

from pintron_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_REP = ["--device", "cpu", "--blocks", "1", "--runs", "1",
           "--warm-runs", "1", "--kernel-batch", "64", "--kernel-sets", "2",
           "--chain", "2", "--kernel-reps", "1", "--mode-runs", "1",
           "--stress-case", "20000", "30", "4000", "--stress-runs", "1"]
HEADLINE = ("metric", "value", "unit", "vs_baseline", "baseline_ests_per_s",
            "baseline_source", "host_ests_per_s", "warm_repeat_ests_per_s")
CHANNEL_KEYS = ("device_kband_kernel_cells_per_s",
                "device_kband_plain_cells_per_s",
                "device_kband_kernel_vs_plain", "device_kband_bound_share",
                "device_card", "device_mode_ests_per_s",
                "device_mode_problems_offloaded", "device_cell_fraction",
                "host_cells_by_family", "device_mode_latches",
                "device_mode_forced_ests_per_s",
                "device_mode_forced_problems_offloaded",
                "device_cell_fraction_forced", "stress_device_ests_per_s",
                "stress_cpu_ests_per_s", "stress_device_vs_cpu",
                "stress_device_problems",
                "stress_device_kband_only_ests_per_s")


@pytest.fixture
def one_thread(monkeypatch):
    """One intra-op thread here and in the bench's child processes: the
    plain ops are many tiny calls, and OpenMP teams spinning against the
    other test workers' stall them."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PINTRON_EST_WORKERS", "2")
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.delenv("PINTRON_TORCH_SERVICE", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_on_ambn_prints_one_json_line(capsys, one_thread):
    assert bench.main(ONE_REP) == 0
    out = _line(capsys)
    for key in HEADLINE + CHANNEL_KEYS:
        assert key in out and out[key] is not None, key
    assert out["baseline_source"] == "stored"
    assert out["baseline_ests_per_s"] == bench.BASELINE_ESTS_PER_S
    assert out["vs_baseline"] == round(out["value"] / 175.0, 3)
    assert out["device"] == "cpu" and out["device_card"] == "cpu"
    assert out["value"] > 0 and out["host_ests_per_s"] > 0
    assert out["device_kband_max_abs_err"] == 0
    # the forced run's; the auto run's keys (the JAX bench's unsuffixed
    # ones) carry what the tuner kept on the card
    assert out["device_mode_forced_problems_offloaded"] > 0
    assert 0 < out["device_cell_fraction_forced"] < 1
    assert 0 <= out["device_cell_fraction"] < 1
    assert sorted(out["device_mode_latches"]) == ["gap", "kband", "nw", "rb"]
    assert out["stress_case"] == [20000, 30, 4000]
    assert out["stress_device_problems"] > 0
    assert "device_channels_error" not in out


def test_a_channel_that_raises_fails_the_bench(capsys, one_thread,
                                              monkeypatch, tmp_path):
    """The channels run in a child process: a sitecustomize on its
    PYTHONPATH replaces the kernel channel with one that raises."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        from pintron_tpu_torch import bench

        def broken(opts):
            raise RuntimeError("the kernel channel is broken")

        bench.CHANNELS["kernel"] = broken
    """))
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}{os.pathsep}{REPO}")
    assert bench.main(ONE_REP) == 1
    out = _line(capsys)
    assert out["device_channels_error"] == {
        "channel": "kernel",
        "stderr": "RuntimeError: the kernel channel is broken"}
    assert out["value"] > 0
    assert "device_mode_ests_per_s" not in out


def test_a_child_past_its_timeout_is_an_error(one_thread, tmp_path):
    res = bench.run_device_channels(
        {"device": "cpu", "channels": ["mode", "stress"],
         "gold": str(tmp_path), "n_ests": 1, "mode_runs": 1,
         "stress_case": [20000, 30, 4000], "stress_runs": 1}, timeout=0.5)
    err = res["device_channels_error"]
    assert err["channel"] == "mode"
    assert err["stderr"].startswith("timed out after 0.5 s")


def test_a_child_that_fails_after_its_last_channel_is_an_error(
        one_thread, monkeypatch, tmp_path):
    """Every channel done, then the child exits non-zero (as in a
    failed teardown): the error names the exit, and the channels'
    results stay."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        import atexit, os, sys
        from pintron_tpu_torch import bench

        def fail_at_exit():
            sys.stdout.flush()
            sys.stderr.write("RuntimeError: teardown failed\\n")
            sys.stderr.flush()
            os._exit(3)

        def kernel(opts):
            return {"device_kband_kernel_ms": 1.0}

        bench.CHANNELS["kernel"] = kernel
        atexit.register(fail_at_exit)
    """))
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}{os.pathsep}{REPO}")
    res = bench.run_device_channels({"device": "cpu", "channels": ["kernel"]},
                                    timeout=300)
    assert res["device_channels_error"] == {
        "channel": "exit", "stderr": "RuntimeError: teardown failed"}
    assert res["device_kband_kernel_ms"] == 1.0
