"""The port's K-band offload (``pintron_tpu_torch.ops.offload``) on the
CPU against the JAX package's ``eval_kband`` and the native ep_kband
verdicts, plus its dispatch watchdog."""

import threading

import numpy as np
import pytest
import torch

import pintron_tpu.ops.offload as jax_off
from pintron_tpu.native import get_lib
from pintron_tpu_torch.ops import offload
from test_device_offload import _host_ep_kband_ok

ALPHA = np.array(list("ACGT"))


def offload_problems():
    """The problem set of tests/test_device_offload.py::
    test_eval_kband_matches_native: identical, mutated, truncated and
    unrelated pairs, long exons, and masked/ambiguous bytes."""
    rng = np.random.default_rng(11)
    problems = []
    for _ in range(120):
        n = int(rng.integers(1, 300))
        g = "".join(rng.choice(ALPHA, n)).encode()
        mode = int(rng.integers(0, 4))
        if mode == 0:
            e = g
        elif mode == 1:
            el = list(g.decode())
            for _ in range(int(rng.integers(0, 8))):
                el[int(rng.integers(0, n))] = str(rng.choice(ALPHA))
            e = "".join(el).encode()
        elif mode == 2:
            e = g[: max(1, n - int(rng.integers(0, 12)))]
        else:
            e = "".join(rng.choice(ALPHA,
                                   int(rng.integers(1, 300)))).encode()
        problems.append((g, e, int(rng.integers(0, 12))))
    for n in (800, 1500):
        g = "".join(rng.choice(ALPHA, n)).encode()
        el = list(g.decode())
        for _ in range(20):
            el[int(rng.integers(0, n))] = str(rng.choice(ALPHA))
        problems.append((g, "".join(el).encode(), 30))
    masked = np.array(list("ACGTN*#n"))
    for _ in range(40):
        n = int(rng.integers(10, 200))
        g = "".join(rng.choice(masked, n)).encode()
        el = list(g.decode())
        for _ in range(int(rng.integers(0, 10))):
            el[int(rng.integers(0, n))] = str(rng.choice(masked))
        e = "".join(el).encode()[: max(1, n - int(rng.integers(0, 6)))]
        problems.append((g, e, int(rng.integers(0, 10))))
    return problems


@pytest.fixture
def cpu_offload(monkeypatch):
    monkeypatch.setattr(offload, "_DEVICE", torch.device("cpu"))
    monkeypatch.setattr(offload, "_WEDGED", False)
    offload.reset_stats()
    return offload


def test_eval_kband_matches_jax_and_native(cpu_offload):
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    problems = offload_problems()
    got = cpu_offload.eval_kband(problems)
    assert got is not None and got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_off.eval_kband(problems))
    for i, (g, e, ub) in enumerate(problems):
        assert int(got[i]) == _host_ep_kband_ok(lib, g, e, ub), i
    st = cpu_offload.STATS
    assert st["problems"] == len(problems)
    assert 0 < st["device_problems"] < len(problems)
    assert st["batches"] >= 2           # one full + one band group at least


def test_eval_kband_needs_a_device(monkeypatch):
    monkeypatch.setattr(offload, "_DEVICE", None)
    with pytest.raises(RuntimeError, match="set_device"):
        offload.eval_kband([(b"ACGT", b"ACGA", 1)])


@pytest.mark.parametrize("timeout_s", ["600", "0"])
def test_failing_batch_raises(cpu_offload, monkeypatch, timeout_s):
    """A batch that fails (a kernel that does not build or launch) is
    raised, under the watchdog thread or inline, and latches nothing:
    the work is never moved to the host DP for it."""
    def boom(*_a):
        raise RuntimeError("kernel fault")

    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", timeout_s)
    monkeypatch.setattr(cpu_offload, "_eval_kband_device", boom)
    with pytest.raises(RuntimeError, match="kernel fault"):
        cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)])
    assert not cpu_offload.device_wedged()
    monkeypatch.setattr(cpu_offload, "_eval_kband_device",
                        lambda *_a: np.ones(1, dtype=np.int64))
    assert cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)]).tolist() == [1]


def test_hung_batch_times_out(cpu_offload, monkeypatch):
    release = threading.Event()
    monkeypatch.setattr(cpu_offload, "_eval_kband_device",
                        lambda *_a: release.wait(30))
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "0.2")
    try:
        assert cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)]) is None
    finally:
        release.set()
    assert cpu_offload.STATS["device_timeouts"] == 1
    assert cpu_offload.device_wedged()


def test_wedged_device_short_circuits(cpu_offload, monkeypatch):
    """After a timeout every later batch reports None without running."""
    monkeypatch.setattr(cpu_offload, "_WEDGED", True)
    ran = []
    monkeypatch.setattr(cpu_offload, "_eval_kband_device",
                        lambda *_a: ran.append(1))
    assert cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)]) is None
    assert not ran


def test_encode_matches_reference():
    seqs = [b"ACGT", b"", b"N*#n\xc8"]
    for got, want in zip(offload._encode(seqs, 8, rows=5),
                         jax_off._encode(seqs, 8, rows=5)):
        np.testing.assert_array_equal(got, want)
    assert [offload._p2(x) for x in (1, 17, 64)] == [16, 32, 64]
    assert [offload._p4(x) for x in (1, 17, 1025)] == [16, 64, 4096]
