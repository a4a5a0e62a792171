"""The port's offload (``pintron_tpu_torch.ops.offload``) on the CPU
against the JAX package's entries (``eval_kband``, ``eval_nw``,
``eval_gap``, ``eval_rb``) and the native ep_kband verdicts, plus its
dispatch watchdog, its per-problem size filter and its counters."""

import sys
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


def _budget_problems(rng, specs):
    """(gen, est, ub) problems: est is gen with ``edits`` point
    mutations (an unrelated sequence for edits < 0), cut to ``m``."""
    problems = []
    for n, m, edits, ub in specs:
        g = "".join(rng.choice(ALPHA, n)).encode()
        el = list(g.decode())
        for _ in range(edits):
            el[int(rng.integers(0, n))] = str(rng.choice(ALPHA))
        if edits < 0:   # an unrelated sequence: distance far over ub
            el = list(rng.choice(ALPHA, n))
        problems.append((g, "".join(el).encode()[:m], ub))
    return problems


@pytest.fixture
def one_torch_thread():
    """Batches as wide as k_max 512's band on one intra-op thread: the
    suite runs several workers at once, and their OpenMP teams spinning
    against each other stall such a batch for minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_budget_beyond_the_band_kernel_goes_to_the_full_matrix(
        cpu_offload, monkeypatch, fresh_jax_stats, one_torch_thread):
    """Budgets of 257 to 512 go to the band kernel at k_max 512, as in
    the JAX package, and the counters equal its counters; a budget over
    kband.KMAX (512) never reaches the band kernel (which raises for
    it): the full-matrix kernel gives the same verdict as the native
    ep_kband, and its cells count as len(a) * len(b)."""
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    widths, full = [], []
    band_real = cpu_offload.banded_edit_distance_cuda
    full_real = cpu_offload.batch_edit_distance_score_cuda

    def band_spy(*a, k_max, **k):
        widths.append(k_max)
        return band_real(*a, k_max=k_max, **k)

    def full_spy(*a, **k):
        full.append(a[0].shape[0])
        return full_real(*a, **k)

    monkeypatch.setattr(cpu_offload, "banded_edit_distance_cuda", band_spy)
    monkeypatch.setattr(cpu_offload, "batch_edit_distance_score_cuda",
                        full_spy)
    problems = _budget_problems(rng, ((600, 595, 100, 260),
                                      (800, 795, -1, 260),
                                      (600, 595, 20, 30),
                                      (700, 695, 150, 257),
                                      (1000, 990, 40, 480)))
    got = cpu_offload.eval_kband(problems)
    assert widths == [512] and full == []
    for i, (g, e, ub) in enumerate(problems):
        assert int(got[i]) == _host_ep_kband_ok(lib, g, e, ub), i
    assert got.tolist()[:2] == [1, 0]
    np.testing.assert_array_equal(got, jax_off.eval_kband(problems))
    assert _port_counts(cpu_offload) == _jax_counts()

    # over KMAX, the band not covering the matrix: the full matrix
    assert cpu_offload._full_matrix(1030, 513)
    assert not cpu_offload._full_matrix(1030, 512)
    # the same route end to end at a small width, with KMAX lowered
    monkeypatch.setattr(cpu_offload, "KMAX", 8)
    cpu_offload.reset_stats()
    widths.clear()
    over = _budget_problems(rng, ((120, 115, 3, 9), (120, 115, -1, 9)))
    got = cpu_offload.eval_kband(over)
    assert widths == [] and full == [64]
    for i, (g, e, ub) in enumerate(over):
        assert int(got[i]) == _host_ep_kband_ok(lib, g, e, ub), i
    assert got.tolist() == [1, 0]
    assert cpu_offload.STATS["device_cells"] == 2 * 120 * 115


def test_eval_kband_needs_a_device(monkeypatch):
    monkeypatch.setattr(offload, "_DEVICE", None)
    with pytest.raises(RuntimeError, match="set_device"):
        offload.eval_kband([(b"ACGT", b"ACGA", 1)])


@pytest.mark.parametrize("timeout_s", ["600", "0"])
def test_failing_batch_raises(cpu_offload, monkeypatch, timeout_s):
    """A batch that fails (a kernel that does not build or launch) is
    raised, under the watchdog thread or inline, and the next batch
    runs: the work is never moved to the host DP for it."""
    def boom(*_a):
        raise RuntimeError("kernel fault")

    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", timeout_s)
    monkeypatch.setattr(cpu_offload, "_eval_kband_device", boom)
    with pytest.raises(RuntimeError, match="kernel fault"):
        cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)])
    assert cpu_offload.STATS["device_timeouts"] == 0
    monkeypatch.setattr(cpu_offload, "_eval_kband_device",
                        lambda *_a: np.ones(1, dtype=np.int64))
    assert cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)]).tolist() == [1]


def test_hung_batch_times_out(cpu_offload, monkeypatch):
    """A batch that hangs past the dispatch timeout raises; no host
    path stands in for it."""
    release = threading.Event()
    monkeypatch.setattr(cpu_offload, "_eval_kband_device",
                        lambda *_a: release.wait(30))
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "0.2")
    try:
        with pytest.raises(cpu_offload.DeviceTimeout,
                           match="K-band device batch"):
            cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)])
    finally:
        release.set()
    assert cpu_offload.STATS["device_timeouts"] == 1


def test_wedged_device_short_circuits(cpu_offload, monkeypatch):
    """Nothing latches after a timeout: the next batch runs on the
    device again, and every entry raises on its own timeout."""
    release = threading.Event()
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "0.2")
    monkeypatch.setattr(cpu_offload, "_eval_kband_device",
                        lambda *_a: release.wait(30))
    monkeypatch.setattr(cpu_offload, "_eval_nw_device",
                        lambda *_a: release.wait(30))
    try:
        with pytest.raises(cpu_offload.DeviceTimeout):
            cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)])
        with pytest.raises(cpu_offload.DeviceTimeout,
                           match="endpoint NW device batch"):
            cpu_offload.eval_nw([(b"ACGT", b"ACGA")])
    finally:
        release.set()
    ran = []
    monkeypatch.setattr(cpu_offload, "_eval_kband_device",
                        lambda *_a: ran.append(1) or np.ones(1, np.int64))
    assert cpu_offload.eval_kband([(b"ACGT", b"ACGA", 1)]).tolist() == [1]
    assert ran == [1]
    assert cpu_offload.STATS["device_timeouts"] == 2


def test_silent_service_handshake_times_out(monkeypatch, tmp_path):
    """A service that accepts the connection and never answers (one
    stuck in a batch answers no ``hello``): the dial and the handshake
    raise DeviceTimeout within the dispatch timeout."""
    import socket
    import time
    path = str(tmp_path / "silent.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    held = []
    threading.Thread(target=lambda: held.append(srv.accept()),
                     daemon=True).start()
    monkeypatch.setenv(offload.SERVICE_ENV, path)
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "1")
    monkeypatch.setattr(offload, "_SERVICE", None)
    monkeypatch.setattr(offload, "_DEVICE", None)
    t0 = time.monotonic()
    try:
        with pytest.raises(offload.DeviceTimeout, match="handshake"):
            offload.use_device("cpu")
        assert time.monotonic() - t0 < 10
        assert offload._SERVICE is None and offload._DEVICE is None
    finally:
        for conn, _addr in held:
            conn.close()
        srv.close()


def test_device_call_raises_past_its_timeout(monkeypatch):
    """device_call itself: a stub that sleeps past a tiny timeout
    raises DeviceTimeout; one that returns in time gives its result."""
    import time
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "0.05")
    offload.reset_stats()
    with pytest.raises(offload.DeviceTimeout, match="stub batch"):
        offload.device_call(time.sleep, 0.5, what="stub batch")
    assert offload.STATS["device_timeouts"] == 1
    assert offload.device_call(lambda x: x + 1, 41, what="stub") == 42


def test_encode_matches_reference():
    seqs = [b"ACGT", b"", b"N*#n\xc8"]
    for got, want in zip(offload._encode(seqs, 8, rows=5),
                         jax_off._encode(seqs, 8, rows=5)):
        np.testing.assert_array_equal(got, want)
    assert [offload._p2(x) for x in (1, 17, 64)] == [16, 32, 64]
    assert [offload._p4(x) for x in (1, 17, 1025)] == [16, 64, 4096]


# ---- the NW, gap and refine-borders entries --------------------------------

def pair_problems(seed, count=90):
    """(est_window, gen_window) pairs: e == g, gen with an intron
    inserted, unrelated pairs, N/n wildcards, several (N, M) buckets."""
    rng = np.random.default_rng(seed)
    wild = np.array(list("ACGTNn"))
    probs = [(b"A", b"A"), (b"ACGT", b"T"), (b"N", b"ACGTTA")]
    for i in range(count):
        e = "".join(rng.choice(wild, int(rng.integers(1, 90)))).encode()
        if i % 3 == 0:
            g = e
        elif i % 3 == 1:
            cut = int(rng.integers(0, len(e) + 1))
            intron = "".join(rng.choice(ALPHA, int(rng.integers(0, 300))))
            g = e[:cut] + intron.encode() + e[cut:]
        else:
            g = "".join(rng.choice(wild, int(rng.integers(1, 300)))).encode()
        probs.append((e, g))
    probs.append(("".join(rng.choice(ALPHA, 300)).encode(),
                  "".join(rng.choice(ALPHA, 1500)).encode()))
    return probs


def _assert_prefixes_equal(a, b, lens):
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(a[i, :n], b[i, :n])


def _jax_counts():
    return {k: jax_off.STATS.get(k, 0) for k in
            ("problems", "device_problems", "device_cells", "nw_problems",
             "gap_problems", "rb_problems", "batches")}


def _port_counts(off):
    return {k: off.STATS[k] for k in _jax_counts()}


@pytest.fixture
def fresh_jax_stats(monkeypatch):
    monkeypatch.setattr(jax_off, "STATS", dict.fromkeys(jax_off.STATS, 0))


def test_eval_nw_matches_jax(cpu_offload, fresh_jax_stats):
    problems = pair_problems(5)
    ops_j, n_j = jax_off.eval_nw(problems)
    ops, nsteps, evaluated = cpu_offload.eval_nw(problems)
    assert evaluated.all() and nsteps.dtype == np.int64
    np.testing.assert_array_equal(nsteps, n_j)
    _assert_prefixes_equal(ops, ops_j, nsteps)
    assert _port_counts(cpu_offload) == _jax_counts()
    assert 0 < cpu_offload.STATS["nw_problems"] < len(problems)  # e == g


def test_eval_gap_matches_jax(cpu_offload, fresh_jax_stats):
    problems = pair_problems(6)
    sm_j, ops_j, n_j = jax_off.eval_gap(problems)
    sm, ops, nsteps, evaluated = cpu_offload.eval_gap(problems)
    assert evaluated.all()
    np.testing.assert_array_equal(sm, sm_j)
    np.testing.assert_array_equal(nsteps, n_j)
    _assert_prefixes_equal(ops, ops_j, nsteps)
    assert _port_counts(cpu_offload) == _jax_counts()


def test_eval_rb_matches_jax(cpu_offload, fresh_jax_stats):
    problems = [(g, e) for e, g in pair_problems(7)]
    v_j, p_j = jax_off.eval_rb(problems)
    vals, pos, evaluated = cpu_offload.eval_rb(problems)
    assert evaluated.all() and vals.shape == v_j.shape
    rows = [len(p) + 1 for _t, p in problems]
    _assert_prefixes_equal(vals, v_j, rows)
    _assert_prefixes_equal(pos, p_j, rows)
    assert _port_counts(cpu_offload) == _jax_counts()


@pytest.mark.parametrize("family", ["nw", "gap", "rb"])
def test_oversized_problem_is_left_to_the_host(cpu_offload, family):
    """One oversized problem among small ones: the JAX package's entry
    declines the whole batch (returns None); the port answers the small
    ones and marks the big one unevaluated (its gen or text window wider
    than the kernels' MAX_WIDTH; the JAX package's smaller bound on NW
    and gap problems is not the port's, test_torch_traceback_bounds.py),
    counted in ``<family>_too_wide``."""
    small = pair_problems(8, count=12)
    rng = np.random.default_rng(9)
    if family == "rb":
        small = [(g, e) for e, g in small]
        big = ("".join(rng.choice(ALPHA, 17000)).encode(), b"ACGT")
    else:
        big = tuple("".join(rng.choice(ALPHA, n)).encode()
                    for n in (2000, 17000))
    problems = small[:5] + [big] + small[5:]
    assert getattr(jax_off, f"eval_{family}")(problems) is None
    res = getattr(cpu_offload, f"eval_{family}")(problems)
    evaluated = res[-1]
    assert evaluated.tolist() == [i != 5 for i in range(len(problems))]
    assert cpu_offload.STATS[f"{family}_too_wide"] == 1
    want = getattr(cpu_offload, f"eval_{family}")(small)
    keep = [i for i in range(len(problems)) if i != 5]
    for got, exp in zip(res[:-1], want[:-1]):
        if got.ndim == 1:
            np.testing.assert_array_equal(got[keep], exp)
        else:
            w = min(got.shape[1], exp.shape[1])
            np.testing.assert_array_equal(got[keep, :w], exp[:, :w])


def test_stats_tally_loses_no_update(cpu_offload):
    """Batches of two families count from two threads at once (the
    executor's K-band and gap batches, this thread's NW and rb ones)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [cpu_offload.tally(device_problems=1,
                                              device_cells=3)
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert cpu_offload.STATS["device_problems"] == 16 * 2000
    assert cpu_offload.STATS["device_cells"] == 3 * 16 * 2000
