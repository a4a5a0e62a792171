"""The traceback families' size bound (``offload.TRACEBACK_BOUND``, the
kernels' widest row) and launch budget (``offload.launch_budget``), on
the CPU.  The JAX package leaves an NW or gap problem of over 2^21 cells
or 8192 in length to the host, a bound set by a TPU's memory; the port
sends every problem whose windows are at most MAX_WIDTH wide to its
kernels, so on 788 the long-mRNA endpoint alignments go to the device.

Costs on one core: the 788 fixture about 8 s and each JAX run on 788
about 6 s; the plain NW and gap at 1500 x 1500 about 8 s with the JAX
ops; mattia1 about 2 s a run; the sub-batching and budget tests under
1 s."""

import logging
import shutil

import numpy as np
import pytest
import torch
from test_torch_est_fact import _assert_stage2_equal, _jax_forced_counts

from pintron_tpu_torch.native import dp_census, dp_census_reset, get_lib
from pintron_tpu_torch.ops import align, offload, traceback
from pintron_tpu_torch.stages import est_fact


def _over_jax_bound(e: bytes, g: bytes) -> bool:
    """The JAX package's traceback bound (pintron_tpu/ops/offload.py:505,
    :576), which the port does not keep."""
    return len(e) * len(g) > (1 << 21) or len(e) + len(g) > 8192


def _run_step2(golden, case, tmp_path, mp):
    """The port's STEP 2 of ``case`` with device="cpu", every family on
    the device, a fresh memo; returns (gold, work, STATS, host DP cells,
    the NW batches handed to ``_eval_nw_device``)."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    gold = golden(case)
    work = tmp_path / case
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    mp.delenv("PINTRON_DEVICE", raising=False)
    mp.setenv("PINTRON_FRESH_MEMO", "1")
    batches = []
    real = offload._eval_nw_device

    def spy(problems, device):
        batches.append(list(problems))
        return real(problems, device)

    mp.setattr(offload, "_eval_nw_device", spy)
    offload.reset_stats()
    dp_census_reset()
    est_fact.run_est_fact(str(work), device="cpu")
    return gold, work, dict(offload.STATS), dp_census(), batches


@pytest.fixture(scope="module")
def step2_788(golden, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        logger = logging.getLogger("pintron")
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logger.addHandler(handler)
        old_level = logger.level
        logger.setLevel(logging.INFO)
        try:
            run = _run_step2(golden, "test-788",
                             tmp_path_factory.mktemp("b788"), mp)
        finally:
            logger.removeHandler(handler)
            logger.setLevel(old_level)
    return run + ([r.getMessage() for r in records],)


def test_788_endpoints_over_the_jax_bound_go_to_the_device(
        step2_788, tmp_path, monkeypatch):
    """788's STEP 2 stays byte-golden, every non-identical NW problem it
    collects is evaluated on the device, none is too wide, and its NW
    device problems are the JAX flow's plus the non-identical problems
    of every batch the JAX flow declines whole because it holds a
    problem over the JAX bound (ROADMAP C5): those over the bound,
    counted here with numpy, and the in-bound ones beside them."""
    gold, work, stats, _cells, batches, log = step2_788
    _assert_stage2_equal(gold, work)
    nonid = [[p for p in b if p[0] != p[1]] for b in batches]
    over = sum(_over_jax_bound(*p) for b in nonid for p in b)
    declined = [b for b, full in zip(nonid, batches)
                if any(_over_jax_bound(*p) for p in full)]
    in_bound_declined = sum(not _over_jax_bound(*p)
                            for b in declined for p in b)
    assert over > 0
    assert stats["nw_too_wide"] == 0
    assert stats["nw_problems"] == sum(len(b) for b in nonid)
    jax = _jax_forced_counts(gold, tmp_path, monkeypatch)
    assert stats["nw_problems"] == (jax["nw_problems"] + over
                                    + in_bound_declined)
    # the device flow's log line reports the counter
    flow = [m for m in log if m.startswith("est-fact device flow:")]
    assert len(flow) == 1 and '"nw_too_wide": 0' in flow[0]


def test_jax_flow_misses_the_same_endpoint_memo(step2_788, tmp_path,
                                                 monkeypatch):
    """With every NW problem it collects evaluated (the port's NW entry
    standing in for its own), the JAX flow computes on its host as many
    NW cells as the port: the endpoint cuts that miss the pre-filled
    memo (on 788 the tails of one-factor candidates, which the collect
    never emits) are the flow's own, not the port's."""
    jax_native = pytest.importorskip("pintron_tpu.native")
    import pintron_tpu.ops.offload as jax_off
    gold, _work, _stats, cells, _batches, _log = step2_788

    def port_nw(problems):
        ops, nsteps, evaluated = offload._eval_nw_device(
            problems, torch.device("cpu"))
        assert evaluated.all()
        return ops, nsteps

    monkeypatch.setattr(jax_off, "_eval_nw_device", port_nw)
    jax_native.dp_census_reset()
    _jax_forced_counts(gold, tmp_path, monkeypatch)
    assert cells["nw"] > 0
    assert jax_native.dp_census()["nw"] == cells["nw"]


def _pairs(seed, n, count=2):
    """Endpoint-like (est, gen) windows of about n bases: gen is est
    with 3% point mutations and a few bases cut or added."""
    rng = np.random.default_rng(seed)
    acgt = np.array(list("ACGT"))
    pairs = []
    for k in range(count):
        e = "".join(rng.choice(acgt, n - 7 * k))
        g = "".join(c if rng.random() > 0.03 else str(rng.choice(acgt))
                    for c in e)
        pairs.append((e, g[: n - 11 * k] + "ACG" * k))
    return pairs


def _encode(pairs):
    N = max(len(a) for a, _ in pairs)
    M = max(len(b) for _, b in pairs)
    s1 = np.zeros((len(pairs), N), dtype=np.int8)
    s2 = np.zeros((len(pairs), M), dtype=np.int8)
    for i, (a, b) in enumerate(pairs):
        s1[i, :len(a)] = np.frombuffer(a.encode(), dtype=np.uint8)
        s2[i, :len(b)] = np.frombuffer(b.encode(), dtype=np.uint8)
    l1 = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    l2 = np.array([len(b) for _, b in pairs], dtype=np.int32)
    return s1, l1, s2, l2, N, M


@pytest.mark.parametrize("family", ["nw", "gap"])
def test_plain_ops_over_the_jax_bound_equal_jax(family):
    """The plain NW and gap ops at 1500 x 1500 (2.25 M cells, over the
    JAX package's 2^21) equal the JAX ops on the CPU, problem for
    problem: the shapes the port now sends to its kernels."""
    jalign = pytest.importorskip("pintron_tpu.ops.align")
    pairs = _pairs(7 if family == "nw" else 8, 1500)
    s1, l1, s2, l2, N, M = _encode(pairs)
    assert all(_over_jax_bound(a, b) for a, b in pairs)
    assert all(offload.traceback_fits(a.encode(), b.encode())
               for a, b in pairs)
    args = align.from_numpy_batch(s1, l1, s2, l2, device=torch.device("cpu"))
    if family == "nw":
        score_j, fused = jalign.batch_nw_traceback(s1, l1, s2, l2,
                                                   max_n=N, max_m=M)
        ops_j, n_j = jalign.decode_nw_fused(fused, N + M)
        head, ops, nsteps = align.batch_nw_traceback(*args, max_n=N,
                                                     max_m=M)
        np.testing.assert_array_equal(head.numpy(), np.asarray(score_j))
    else:
        sm_j, ops_j, n_j = jalign.decode_gap_fused(
            jalign.batch_gap_traceback(s1, l1, s2, l2, max_n=N, max_m=M),
            N + M)
        head, ops, nsteps = align.batch_gap_traceback(*args, max_n=N,
                                                      max_m=M)
        np.testing.assert_array_equal(head.numpy(), sm_j)
    np.testing.assert_array_equal(nsteps.numpy(), n_j)
    for b in range(len(pairs)):
        np.testing.assert_array_equal(ops.numpy()[b, :n_j[b]],
                                      ops_j[b, :n_j[b]])


@pytest.mark.parametrize("bound", ["zero", "family"])
def test_gap_collect_takes_its_bound_from_python(bound, golden, tmp_path,
                                                 monkeypatch):
    """The gap collect's window bound is set from Python
    (``ri_dev_set_bounds`` before each chunk's collect): at 0 mattia1
    collects no gap problem, leaves every window to the host DP and
    stays byte-golden; at the gap family's bound (TRACEBACK_BOUND) its
    gap counters equal the JAX flow's, with none too wide."""
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    if bound == "zero":
        real = lib.ri_dev_set_bounds
        monkeypatch.setattr(lib, "ri_dev_set_bounds",
                            lambda _n, _m: real(0, 0))
    gold, work, stats, cells, _b = _run_step2(golden, "test-mattia1",
                                              tmp_path, monkeypatch)
    _assert_stage2_equal(gold, work)
    if bound == "zero":
        assert stats["gap_problems"] == 0
        assert stats["gap_too_wide"] > 0 and cells["gap_align"] > 0
    else:
        jax = _jax_forced_counts(gold, tmp_path, monkeypatch)
        assert stats["gap_problems"] == jax["gap_problems"] > 0
        assert stats["gap_too_wide"] == 0


def test_widest_nw_bucket_goes_in_one_launch():
    """Five NW problems of issue-2's (16384, 16384) bucket (4202 x 4202)
    go in one launch when the budget holds their scratch, which the
    parent's 2^28-byte cap at N * M bytes a problem split into five;
    one byte less splits them; and each family's bytes a problem are
    what ``nw_scratch`` and ``gap_scratch`` allocate for the batch."""
    prob = (b"A" * 4202, b"C" * 4202)
    problems = [prob] * 5
    evaluated = np.ones(5, dtype=bool)
    per = offload.scratch_bytes("nw", 16384, 16384)
    chunks = offload._launch_chunks(problems, evaluated, "nw", 5 * per)
    assert [(N, M, len(rows)) for N, M, rows in chunks] == \
        [(16384, 16384, 5)]
    chunks = offload._launch_chunks(problems, evaluated, "nw", 5 * per - 1)
    assert [len(rows) for _N, _M, rows in chunks] == [4, 1]
    assert (1 << 28) // (16384 * 16384) == 1
    for fam, N, M in (("nw", 16384, 16384), ("nw", 4096, 1024),
                      ("gap", 64, 256), ("gap", 16384, 16384)):
        bufs = (traceback.nw_scratch(5, N, M, "meta") if fam == "nw" else
                traceback.gap_scratch(5, N, M, "meta", traceback.gap_rows(N)))
        assert sum(t.numel() * t.element_size() for t in bufs) == \
            5 * offload.scratch_bytes(fam, N, M)


def test_launch_budget_is_a_share_of_the_card(monkeypatch):
    """A card's budget is 1/LAUNCH_SHARE of its memory, read once a
    device; one that cannot hold a problem of the widest bucket raises;
    the CPU's plain versions have their own."""

    class Props:
        total_memory = 85_000_000_000

    calls = []

    def props(device):
        calls.append(device)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(offload, "_BUDGETS", {})
    assert offload.launch_budget("cpu") == offload.CPU_LAUNCH_BUDGET
    dev = torch.device("cuda", 0)
    want = 85_000_000_000 // offload.LAUNCH_SHARE
    assert offload.launch_budget(dev) == offload.launch_budget(dev) == want
    assert len(calls) == 1
    Props.total_memory = 1 << 20
    with pytest.raises(RuntimeError, match="widest"):
        offload.launch_budget(torch.device("cuda", 1))
    widest = max(offload.scratch_bytes(f, *offload.TRACEBACK_BOUND)
                 for f in ("nw", "gap"))
    assert offload.CPU_LAUNCH_BUDGET >= widest
