"""The per-family routes of the port's STEP 2 device flow,
``PINTRON_DEVICE_{KBAND,NW,GAP,RB}`` (unset or 1: the card, 0: the host
DP, auto: the self-tuner), on the CPU with ``device="cpu"``: each
family on the host in turn gives the golden artifacts and the JAX
flow's counters with the same switch at 0; the port's tuner answers as
the JAX tuner; the forked flow's workers hand their latches to later
forks; unset switches never consult the tuner; other values raise.
Which families the tuner keeps on is not asserted: the plain versions
on the CPU are no measure of the card."""

import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_est_fact import (FAMILY_COUNTS, STAGE2, _assert_stage2_equal,
                                 _jax_forced_counts, _workdir)

from pintron_tpu_torch.config import Config
from pintron_tpu_torch.index.gst import SuffixTree
from pintron_tpu_torch.io import multifasta as mf
from pintron_tpu_torch.native import get_lib
from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.stages import est_fact
from pintron_tpu_torch.tools.check_stage2 import family_problems

FAMILIES = offload.FAMILIES
CASE = "test-mattia1"


@pytest.fixture
def routes_env(monkeypatch):
    lib = get_lib()
    if lib is None or not hasattr(lib, "est_collect_noisy"):
        pytest.skip("native collect entry unavailable")
    for var in ("PINTRON_DEVICE", "PINTRON_TORCH_SERVICE") + tuple(
            offload.family_env(f) for f in FAMILIES):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PINTRON_FRESH_MEMO", "1")
    offload.reset_stats()
    offload.reset_tuner()
    # one intra-op thread: the plain ops are many small calls, and the
    # other test workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    offload.reset_tuner()


def _tuner_counts(stats, family):
    return {c: stats[f"{family}_{c}"] for c in offload.TUNE_COUNTS}


@pytest.mark.parametrize("family", FAMILIES)
def test_family_on_the_host_dp_is_byte_identical(family, golden, tmp_path,
                                                 routes_env, monkeypatch):
    """PINTRON_DEVICE_<F>=0: the cascade computes that family on the
    host, the artifacts stay the golden's, the other families send what
    the JAX flow sends with the same switch at 0."""
    gold, work = _workdir(golden, CASE, tmp_path)
    monkeypatch.setenv(offload.family_env(family), "0")
    est_fact.run_est_fact(str(work), device="cpu")
    stats = dict(offload.STATS)
    _assert_stage2_equal(gold, work)
    problems = family_problems(stats)
    assert problems.pop(family) == 0, stats
    assert min(problems.values()) > 0, stats
    for fam in FAMILIES:
        c = _tuner_counts(stats, fam)
        assert c["skips"] == c["probes"] == c["reports"] == 0, (fam, c)
        assert (c["on_host"] > 0) == (fam == family), (fam, c)
    assert {k: stats[k] for k in FAMILY_COUNTS} == _jax_forced_counts(
        gold, tmp_path, monkeypatch, host_families=(family,))


def test_auto_is_byte_identical_and_counts_its_latches(golden, tmp_path,
                                                       routes_env,
                                                       monkeypatch, caplog):
    """All four at auto, twice in one process: the artifacts stay the
    golden's, the log line names the routes and the latches, and the
    tuner's counters agree with its latches."""
    for fam in FAMILIES:
        monkeypatch.setenv(offload.family_env(fam), "auto")
    caplog.set_level(logging.INFO, logger="pintron")
    for run in range(2):
        (tmp_path / str(run)).mkdir()
        gold, work = _workdir(golden, CASE, tmp_path / str(run))
        offload.reset_stats()
        est_fact.run_est_fact(str(work), device="cpu")
        _assert_stage2_equal(gold, work)
        stats = dict(offload.STATS)
        latched = offload.latches()
        flow = [r.getMessage() for r in caplog.records
                if r.getMessage().startswith("est-fact device flow:")][-1]
        assert '"routes": {"gap": "auto", "kband": "auto", "nw": "auto", ' \
            '"rb": "auto"}' in flow
        assert f'"latches": {{"gap": {str(latched["gap"]).lower()}' in flow
        for fam in FAMILIES:
            c = _tuner_counts(stats, fam)
            assert c["latched"] <= c["reports"] and c["skips"] <= c["on_host"]
            if run == 0:
                # the first opportunity after reset_tuner runs on the card
                # (K-band and NW: one a round, and mattia1's first rounds
                # have problems of both), and only a report latches
                assert c["reports"] >= (fam in ("kband", "nw")), (fam, c)
                assert c["latched"] >= latched[fam], (fam, c)
    # reset_stats leaves the latches alone
    offload.reset_stats()
    assert offload.latches() == latched


def _jax_tuner(monkeypatch):
    """The JAX package's tuner, its module state restored after the
    test."""
    import pintron_tpu.ops.offload as jax_off
    for fam in FAMILIES:
        monkeypatch.setattr(jax_off, f"{fam.upper()}_SELF_TUNED_OFF", False)
    monkeypatch.setattr(jax_off, "_TUNE_SKIPS", dict.fromkeys(FAMILIES, 0))
    monkeypatch.setattr(jax_off, "_PROBE_PENDING",
                        dict.fromkeys(FAMILIES, False))
    return jax_off


def test_tuner_answers_as_the_jax_tuner(monkeypatch):
    """The same seeded sequence of opportunities and timed batches, all
    well above both floors, through both tuners: the same answers and
    the same latches at every step."""
    jax_off = _jax_tuner(monkeypatch)
    offload.reset_tuner()
    assert offload.TUNE_REPROBE_EVERY == jax_off.TUNE_REPROBE_EVERY
    rng = np.random.default_rng(14)
    answers = []
    try:
        for _block in range(60):
            p_report = rng.choice([0.05, 0.3, 0.6])
            for _ in range(40):
                fam = str(rng.choice(FAMILIES))
                if rng.random() < p_report:
                    host = float(rng.uniform(1.0, 10.0))
                    elapsed = host * float(rng.choice(
                        [0.3, 1.0, 1.19, 1.21, 1.6, 1.99, 2.01, 3.0]))
                    offload.tune_report(fam, elapsed, host)
                    jax_off.tune_report(fam, elapsed, host)
                else:
                    got = offload.tuned_off(fam)
                    assert got == jax_off.tuned_off(fam), (fam, answers[-20:])
                    answers.append(got)
                assert offload.latches() == {
                    f: getattr(jax_off, f"{f.upper()}_SELF_TUNED_OFF")
                    for f in FAMILIES}
    finally:
        offload.reset_tuner()
    # the sequence reached skips and re-probes, not only open families
    assert 0 < sum(answers) < len(answers)


def test_tuner_floors_and_inherited_latches():
    """A batch under LATCH_FLOOR_S never latches, however small the host
    estimate; one under CLEAR_FLOOR_S always clears.  A forked worker's
    latches are ORed into this process's, and a probe armed here counts
    as measured."""
    offload.reset_tuner()
    try:
        offload.tune_report("nw", 0.9 * offload.LATCH_FLOOR_S, 0.0)
        assert not offload.latches()["nw"]
        offload.tune_report("nw", 1.1 * offload.LATCH_FLOOR_S, 0.0)
        assert offload.latches()["nw"]
        offload.tune_report("nw", 0.9 * offload.CLEAR_FLOOR_S, 0.0)
        assert not offload.latches()["nw"]
        assert offload.LATCH_FLOOR_S == 2 * offload.CLEAR_FLOOR_S

        offload.tune_report("rb", 1.0, 0.0)
        for _ in range(offload.TUNE_REPROBE_EVERY - 1):
            assert offload.tuned_off("rb")
        assert not offload.tuned_off("rb")        # the armed probe
        offload.inherit_latches({"kband": True, "nw": False, "gap": False,
                                 "rb": False})
        assert offload.latches() == {"kband": True, "nw": False,
                                     "gap": False, "rb": True}
        # the workers measured the probe: the next opportunity is a skip
        assert offload.tuned_off("rb")
    finally:
        offload.reset_tuner()


def test_tuner_counts_hold_under_threads():
    """Many threads spend the opportunities of one latched family: the
    skips before the re-probe are TUNE_REPROBE_EVERY - 1 exactly, and
    one probe is armed, as in one thread."""
    offload.reset_stats()
    offload.reset_tuner()
    offload.tune_report("gap", 1.0, 0.0)
    answers = []
    lock = threading.Lock()

    def spend():
        for _ in range(200):
            off = offload.tuned_off("gap")
            with lock:
                answers.append(off)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=spend) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        offload.reset_tuner()
    assert len(answers) == 16 * 200
    assert sum(answers) == offload.TUNE_REPROBE_EVERY - 1
    assert offload.STATS["gap_skips"] == offload.TUNE_REPROBE_EVERY - 1
    assert offload.STATS["gap_probes"] == 1


def test_forked_workers_hand_their_latches_to_later_forks(golden, routes_env,
                                                          monkeypatch):
    """The sharded flow over two fork workers with NW under the tuner
    and its device batches slowed past every estimate: the workers latch
    NW off and the parent takes the latch; the next forks inherit it and
    leave every NW batch to the host DP.  Both runs byte-identical."""
    monkeypatch.setenv("PINTRON_DEVICE_NW", "auto")
    real = offload._eval_nw_device

    def slow(problems, device):
        time.sleep(4 * offload.host_estimate("nw", problems)
                   + 2 * offload.LATCH_FLOOR_S + 0.02)
        return real(problems, device)

    monkeypatch.setattr(offload, "_eval_nw_device", slow)
    gold = golden(CASE)
    with open(gold / "genomic.txt") as fh:
        gen = mf.read_multifasta(fh)[0]
    mf.parse_genomic_header(gen)
    mf.ntails_removal(gen)
    gen_seq = gen.seq.encode("latin1")
    tree = SuffixTree(gen_seq)
    config = Config()
    offload.set_device("cpu")
    for run in range(2):
        offload.reset_stats()
        results, _census = est_fact._run_units_device_forked(
            gen, tree, gen_seq, config, str(gold / "ests.txt"), True, 2)
        for k, name in enumerate(est_fact.OUTPUT_NAMES):
            if name in STAGE2:
                assert "".join(r[k] for r in results).encode() == \
                    (gold / name).read_bytes(), (run, name)
        stats = dict(offload.STATS)
        assert offload.latches()["nw"], (run, stats)
        if run == 0:
            assert stats["nw_latched"] >= 1 and stats["nw_problems"] > 0
        else:
            assert stats["nw_problems"] == stats["nw_reports"] == 0, stats
            assert stats["nw_skips"] == stats["nw_on_host"] > 0, stats
        assert min(family_problems(stats)[f] for f in ("kband", "gap")) > 0


def test_forced_switches_never_consult_the_tuner(golden, tmp_path,
                                                 routes_env, monkeypatch):
    """Unset, and all four at 1: every family on the card, and a spy
    shows the tuner never consulted."""
    consulted = []

    def spy(family):
        consulted.append(family)
        return False

    monkeypatch.setattr(offload, "tuned_off", spy)
    monkeypatch.setattr(offload, "tune_report",
                        lambda *a: consulted.append(a))
    for value in (None, "1"):
        if value is not None:
            for fam in FAMILIES:
                monkeypatch.setenv(offload.family_env(fam), value)
        (tmp_path / str(value)).mkdir()
        gold, work = _workdir(golden, CASE, tmp_path / str(value))
        offload.reset_stats()
        est_fact.run_est_fact(str(work), device="cpu")
        _assert_stage2_equal(gold, work)
        assert consulted == []
        stats = dict(offload.STATS)
        assert min(family_problems(stats).values()) > 0
        assert all(stats[f"{f}_{c}"] == 0 for f in FAMILIES
                   for c in offload.TUNE_COUNTS)


def test_switch_values_and_refusals(tmp_path, monkeypatch):
    """1, empty and unset route to the card, 0 to the host DP, auto to
    the tuner.  Any other value raises before a file is read (the JAX
    package reads it as auto), on a torch device and on the host path."""
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    for fam, value in zip(FAMILIES, ("1", "", "0", "auto")):
        monkeypatch.setenv(offload.family_env(fam), value)
    assert offload.family_routes() == {"kband": "card", "nw": "card",
                                       "gap": "host", "rb": "auto"}
    for fam in FAMILIES:
        monkeypatch.delenv(offload.family_env(fam))
    assert set(offload.family_routes().values()) == {"card"}
    for fam, value in zip(FAMILIES, ("2", "AUTO", "off", "true")):
        monkeypatch.setenv(offload.family_env(fam), value)
        for device in ("cpu", "host"):
            with pytest.raises(ValueError, match=offload.family_env(fam)):
                est_fact.run_est_fact(str(tmp_path), device=device)
        monkeypatch.delenv(offload.family_env(fam))
    assert list(tmp_path.iterdir()) == []


def test_log_names_each_route(golden, tmp_path, routes_env, monkeypatch,
                              caplog):
    gold, work = _workdir(golden, CASE, tmp_path)
    monkeypatch.setenv("PINTRON_DEVICE_GAP", "0")
    monkeypatch.setenv("PINTRON_DEVICE_RB", "auto")
    caplog.set_level(logging.INFO, logger="pintron")
    est_fact.run_est_fact(str(work), device="cpu")
    _assert_stage2_equal(gold, work)
    flow = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("est-fact device flow:")]
    assert len(flow) == 1
    assert ('"routes": {"gap": "host", "kband": "card", "nw": "card", '
            '"rb": "auto"}') in flow[0]

