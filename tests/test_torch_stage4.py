"""The port's STEP 4 (intron agreement) on the CPU: the plain PWM op
against the JAX op, the edit-stats entry against the JAX entry and the
host ``edit_distance``, the BPS sweep's overrides against the JAX
sweep's, the stage against the goldens and the JAX device flow's
counters, and the pipeline's STEP 4 routing.  Inputs are made from a
seed with numpy.

JAX is imported inside the tests that compare with it, so the ``cuda``
tests of this file (``pwm_kernel`` against its plain version) run on a
GPU machine that has no JAX:  python -m pytest tests/test_torch_stage4.py
-m cuda
"""

import shutil

import numpy as np
import pytest
import torch

from pintron_tpu_torch import pipeline
from pintron_tpu_torch.factorize import classify
from pintron_tpu_torch.native import get_lib
from pintron_tpu_torch.ops import limits, offload, pwm
from pintron_tpu_torch.stages import intron_agreement

STAGE4 = ("out-after-intron-agree.txt", "predicted-introns.txt")
STAGE4_INPUTS = ("genomic.txt", "processed-ests.txt", "out-agree.txt")
MATRICES = ("BPS_9", "BPS_10")


@pytest.fixture
def cpu_offload(monkeypatch):
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.delenv(offload.SERVICE_ENV, raising=False)
    monkeypatch.setattr(offload, "_DEVICE", torch.device("cpu"))
    offload.reset_stats()
    return offload


@pytest.fixture
def jax_offload(monkeypatch):
    """pintron_tpu's offload (JAX on the CPU) with fresh counters."""
    pytest.importorskip("jax")
    import pintron_tpu.ops.offload as jax_off
    monkeypatch.setattr(jax_off, "STATS", dict.fromkeys(jax_off.STATS, 0))
    monkeypatch.setattr(jax_off, "_WEDGED", False)
    return jax_off


@pytest.fixture
def fresh_bps():
    """The port's classifier; leave its override table and cache, and
    the JAX package's, as found."""
    import pintron_tpu.factorize.classify as ref
    yield classify
    for mod in (classify, ref):
        mod._BPS_OVERRIDE.clear()
        mod._BPS_OVERRIDE_GEN = None
        mod.classify_genomic_intron_start_end.cache_clear()


def random_windows(seed, B, L):
    """Codes 0..3 with runs of one base, plus codes outside 0..3 (which
    add nothing, as an all-zero one-hot row does in the JAX op)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[::7] = codes[::7, :1]
    odd = rng.random((B, L)) < 0.01
    codes[odd] = rng.choice(np.array([-1, 4, 9, -128], dtype=np.int8),
                            int(odd.sum()))
    return codes


@pytest.mark.parametrize("name", MATRICES)
def test_plain_pwm_scores_match_jax(name):
    pytest.importorskip("jax")
    from pintron_tpu.ops import pwm as jax_pwm
    wpwm, den = pwm.pwm_tables(name)
    jw, jd = jax_pwm.pwm_tables(name)
    np.testing.assert_array_equal(wpwm, jw)
    assert den == jd
    codes = random_windows(3, 4096, wpwm.shape[1])
    got = pwm.pwm_scores(torch.from_numpy(codes), torch.from_numpy(wpwm),
                         den)
    want = np.asarray(jax_pwm.pwm_scores(codes.astype(np.int32), jw,
                                         denominator=jd))
    assert got.dtype == torch.float32
    # the JAX op sums in another order; the exact f64 finish makes a
    # last-bit difference harmless
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # in column order, then one true division: the same f32 rounding as
    # numpy's sequential sum
    acc = np.zeros(len(codes), dtype=np.float32)
    wx = np.concatenate([wpwm, np.zeros((1, wpwm.shape[1]), np.float32)])
    cx = np.where((codes >= 0) & (codes < 4), codes, 4)
    for col in range(wpwm.shape[1]):
        acc = acc + wx[cx[:, col], col]
    np.testing.assert_array_equal(got.numpy(), acc / np.float32(den))


def test_encode_windows_matches_jax():
    pytest.importorskip("jax")
    from pintron_tpu.ops import pwm as jax_pwm
    windows = ["ACGTNacgtn", "TTAG", "", "ACGT*#RYacgtacgt", "nnnnnnnnnnnnn"]
    np.testing.assert_array_equal(pwm.encode_windows(windows, 12),
                                  jax_pwm.encode_windows(windows, 12))
    np.testing.assert_array_equal(pwm._BASE, jax_pwm._BASE)


def test_pwm_wrapper_checks_and_dispatch():
    wpwm, den = pwm.pwm_tables("BPS_9")
    codes = torch.from_numpy(random_windows(4, 33, 12))
    w = torch.from_numpy(wpwm)
    limits.reset_launches()
    assert torch.equal(pwm.pwm_scores_cuda(codes, w, den),
                       pwm.pwm_scores(codes, w, den))
    assert limits.LAUNCHES["pwm"] == 0
    for bad in (codes.long(), codes[:, :10], codes.t()):
        with pytest.raises(ValueError):
            pwm.pwm_scores_cuda(bad, w, den)
    with pytest.raises(ValueError, match="no PWM kernel"):
        pwm.pwm_scores_cuda(codes.to("meta"), w.to("meta"), den)


def edit_pairs(seed, n=400):
    """Window pairs of the edit stats: equal windows, point mutations,
    windows cut at the genome end, unrelated windows."""
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGTN"))
    pairs = [(b"", b""), (b"ACGT", b""), (b"", b"A")]
    for i in range(n):
        a = "".join(rng.choice(alpha[:4], 15))
        if i % 4 == 0:
            b = a
        elif i % 4 == 1:
            el = list(a)
            for _ in range(int(rng.integers(1, 4))):
                el[int(rng.integers(0, 15))] = str(rng.choice(alpha))
            b = "".join(el)
        elif i % 4 == 2:
            b = a[:int(rng.integers(0, 15))]
        else:
            b = "".join(rng.choice(alpha, int(rng.integers(1, 16))))
        pairs.append((a.encode(), b.encode()) if i % 2 else
                     (b.encode(), a.encode()))
    return pairs


def test_eval_edit_batch_matches_jax_and_host(cpu_offload, jax_offload):
    from pintron_tpu.factorize.alignments import edit_distance
    pairs = edit_pairs(7)
    got = cpu_offload.eval_edit_batch(pairs)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_offload.eval_edit_batch(pairs))
    assert got.tolist() == [edit_distance(a.decode(), b.decode())
                            for a, b in pairs]
    keys = ("problems", "device_problems", "edit_problems", "device_cells",
            "batches")
    assert {k: cpu_offload.STATS[k] for k in keys} == \
        {k: jax_offload.STATS[k] for k in keys}
    assert 0 < cpu_offload.STATS["edit_problems"] < len(pairs)


def _stage4_workdir(golden, case, tmp_path, sub="port"):
    gold = golden(case)
    work = tmp_path / f"{case}-{sub}"
    work.mkdir()
    for name in STAGE4_INPUTS:
        shutil.copy(gold / name, work / name)
    return gold, work


def test_bps_overrides_match_jax_on_ambn(golden, tmp_path, cpu_offload,
                                         jax_offload, fresh_bps,
                                         monkeypatch):
    """The port's sweep leaves its _BPS_OVERRIDE as the JAX sweep
    leaves the JAX package's, for the registry of AMBN's STEP 4."""
    import pintron_tpu.factorize.classify as ref
    if get_lib() is None:
        pytest.skip("native library unavailable")
    calls = []

    def capture(gen, pairs, device):
        calls.append((gen, list(pairs)))
        return classify.precompute_bps_device(gen, calls[-1][1], device)

    monkeypatch.setattr(intron_agreement, "precompute_bps_device", capture)
    _gold, work = _stage4_workdir(golden, "test-AMBN", tmp_path)
    intron_agreement.run_intron_agreement(str(work), device="cpu")
    (gen, pairs), = calls
    port = dict(fresh_bps._BPS_OVERRIDE)
    assert fresh_bps._BPS_OVERRIDE_GEN is gen
    n = ref.precompute_bps_device(gen, pairs)
    assert n == cpu_offload.STATS["pwm_windows"] > 0
    assert len(port) > 0 and port == ref._BPS_OVERRIDE


@pytest.mark.parametrize("case", ["test-788", "test-AMBN", "test-CPB2",
                                  "test-TP53"])
def test_stage4_cpu_device_byte_identical(case, golden, tmp_path,
                                          cpu_offload, jax_offload,
                                          fresh_bps, monkeypatch):
    """STEP 4 with device="cpu" gives the goldens' bytes, with as many
    PWM windows and edit problems on the device as the JAX device flow
    (PINTRON_DEVICE=1, run here) sends to its device."""
    from pintron_tpu.stages.intron_agreement import \
        run_intron_agreement as jax_stage
    if get_lib() is None:
        pytest.skip("native library unavailable")
    gold, work = _stage4_workdir(golden, case, tmp_path)
    intron_agreement.run_intron_agreement(str(work), device="cpu")
    for name in STAGE4:
        assert (work / name).read_bytes() == (gold / name).read_bytes(), \
            f"{name} differs from golden"
    port = dict(cpu_offload.STATS)
    assert port["device_timeouts"] == 0

    import pintron_tpu.factorize.classify as ref
    ref.classify_genomic_intron_start_end.cache_clear()
    _gold, jwork = _stage4_workdir(golden, case, tmp_path, "jax")
    monkeypatch.setenv("PINTRON_DEVICE", "1")
    jax_stage(str(jwork))
    monkeypatch.delenv("PINTRON_DEVICE")
    for name in STAGE4:
        assert (jwork / name).read_bytes() == (gold / name).read_bytes()
    for key in ("pwm_windows", "edit_problems", "problems"):
        assert port[key] == jax_offload.STATS.get(key, 0), key
    assert port["pwm_windows"] > 0
    # every edit pair of test-788 has equal windows: no DP to run
    assert port["problems"] > 0
    assert port["edit_problems"] > 0 or case == "test-788"


def test_stage4_hung_sweep_unpins_the_overrides(golden, tmp_path,
                                                cpu_offload, fresh_bps,
                                                monkeypatch):
    """A PWM batch cut short by the watchdog stops STEP 4: its override
    table stays empty, the host path classifies nothing in its place,
    and the edit stats never run."""
    import threading
    if get_lib() is None:
        pytest.skip("native library unavailable")
    release = threading.Event()
    monkeypatch.setattr(cpu_offload, "_pwm_scores_device",
                        lambda *_a: release.wait(30))
    monkeypatch.setenv("PINTRON_DEVICE_TIMEOUT_S", "0.5")
    _gold, work = _stage4_workdir(golden, "test-AMBN", tmp_path)
    try:
        with pytest.raises(cpu_offload.DeviceTimeout,
                           match="stage-4 PWM device batch"):
            intron_agreement.run_intron_agreement(str(work), device="cpu")
    finally:
        release.set()
    assert cpu_offload.STATS["device_timeouts"] == 1
    assert not fresh_bps._BPS_OVERRIDE
    assert cpu_offload.STATS["edit_problems"] == 0
    assert not (work / "predicted-introns.txt").exists()


@pytest.mark.parametrize("entry", ["_pwm_scores_device",
                                   "_eval_edit_batch_device"])
def test_stage4_failing_batch_raises(entry, golden, tmp_path, cpu_offload,
                                     fresh_bps, monkeypatch):
    """A failing PWM or edit batch stops STEP 4: the reference's
    try/except around its device sites is not copied."""
    if get_lib() is None:
        pytest.skip("native library unavailable")

    def boom(*_a):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(cpu_offload, entry, boom)
    _gold, work = _stage4_workdir(golden, "test-AMBN", tmp_path)
    with pytest.raises(RuntimeError, match="kernel fault"):
        intron_agreement.run_intron_agreement(str(work), device="cpu")
    assert cpu_offload.STATS["device_timeouts"] == 0


def test_stage4_refuses_the_jax_device_flag(tmp_path, monkeypatch):
    monkeypatch.setenv("PINTRON_DEVICE", "1")
    with pytest.raises(RuntimeError, match="PINTRON_DEVICE"):
        intron_agreement.run_intron_agreement(str(tmp_path), device="cpu")


def test_pipeline_routes_steps_2_and_4_to_the_device(golden, tmp_path,
                                                     monkeypatch):
    """python -m pintron_tpu_torch.pipeline --device cpu on test-788:
    byte-identical outputs, both device-flow log lines, and the -l log's
    record of STEPs 2-4 run by the port."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    gold = golden("test-788")
    work = tmp_path / "788"
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    rc = pipeline.main(["--device", "cpu", "--workdir", str(work),
                        "-o", "full.json", "-t", "pintron-all-isoforms.gtf",
                        "--gene=AAMP", "--organism=human", "-k"])
    assert rc == 0
    for name in ("full.json", "pintron-all-isoforms.gtf", "out-agree.txt",
                 *STAGE4):
        assert (work / name).read_bytes() == (gold / name).read_bytes(), \
            f"{name} differs"
    log = (work / "pintron-log.txt").read_text()
    assert "est-fact device flow: " in log
    assert "intron-agreement device flow: " in log
    steps = (work / "pintron-pipeline-log.txt").read_text()
    for label in ("cmd-2-est-fact", "cmd-3-min-factorization",
                  "cmd-4-intron-agreement", "cmd-5-compact-compositions"):
        assert f"[{label}] ok" in steps, label


def test_pipeline_resume_skips_done_steps(golden, tmp_path, monkeypatch):
    """With --resume, STEPs 2-4 whose outputs exist are skipped (the
    stages would fail on the missing ests.txt inputs they need)."""
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    gold = golden("test-788")
    work = tmp_path / "788"
    work.mkdir()
    for name in ("genomic.txt", "ests.txt", "raw-multifasta-out.txt",
                 "processed-ests.txt", "out-agree.txt", *STAGE4):
        shutil.copy(gold / name, work / name)

    def no_stage(*_a, **_k):
        raise AssertionError("a finished step ran again")

    monkeypatch.setattr(intron_agreement, "run_intron_agreement", no_stage)
    from pintron_tpu_torch.stages import est_fact
    monkeypatch.setattr(est_fact, "run_est_fact", no_stage)
    pipeline.pintron_pipeline(workdir=str(work), device="cpu",
                              output_filename="full.json", gene="AAMP",
                              organism="human", keep_intermediate=True,
                              resume=True)
    assert (work / "full.json").read_bytes() == \
        (gold / "full.json").read_bytes()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 33, 1000, 8425])
@pytest.mark.parametrize("name", MATRICES)
def test_pwm_kernel_bit_equal_to_plain_on_card(cuda_device, B, name):
    wpwm, den = pwm.pwm_tables(name)
    codes = torch.from_numpy(random_windows(B, B, 12)).to(cuda_device)
    w = torch.from_numpy(wpwm).to(cuda_device)
    before = limits.LAUNCHES["pwm"]
    got = pwm.pwm_scores_cuda(codes, w, den)
    want = pwm.pwm_scores(codes, w, den)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), pwm.pwm_scores(codes.cpu(), w.cpu(), den))
    assert limits.LAUNCHES["pwm"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,skew", [(8425, 12, 1), (1000, 7, 0),
                                      (300, 13, 3), (129, 256, 0),
                                      (64, 300, 0)])
def test_pwm_kernel_every_load_path_on_card(cuda_device, B, L, skew):
    """Views that start off a word boundary, widths under, over and far
    over the unrolled BPS width (the loop's tail), bit-equal to the
    plain version."""
    rng = np.random.default_rng(B + L)
    w = torch.from_numpy(rng.random((4, L)).astype(np.float32)).to(
        cuda_device)
    flat = torch.from_numpy(rng.integers(-1, 5, B * L + skew).astype(
        np.int8)).to(cuda_device)
    codes = flat[skew:].view(B, L)
    got = pwm.pwm_scores_cuda(codes, w, 3.25)
    want = pwm.pwm_scores(codes, w, 3.25)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
