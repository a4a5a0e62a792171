"""The port's CLI (``python -m pintron_tpu_torch.pipeline``) end to end on
the CPU, and what it refuses."""

import shutil

import pytest

from pintron_tpu_torch import pipeline


def test_pipeline_cpu_device_byte_identical(golden, tmp_path, monkeypatch):
    """STEPs 2 and 4 on the device, STEP 3 and STEPs 5-8 on the host,
    all in the port; stale outputs of an earlier run's later steps are
    not picked up."""
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    gold = golden("test-AMBN")
    work = tmp_path / "ambn"
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    for name in ("out-agree.txt", "out-after-intron-agree.txt",
                 "predicted-introns.txt", "build-ests.txt",
                 "genomic-exonforCCDS.txt", "isoforms.txt",
                 "CCDS_transcripts.txt", "VariantGTF.txt"):
        (work / name).write_text("stale\n")
    rc = pipeline.main(["--device", "cpu", "--workdir", str(work),
                        "-g", "genomic.txt", "-s", "ests.txt",
                        "-o", "full.json", "-t", "pintron-all-isoforms.gtf",
                        "--gene=AMBN", "--organism=human", "-k"])
    assert rc == 0
    for name in ("full.json", "pintron-all-isoforms.gtf",
                 "raw-multifasta-out.txt", "predicted-introns.txt"):
        assert (work / name).read_bytes() == (gold / name).read_bytes(), \
            f"{name} differs"
    log = (work / "pintron-log.txt").read_text()
    assert "est-fact device flow: " in log
    assert "intron-agreement device flow: " in log


@pytest.mark.parametrize("var", ["PINTRON_DEVICE", "PINTRON_JAX_PROFILE"])
def test_pipeline_refuses_jax_device_flag(tmp_path, monkeypatch, var):
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.setenv(var, "1")
    with pytest.raises(RuntimeError, match=var):
        pipeline.pintron_pipeline(workdir=str(tmp_path), device="cpu")
