"""The port's device fuzz (``pintron_tpu_torch.fuzz_device``) and its
copy of the synthetic locus generator
(``pintron_tpu_torch.tools.scale_stress.make_case``): the copy writes
the JAX package's tool's files byte for byte, and STEP 2 with
``device="cpu"`` (every DP family on the plain PyTorch ops) equals the
native host path byte for byte on random spliced loci."""

import importlib.util
import os

import pytest

from pintron_tpu_torch import fuzz_device
from pintron_tpu_torch.tools.scale_stress import make_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "scale_stress_ref", os.path.join(REPO, "tools", "scale_stress.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("glen,n_ests,seed", [
    (5_000, 12, 1), (20_000, 30, 4000), (50_000, 60, 7)])
def test_make_case_writes_the_reference_tools_files(tmp_path, glen, n_ests,
                                                     seed):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    assert make_case(str(ours), glen, n_ests, seed) == n_ests
    assert _reference_tool().make_case(str(ref), glen, n_ests, seed) == n_ests
    for name in ("genomic.txt", "ests.txt"):
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


def test_grid_is_the_reference_tools():
    cases = fuzz_device.grid()
    assert len(cases) == 15 and cases[0] == (4000, 20_000, 30)
    assert cases[4] == (4004, 50_000, 60)
    assert cases[8] == (4008, 100_000, 120)
    assert cases[9] == (4009, 20_000, 30)
    assert {(g, n) for _s, g, n in fuzz_device.grid(9)} == {
        (g, n) for g in (20_000, 50_000, 100_000) for n in (30, 60, 120)}


@pytest.mark.parametrize("seed", [4000, 4001])
def test_step2_on_the_plain_ops_equals_the_host_path(seed, monkeypatch):
    # one intra-op thread: the plain ops are many tiny calls, and
    # spinning thread pools stall under the parallel test workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PINTRON_EST_WORKERS", "2")
    res = fuzz_device.run_case(seed, 20_000, 30, "cpu")
    assert res["ok"], res["detail"]
    routes = res["routes"]
    stats = routes["stats"]
    assert stats["device_problems"] > 0 and stats["batches"] > 0
    assert stats["kband_ub_max"] >= 1
    # the plain ops launch no kernel
    assert not any(routes["launches"].values())
    assert "full-matrix K-band launches 0" in fuzz_device.routes_line(routes)
