"""The port stands alone: importing the package, every module of it and
chip_smoke.py loads neither ``jax`` nor any module of the JAX package
``pintron_tpu``; the port's native library is its own; STEP 2 and the
whole pipeline reproduce the goldens with the JAX package made
unimportable; the entry points default to the card and raise without
one; and chip_smoke.py refuses to run without a CUDA device or outside
a checkout."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import pintron_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = ["pintron_tpu_torch"]
    for info in pkgutil.walk_packages(pintron_tpu_torch.__path__,
                                      "pintron_tpu_torch."):
        names.append(info.name)
    return names


def _run(code, cwd=REPO, env=None):
    env = dict(os.environ if env is None else env)
    env.pop("PINTRON_DEVICE", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _jax_package(name: str) -> bool:
    return name in ("jax", "pintron_tpu") or name.startswith(
        ("jax.", "pintron_tpu."))


def _imported_after_all_port_modules():
    mods = _port_modules()
    assert "pintron_tpu_torch.stages.est_fact" in mods
    assert "pintron_tpu_torch.ops.kband" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "sys.path.insert(0, '.')\n"
            "import chip_smoke\n"
            "print('\\n'.join(sys.modules))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_port_imports_no_jax():
    assert "jax" not in _imported_after_all_port_modules()


def test_port_imports_no_module_of_the_jax_package():
    """Not even a module of pintron_tpu that does not import JAX: the
    port keeps its own copies."""
    loaded = _imported_after_all_port_modules()
    assert "pintron_tpu_torch.stages.est_fact" in loaded
    assert [m for m in loaded if _jax_package(m)] == []


def test_a_service_clients_modules_import_no_torch():
    """A fresh interpreter that imports what a service client runs (the
    batch driver, the pipeline, every STEP, the offload, the recorder)
    loads no torch: a job of ``batch.py`` starts with the interpreter,
    numpy and the port."""
    code = ("import importlib, pkgutil, sys\n"
            "import pintron_tpu_torch.stages as stages\n"
            "for m in ('batch', 'pipeline', 'ops.offload', "
            "'runtime.timing'):\n"
            "    importlib.import_module('pintron_tpu_torch.' + m)\n"
            "for info in pkgutil.iter_modules(stages.__path__):\n"
            "    importlib.import_module('pintron_tpu_torch.stages.' "
            "+ info.name)\n"
            "assert 'pintron_tpu_torch.stages.est_fact' in sys.modules\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith('torch.')))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_port_sources_name_no_jax():
    """No import statement of the port or of chip_smoke.py names JAX or
    the JAX package's ``ops`` (which imports JAX); a file path of a
    replaced TPU kernel in a string is no import."""
    pat = re.compile(
        r"^\s*(import\s+(jax|pintron_tpu\.ops)\b"
        r"|from\s+(jax|pintron_tpu\.ops)\b"
        r"|from\s+pintron_tpu\s+import\s+.*\bops\b)"
        r"|import_module\(\s*['\"](jax|pintron_tpu\.ops)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(pintron_tpu_torch.__path__[0]):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu"))]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.search(line), f"{path}:{i}: {line.strip()}"


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(pintron_tpu_torch.__path__[0]):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu"))]
    return files


def test_port_sources_import_nothing_of_the_jax_package():
    """No ``import pintron_tpu...`` or ``from pintron_tpu...`` that is
    not the port, in any form, and no import_module of one."""
    pat = re.compile(
        r"^\s*(import\s+([\w.]+\s*,\s*)*pintron_tpu(\.|\s|,|$)"
        r"|from\s+pintron_tpu(\.|\s))"
        r"|import_module\(\s*['\"]pintron_tpu(\.|['\"])")
    for path in _port_sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.search(line), f"{path}:{i}: {line.strip()}"
    assert pat.search("from pintron_tpu.native import get_lib")
    assert pat.search("import os, pintron_tpu.config")
    assert not pat.search("from pintron_tpu_torch.native import get_lib")


def test_native_library_is_the_ports_own():
    """The port builds dp.c into build/native/ of the checkout, not into
    the JAX package's cache, so the two libraries keep two sets of C
    globals (the memo, the gap lookaside)."""
    from pintron_tpu_torch import native
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C compiler")
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(
        os.path.join(REPO, "build", "native"))
    import pintron_tpu.native as ref_native
    ref = ref_native.get_lib()
    if ref is not None:
        assert os.path.realpath(ref._name) != path
        assert ref is not lib


# A subprocess that cannot import the JAX package: the port alone.
_ALONE = """
import importlib.abc, sys
class Absent(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "pintron_tpu") or name.startswith(
                ("jax.", "pintron_tpu.")):
            raise ImportError(f"{name} is absent")
sys.meta_path.insert(0, Absent())
what, workdir, device, gene = sys.argv[1:]
if what == "step2":
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    run_est_fact(workdir, device=device)
else:
    from pintron_tpu_torch import pipeline
    assert pipeline.main(["--device", device, "--workdir", workdir,
                          "-o", "full.json", "-t", "pintron-all-isoforms.gtf",
                          f"--gene={gene}", "--organism=human", "-k"]) == 0
print(sorted(m for m in sys.modules if m == "jax" or m == "pintron_tpu"
             or m.startswith(("jax.", "pintron_tpu."))))
"""

STEP2_FILES = ("raw-multifasta-out.txt", "processed-ests.txt", "megs.txt",
               "processed-megs.txt", "meg-edges.txt")
# the finals (STEPs 5-8) and STEPs 2-4's artifacts; STEP 5's
# build-ests.txt follows the reference's per-process hash order, so only
# what is made from it is compared
PIPELINE_FILES = ("full.json", "pintron-all-isoforms.gtf",
                  "raw-multifasta-out.txt", "out-agree.txt",
                  "out-after-intron-agree.txt", "predicted-introns.txt")


@pytest.mark.parametrize("device", ["host", "cpu"])
@pytest.mark.parametrize("what,case,gene", [
    ("step2", "test-AMBN", "AMBN"), ("step2", "test-TP53", "TP53"),
    ("pipeline", "test-AMBN", "AMBN"), ("pipeline", "test-788", "AAMP")])
def test_port_alone_reproduces_the_goldens(golden, tmp_path, what, case,
                                           gene, device):
    """STEP 2 on AMBN and TP53, and the whole pipeline (STEPs 1-8, all
    in the port) on AMBN and 788, with the JAX package unimportable:
    byte for byte the goldens, with device="host" and device="cpu"."""
    gold = golden(case)
    work = tmp_path / case
    work.mkdir()
    for name in ("genomic.txt", "ests.txt"):
        shutil.copy(gold / name, work / name)
    # one intra-op thread: the plain ops are many tiny calls, and spinning
    # thread pools stall under the parallel test workers
    env = dict(os.environ, PINTRON_EST_WORKERS="2", OMP_NUM_THREADS="1")
    env.pop("PINTRON_DEVICE", None)
    r = subprocess.run([sys.executable, "-c", _ALONE, what, str(work),
                        device, gene], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    for name in STEP2_FILES if what == "step2" else PIPELINE_FILES:
        assert (work / name).read_bytes() == (gold / name).read_bytes(), \
            f"{name} differs from golden"


def _entry_points():
    from pintron_tpu_torch import batch, bench, fuzz_device, pipeline
    import numpy as np
    from pintron_tpu_torch.graft_entry import dryrun_multichip, entry
    from pintron_tpu_torch.index.kmer import KmerIndex
    from pintron_tpu_torch.parallel import make_mesh, multihost
    from pintron_tpu_torch.factorize import classify
    from pintron_tpu_torch.stages import est_fact, intron_agreement
    return {
        "run_est_fact": lambda w: est_fact.run_est_fact(w),
        "run_intron_agreement":
            lambda w: intron_agreement.run_intron_agreement(w),
        "precompute_bps_device":
            lambda w: classify.precompute_bps_device("ACGT" * 64, [(4, 200)]),
        "pintron_pipeline": lambda w: pipeline.pintron_pipeline(w),
        "pipeline.main": lambda w: pipeline.main(["--workdir", w]),
        "batch.main":
            lambda w: batch.main(["--manifest", os.path.join(w, "jobs.tsv")]),
        "entry": lambda w: entry(),
        "bench.main": lambda w: bench.main([]),
        "fuzz_device.main": lambda w: fuzz_device.main([]),
        "dryrun_multichip": lambda w: dryrun_multichip(2),
        "run_est_fact_multiprocess":
            lambda w: multihost.run_est_fact_multiprocess(w, 2),
        "multihost.main": lambda w: multihost.main([w]),
        "make_mesh": lambda w: make_mesh(2),
        "lookup_ranges_device": lambda w: KmerIndex(
            b"ACGT" * 8, k=4).lookup_ranges_device(np.arange(4)),
    }


@pytest.mark.parametrize("entry", ["run_est_fact", "run_intron_agreement",
                                   "precompute_bps_device",
                                   "pintron_pipeline", "pipeline.main",
                                   "batch.main", "entry", "bench.main",
                                   "fuzz_device.main", "dryrun_multichip",
                                   "run_est_fact_multiprocess",
                                   "multihost.main", "make_mesh",
                                   "lookup_ranges_device"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Called with no device argument and no card, every entry point
    raises, before any work and without falling back to the CPU."""
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.delenv("PINTRON_TORCH_SERVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "jobs.tsv").write_text(
        f"{tmp_path}/w\t{tmp_path}/g.txt\t{tmp_path}/e.txt\tX\n")
    with pytest.raises(RuntimeError, match="is_available"):
        _entry_points()[entry](str(tmp_path))


def test_device_none_is_refused(tmp_path, monkeypatch):
    from pintron_tpu_torch.stages import est_fact
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    with pytest.raises(ValueError, match="device=None"):
        est_fact.run_est_fact(str(tmp_path), device=None)


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=lone, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
