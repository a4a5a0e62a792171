"""The port never imports JAX: importing the package, every module of it
and chip_smoke.py leaves ``jax`` out of ``sys.modules``; and chip_smoke.py
refuses to run without a CUDA device or outside a checkout."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

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


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "pintron_tpu_torch.stages.est_fact" in mods
    assert "pintron_tpu_torch.ops.kband" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "sys.path.insert(0, '.')\n"
            "import chip_smoke\n"
            "print('jax' in sys.modules)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


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
