"""The port's copies of two host modules that no pipeline step imports:
``io/gen_ests.py`` (the bundled genomic + per-EST MEG format of
src/io-gen-ests.c) and ``tools/test_data_create.py`` (src/test-data-
create.c), held to the JAX package's modules on the same inputs."""

import io
import os
import subprocess
import sys

from pintron_tpu.io import gen_ests as jax_gen_ests
from pintron_tpu.io import meg as jax_meg
from pintron_tpu.tools import test_data_create as jax_tdc
from pintron_tpu_torch.io import gen_ests, meg
from pintron_tpu_torch.tools import test_data_create as tdc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _megs(path, read_meg):
    """(header, sequence, MEG) of each EST of a golden megs.txt (blocks
    opened by a line of stars: the EST's header and sequence, then its
    MEG in the io-meg format)."""
    with open(path) as f:
        blocks = f.read().split("***********\n")
    out = []
    for block in blocks:
        lines = [ln for ln in block.splitlines() if ln.strip()]
        if not lines:
            continue
        body = io.StringIO("\n".join(lines[2:]) + "\n#\\#\n")
        out.append((lines[0].lstrip(">"), lines[1], read_meg(body)))
    return out


def _write(module, gen, megs):
    buf = io.StringIO()
    module.write_gen_ests(buf, gen, [((h, s), m) for h, s, m in megs])
    return buf.getvalue()


def test_gen_ests_round_trip_equals_the_jax_modules(golden):
    case = golden("test-788")
    with open(case / "genomic.txt") as f:
        header, seq = f.read().split("\n", 1)
    gen = (header.lstrip(">"), seq.replace("\n", ""))
    port_megs = _megs(case / "megs.txt", meg.read_meg)
    jax_megs = _megs(case / "megs.txt", jax_meg.read_meg)
    # 10 ESTs, some of them with the MEG of their reverse complement too
    sizes = [sum(map(len, m)) for _h, _s, m in port_megs]
    assert len(sizes) >= 10 and min(sizes) >= 2 and max(sizes) > 10
    text = _write(gen_ests, gen, port_megs)
    assert text == _write(jax_gen_ests, gen, jax_megs)
    assert text.startswith("#GENOMICA#\n")
    assert text.count("#EST#\n") == len(port_megs)

    got_gen, got = gen_ests.read_gen_ests(io.StringIO(text))
    want_gen, want = jax_gen_ests.read_gen_ests(io.StringIO(text))
    assert got_gen == want_gen == gen
    assert [e for e, _m in got] == [e for e, _m in want] == [
        (h, s) for h, s, _m in port_megs]
    again = _write(gen_ests, got_gen, [(h, s, m) for (h, s), m in got])
    assert again == text == _write(jax_gen_ests, want_gen,
                                   [(h, s, m) for (h, s), m in want])


REPORT = """\
est-fact report
EST factorizations:
a line before the first row, skipped
1 est-1 + 10 20 100 110 . ACGTACGTAC
2 100 110 10 20 . ACGTACGTAC
2 200 215 21 36 . GGGCCCAAATTTGGG
2 300 305 37 42 . X
1 est-2 - 7 15 400 408 . X
2 420 430 1 11 . TTTTTAAAAA
2 440 450 12 22 . CCCCCGGGGG
1 est-3 + 1 9 500 508 . ACGTACGTA
Distinct factorizations: 3
EST factorizations:
1 est-4 + 1 5 600 604 . ACGTA
"""


def test_test_data_create_equals_the_jax_tool():
    outs = []
    for module in (tdc, jax_tdc):
        out, err = io.StringIO(), io.StringIO()
        module.test_create(io.StringIO(REPORT), out, err)
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0].startswith(">est-1\nACGTACGTAC\n")
    # the shifted-coordinate mode: est-2's exons rebased to its 15; the
    # first row after a record's header is consumed unread (the C's quirk)
    assert ">est-2\n425\t 435\t 12\t 22\n>est-3" in outs[0][1]
    r = subprocess.run([sys.executable, "-m",
                        "pintron_tpu_torch.tools.test_data_create"],
                       input=REPORT, capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0 and (r.stdout, r.stderr) == outs[0]
