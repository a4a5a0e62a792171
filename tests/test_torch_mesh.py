"""The port's batched scoring step (``pintron_tpu_torch.parallel.mesh``)
and its entry point (``pintron_tpu_torch.graft_entry.entry``) against
the JAX package's ``parallel/mesh.py`` and ``__graft_entry__.entry`` on
JAX's CPU backend: ``dist`` and ``support`` exactly equal, ``scores``
within 1e-6 (the JAX op adds its PWM columns in another order).

JAX is imported inside the tests that compare with it, so the ``cuda``
test of this file runs on a GPU machine that has no JAX:
python -m pytest tests/test_torch_mesh.py -m cuda
"""

import numpy as np
import pytest
import torch

from pintron_tpu_torch.graft_entry import entry
from pintron_tpu_torch.ops import limits
from pintron_tpu_torch.parallel import mesh

# (batch, n_max, max_rows, k_max, n_introns): entry()'s sizes and
# tests/test_parallel.py's
SIZES = {"entry": (64, 256, 192, 16, 32), "test_parallel": (32, 128, 96, 8,
                                                            16)}


def _jax_step(arrays, denom, n_introns, max_rows, k_max):
    from pintron_tpu.parallel.mesh import alignment_step
    import jax

    fn = jax.jit(alignment_step, static_argnames=(
        "n_introns", "max_rows", "k_max", "denominator"))
    out = fn(*arrays[:8], n_introns=n_introns, max_rows=max_rows,
             k_max=k_max, denominator=denom)
    return [np.asarray(o) for o in out]


def _port_step(arrays, denom, n_introns, max_rows, k_max):
    args = mesh.to_device(arrays, "cpu")
    out = mesh.alignment_step(*args, n_introns, max_rows=max_rows,
                              k_max=k_max, denominator=denom)
    assert [o.dtype for o in out] == [torch.int32, torch.float32,
                                      torch.int32]
    return [o.numpy() for o in out]


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == want[1].dtype == np.float32


@pytest.mark.parametrize("size", list(SIZES))
def test_example_batch_equals_the_jax_packages(size):
    from pintron_tpu.parallel.mesh import example_batch as jax_example
    batch, n_max, max_rows, k_max, n_introns = SIZES[size]
    kw = dict(batch=batch, n_max=n_max, m_max=max_rows, k_max=k_max,
              n_introns=n_introns)
    if size == "test_parallel":
        kw["locus_len"] = 512
    got, denom = mesh.example_batch(**kw)
    want, jdenom = jax_example(**kw)
    assert denom == jdenom
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", list(SIZES))
def test_alignment_step_matches_the_jax_step(size):
    batch, n_max, max_rows, k_max, n_introns = SIZES[size]
    arrays, denom = mesh.example_batch(batch=batch, n_max=n_max,
                                       m_max=max_rows, k_max=k_max,
                                       n_introns=n_introns)
    got = _port_step(arrays, denom, n_introns, max_rows, k_max)
    _assert_same(got, _jax_step(arrays, denom, n_introns, max_rows, k_max))


def test_alignment_step_edge_batch_matches_the_jax_step():
    arrays, kw = mesh.edge_batch()
    n_introns = kw["n_introns"]
    static = (kw["denominator"], n_introns, kw["max_rows"], kw["k_max"])
    got = _port_step(arrays, *static)
    _assert_same(got, _jax_step(arrays, *static))
    ok = got[0] <= arrays[4]
    assert 0 < ok.sum() < len(ok), "the batch must have both verdicts"
    assert got[2][n_introns // 2:].sum() == 0 and got[2].sum() == ok.sum()
    assert np.bincount(arrays[7], minlength=n_introns).max() > 1


def test_to_device_gives_the_kernels_types():
    arrays, _kw = mesh.edge_batch()
    args = mesh.to_device(arrays, "cpu")
    assert [a.dtype for a in args] == [
        torch.int8, torch.int32, torch.int8, torch.int32, torch.int32,
        torch.int8, torch.float32, torch.int64]
    # every code outside 0..3 is -1, so none wraps into 0..3 (260 would)
    donor = args[5].numpy()
    assert donor[0, 0] == donor[1, 3] == donor[2, 5] == donor[3, -1] == -1
    np.testing.assert_array_equal(donor[5:], arrays[5][5:])


def test_entry_runs_on_the_cpu_and_matches_the_jax_entry():
    import importlib.util
    import os

    fn, args = entry("cpu")
    assert len(args) == 8 and all(a.device.type == "cpu" for a in args)
    dist, scores, support = fn(*args)
    assert dist.shape == (64,) and scores.shape == (64,)
    assert support.shape == (32,)
    assert torch.isfinite(scores).all()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "graft_entry_jax", os.path.join(repo, "__graft_entry__.py"))
    jax_entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_entry)
    jfn, jargs = jax_entry.entry()
    want = [np.asarray(o) for o in jfn(*jargs)]
    _assert_same([dist.numpy(), scores.numpy(), support.numpy()], want)


def test_entry_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry()


@pytest.mark.cuda
def test_entry_on_the_card_equals_the_plain_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    fn, args = entry()
    before = dict(limits.LAUNCHES)
    got = fn(*args)
    torch.cuda.synchronize()
    assert limits.LAUNCHES["kband"] == before["kband"] + 1
    assert limits.LAUNCHES["pwm"] == before["pwm"] + 1
    want = mesh.plain_alignment_step(*args, **fn.keywords)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cpu = mesh.alignment_step(*(a.cpu() for a in args), **fn.keywords)
    for g, w in zip(got, cpu):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_edge_batch_on_the_card_equals_the_plain_and_cpu_step():
    """Pairs within their band and over it, repeated intron ids, donor
    codes outside 0..3: the scatter of the kernel's verdicts is checked
    on counts above 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    arrays, kw = mesh.edge_batch()
    args = mesh.to_device(arrays, "cuda")
    got = mesh.alignment_step(*args, **kw)
    want = mesh.plain_alignment_step(*args, **kw)
    cpu = mesh.alignment_step(*mesh.to_device(arrays, "cpu"), **kw)
    torch.cuda.synchronize()
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(g, w)
        assert torch.equal(g.cpu(), c)
    assert 0 < int(got[2].sum()) < len(arrays[0])
