"""The port's step over a device mesh (``parallel.mesh.make_mesh`` and
``sharded_alignment_step``) and the K-band route over a mesh
(``ops.offload._sharded_call``), on the CPU, against the JAX package's
``parallel/mesh.py`` and ``ops/offload.py`` on JAX's 8 virtual CPU
devices: distances, verdicts and supports exactly, scores within 1e-6
(the JAX op adds its PWM columns in another order); without a mesh the
K-band groups skip it.  STEP 2 over a mesh
on real data and ``dryrun_multichip`` are in test_torch_multihost.py.

JAX is imported inside the tests that compare with it, so the ``cuda``
test of this file runs on a GPU machine that has no JAX:
python -m pytest tests/test_torch_parallel.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from pintron_tpu_torch.ops import offload
from pintron_tpu_torch.ops.kband import (banded_edit_distance_cuda,
                                         batch_edit_distance_score_cuda)
from pintron_tpu_torch.parallel import mesh



@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in the processes the tests start: the
    plain ops are many tiny calls, and OpenMP teams spinning against the
    other test workers' stall them."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv(offload.SERVICE_ENV, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(name):
    """(arrays, static arguments) of a test batch: test_parallel.py's
    example batch, the edge batch (both verdicts, repeated ids), and an
    edge batch of 30 pairs, which divides by no shard count but 1."""
    if name == "test_parallel":
        arrays, denom = mesh.example_batch(batch=32, n_max=128, m_max=96,
                                           k_max=8, n_introns=16,
                                           locus_len=512)
        return arrays, dict(n_introns=16, max_rows=96, k_max=8,
                            denominator=denom)
    if name == "edge":
        return mesh.edge_batch()
    return mesh.edge_batch(seed=7, batch=30)


@functools.lru_cache(maxsize=None)
def _jax_step(name, n_data, n_seq=1):
    """The JAX package's sharded step on an n_data x n_seq mesh of its
    virtual CPU devices: (dist, scores, support)."""
    import jax
    from pintron_tpu.parallel.mesh import make_mesh, sharded_alignment_step
    arrays, kw = _batch(name)
    devs = jax.devices()[:n_data * n_seq]
    step = sharded_alignment_step(make_mesh(n_data, n_seq, devices=devs),
                                  **kw)
    return tuple(np.asarray(x) for x in step(*arrays)[:3])


def _port_step(name, shards):
    arrays, kw = _batch(name)
    step = mesh.sharded_alignment_step(mesh.make_mesh(shards, "cpu"), **kw)
    out = step(*mesh.to_device(arrays, "cpu"))
    assert [o.dtype for o in out] == [torch.int32, torch.float32,
                                      torch.int32]
    return [o.numpy() for o in out]


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("name", ["test_parallel", "edge", "odd"])
def test_sharded_step_matches_the_jax_step(name):
    """On make_mesh(1/4/8, "cpu") against the JAX step on the 1x1 mesh
    and, where the batch divides by 8, the 8x1 mesh."""
    for shards in (1, 4, 8):
        got = _port_step(name, shards)
        _assert_same(got, _jax_step(name, 1))
        if len(got[0]) % 8 == 0:
            _assert_same(got, _jax_step(name, 8))
        if name != "test_parallel":
            assert 0 < got[2].sum() < len(got[0])


def test_jax_seq_axis_multiplies_the_support():
    """A fault of the reference: its step psums the support over "data"
    and then over "seq", but its inputs are replicated along "seq", so
    on a mesh with n_seq > 1 every count comes out n_seq times too large
    (ROADMAP C6).  The port has no "seq" axis: its support is the 1x1
    mesh's."""
    one = _jax_step("edge", 1)[2]
    assert one.sum() > 0
    np.testing.assert_array_equal(_jax_step("edge", 4, 2)[2], 2 * one)
    np.testing.assert_array_equal(_port_step("edge", 8)[2], one)


def test_make_mesh_places_the_shards():
    m = mesh.make_mesh(3, "cpu")
    assert m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        mesh.make_mesh(0, "cpu")


def _problems(rng, route, count=50):
    """(a, b, ub) K-band problems of one route, a the longer."""
    out = []
    for _ in range(count):
        n = int(rng.integers(16, 120))
        a = rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes()
        b = bytearray(a[:n - int(rng.integers(0, 4))])
        # a few point changes, or (one time in three) a thorough shuffle
        for _ in range(int(rng.integers(0, 6)) if rng.random() < 0.67
                       else 4 * n):
            b[int(rng.integers(0, len(b)))] = int(rng.choice(list(b"ACGT")))
        # the band covers the matrix (2ub+1 >= n) on the full route only
        ub = (n + 1) // 2 if route == "full" else int(rng.integers(3, 6))
        out.append((a, bytes(b), ub))
    return out


@pytest.mark.parametrize("route", ["band", "full"])
def test_sharded_call_matches_the_jax_one(route):
    """The same arrays through the port's and the JAX package's
    _sharded_call over 2, 3 and 8 shards: the distances exactly, and
    the JAX call's within-budget total is the count of the port's
    distances within their budget; 50 problems (a multiple of none of
    the mesh sizes).  Each call is one of STATS["mesh_batches"]."""
    for n in (2, 3, 8):
        _compare_sharded_call(route, n)


def _compare_sharded_call(route, n):
    import jax
    from jax.sharding import Mesh
    from pintron_tpu.ops import align as jalign
    from pintron_tpu.ops import offload as joff
    probs = _problems(np.random.default_rng(n), route)
    N, M = 128, offload._p4(max(len(b) for _a, b, _u in probs))
    s1, l1 = offload._encode([a for a, _b, _u in probs], N)
    s2, l2 = offload._encode([b for _a, b, _u in probs], M)
    ub = np.array([u for _a, _b, u in probs], dtype=np.int32)
    if route == "band":
        K = offload._p2(int(ub.max()), lo=2)
        arrays = [s1, l1, s2, l2, ub]
        fn = functools.partial(banded_edit_distance_cuda, max_rows=M,
                               k_max=K)
        jfn = functools.partial(jalign.banded_edit_distance, max_rows=M,
                                k_max=K)
    else:
        arrays = [s1, l1, s2, l2]
        fn = functools.partial(batch_edit_distance_score_cuda, max_rows=M)
        jfn = functools.partial(jalign.batch_edit_distance_score,
                                max_rows=M)
    sharded0 = offload.STATS["mesh_batches"]
    dist = offload._sharded_call(mesh.make_mesh(n, "cpu"), fn, arrays)
    assert offload.STATS["mesh_batches"] == sharded0 + 1
    jmesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    jdist, jtotal = joff._sharded_call(jmesh, jfn, arrays, ub,
                                       key=("test", route, n))
    np.testing.assert_array_equal(dist.numpy(), jdist)
    assert int((dist <= torch.from_numpy(ub)).sum()) == jtotal
    assert 0 < jtotal < len(probs)


@pytest.mark.parametrize("route", ["band", "full"])
def test_a_mesh_of_one_is_the_plain_call(route, monkeypatch):
    """With PINTRON_TORCH_MESH unset, _eval_kband_device sends each
    K-band group to the batch's device whole: the verdicts of ep_kband
    and of the JAX entry, neither _sharded_call nor map_shards called,
    STATS["mesh_batches"] unchanged.  At 2 the same batch gives the
    same verdicts, and each group is one sharded batch."""
    from pintron_tpu.ops import offload as joff
    from pintron_tpu_torch.native import get_lib
    from test_device_offload import _host_ep_kband_ok
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(offload, "_sharded_call",
                        spy("_sharded_call", offload._sharded_call))
    monkeypatch.setattr(mesh, "map_shards", spy("map_shards", mesh.map_shards))
    monkeypatch.delenv(offload.MESH_ENV, raising=False)
    probs = _problems(np.random.default_rng(17), route)
    want = [_host_ep_kband_ok(lib, a, b, ub) for a, b, ub in probs]
    np.testing.assert_array_equal(joff.eval_kband(probs), want)
    for shards, sharded in ((None, False), ("2", True)):
        if shards:
            monkeypatch.setenv(offload.MESH_ENV, shards)
        st0 = dict(offload.STATS)
        got = offload._eval_kband_device(probs, torch.device("cpu"))
        np.testing.assert_array_equal(got, want)
        groups = offload.STATS["batches"] - st0["batches"]
        assert groups >= 1
        assert (offload.STATS["mesh_batches"] - st0["mesh_batches"]
                == (groups if sharded else 0))
        assert calls == (["_sharded_call", "map_shards"] * groups
                         if sharded else [])
        calls.clear()


def test_the_jax_mesh_switch_is_refused(tmp_path, monkeypatch):
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    monkeypatch.delenv("PINTRON_DEVICE", raising=False)
    monkeypatch.setenv("PINTRON_DEVICE_MESH", "8")
    with pytest.raises(RuntimeError, match="PINTRON_DEVICE_MESH"):
        run_est_fact(str(tmp_path), device="cpu")


def test_suffix_tree_save_load_roundtrip(tmp_path):
    """SuffixTree.save/load (the shared index the ranks attach) must
    reproduce every flat array, the leaf indexes and the text exactly:
    the vertex scan reads full-capacity slices, so the saved layout must
    match the built one bit for bit."""
    from pintron_tpu_torch.index.gst import SuffixTree

    rng = np.random.default_rng(11)
    for _ in range(3):
        n = int(rng.integers(100, 4000))
        text = bytes(rng.choice(list(b"ACGTN"), n))
        t1 = SuffixTree(text)
        prefix = str(tmp_path / "idx")
        t1.save(prefix)
        t2 = SuffixTree.load(prefix)
        assert t2.text == t1.text
        f1, f2 = t1.flat_arrays(), t2.flat_arrays()
        for k in ("start", "end", "parent", "slink", "depth", "single",
                  "lo", "hi", "occ", "coff", "cchar", "cnode"):
            assert np.array_equal(np.asarray(f1[k]), np.asarray(f2[k])), k
        assert np.array_equal(np.asarray(t1.leaf_idx),
                              np.asarray(t2.leaf_idx))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_step_on_the_card_equals_the_step(shards):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    arrays, kw = _batch("edge")
    args = mesh.to_device(arrays, "cuda")
    got = mesh.sharded_alignment_step(mesh.make_mesh(shards), **kw)(*args)
    want = mesh.plain_alignment_step(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    assert int(got[2].sum()) > 0
