"""The batched scoring step of the alignment engine on one device.

Counterpart of the JAX package's ``parallel/mesh.py`` (its
``alignment_step`` and ``example_batch``).  For a batch of (EST window,
genomic window) pairs the step computes the K-band edit distances
(``kband_kernel``), the donor PWM scores (``pwm_kernel``) and the
support of each candidate intron, the number of its pairs whose
distance is within their band, scattered with ``index_add_``.  Integer
adds give the same counts in any order, so no kernel of its own is
needed for the scatter.

On tensors on the CPU the two kernel wrappers run their plain PyTorch
versions; on a CUDA device they launch the kernels or raise.

``make_mesh`` and ``sharded_alignment_step`` shard the step over the
``"data"`` axis of a device mesh: contiguous chunks of the batch, one a
device (``map_shards``, which the offload's K-band route over a mesh
uses too), and the support summed over the chunks, the counterpart of
the JAX step's ``psum`` over ``"data"``.  The JAX mesh's ``"seq"`` axis is
not ported: it serves only a synthetic histogram, and the JAX step
psums the support over it too, although its inputs are replicated along
it, so its support comes out multiplied by the ``"seq"`` size.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pintron_tpu_torch.ops.kband import banded_edit_distance_cuda
from pintron_tpu_torch.ops.offload import check_card
from pintron_tpu_torch.ops.pwm import pwm_scores_cuda, pwm_tables


def alignment_step(est_codes, est_lens, gen_codes, gen_lens, bands,
                   donor_idx, weighted_pwm, intron_ids, n_introns: int,
                   *, max_rows: int, k_max: int, denominator: float):
    """One batched scoring step: returns (dist, scores, support).

    ``dist`` (B,) int32, the K-band distance of each genomic window
    (the longer sequence) against its EST window; ``scores`` (B,)
    float32, the PWM score of each donor window (int8 codes, see
    ``to_device``); ``support`` (n_introns,) int32, for each intron the
    number of pairs with ``dist <= band``.  Every tensor lies on one
    device."""
    dist = banded_edit_distance_cuda(gen_codes, gen_lens, est_codes,
                                     est_lens, bands, max_rows=max_rows,
                                     k_max=k_max)
    scores = pwm_scores_cuda(donor_idx, weighted_pwm, denominator)
    return dist, scores, intron_support(dist, bands, intron_ids, n_introns)


def intron_support(dist, bands, intron_ids, n_introns: int):
    """(n_introns,) int32: for each intron, its pairs with ``dist <=
    band``.  Integer adds, so the same counts in any order."""
    ok = (dist <= bands).to(torch.int32)
    support = torch.zeros(n_introns, dtype=torch.int32, device=dist.device)
    return support.index_add_(0, intron_ids.long(), ok)


class Mesh(NamedTuple):
    """A one-axis (``"data"``) device mesh: shard i of a batch lies on
    ``devices[i]``."""
    devices: Tuple[torch.device, ...]


def make_mesh(n_data: int, device="cuda") -> Mesh:
    """A mesh of ``n_data`` shards on ``device``: with ``"cuda"``, shard
    i lies on ``cuda:(i % k)`` of the k cards (on one card every shard
    lies on ``cuda:0``); with ``"cuda:N"`` on that card; with ``"cpu"``
    on the CPU.  ``"cuda"`` raises without a card."""
    if n_data < 1:
        raise ValueError(f"n_data={n_data}: a mesh needs a shard")
    device = check_card(device)
    if device.type == "cuda" and device.index is None:
        k = torch.cuda.device_count()
        return Mesh(tuple(torch.device("cuda", i % k)
                          for i in range(n_data)))
    return Mesh((device,) * n_data)


def map_shards(mesh: Mesh, fn, *batch):
    """``fn(device, *chunk)`` on each shard's contiguous chunk of the
    ``batch`` tensors (``tensor_split`` on the leading axis, no padding),
    the chunk moved to the shard's device; an empty chunk is skipped.
    ``fn`` returns a tuple of tensors.  Returns each shard's outputs,
    moved to the mesh's first device, in shard order."""
    first = mesh.devices[0]
    parts = [torch.tensor_split(t, len(mesh.devices)) for t in batch]
    outs = []
    for s, dev in enumerate(mesh.devices):
        chunk = [p[s] for p in parts]
        if chunk[0].shape[0] == 0:
            continue
        outs.append(tuple(r.to(first)
                          for r in fn(dev, *(c.to(dev) for c in chunk))))
    return outs


def sharded_alignment_step(mesh: Mesh, n_introns: int, *, max_rows: int,
                           k_max: int, denominator: float):
    """``alignment_step`` over ``mesh``: returns a callable on the eight
    tensors of ``to_device`` that runs each shard's step on its chunk of
    the batch (``map_shards``) and returns ``dist`` and ``scores`` in
    batch order and ``support`` summed over the shards (integer adds:
    the same counts in any order), all on the mesh's first device."""

    def step(est_codes, est_lens, gen_codes, gen_lens, bands, donor_idx,
             weighted_pwm, intron_ids):
        def shard(dev, *chunk):
            return alignment_step(*chunk[:6], weighted_pwm.to(dev),
                                  chunk[6], n_introns, max_rows=max_rows,
                                  k_max=k_max, denominator=denominator)

        dist, scores, support = zip(*map_shards(
            mesh, shard, est_codes, est_lens, gen_codes, gen_lens, bands,
            donor_idx, intron_ids))
        return (torch.cat(dist), torch.cat(scores),
                torch.stack(support).sum(0, dtype=torch.int32))

    return step


def plain_alignment_step(est_codes, est_lens, gen_codes, gen_lens, bands,
                         donor_idx, weighted_pwm, intron_ids,
                         n_introns: int, *, max_rows: int, k_max: int,
                         denominator: float):
    """``alignment_step`` with the kernels' plain versions on the
    tensors' own device: what ``chip_smoke.py`` and the tests hold the
    step against on the card."""
    from pintron_tpu_torch.ops import align, pwm
    dist = align.banded_edit_distance(gen_codes, gen_lens, est_codes,
                                      est_lens, bands, max_rows=max_rows,
                                      k_max=k_max)
    scores = pwm.pwm_scores(donor_idx, weighted_pwm, denominator)
    return dist, scores, intron_support(dist, bands, intron_ids, n_introns)


def example_batch(batch: int = 64, n_max: int = 256, m_max: int = 192,
                  k_max: int = 16, pwm_name: str = "P5_GTAG_U2",
                  n_introns: int = 32, locus_len: int = 1024, seed: int = 0):
    """Synthetic inputs shaped like an EST batch, as numpy arrays: the
    JAX package's ``example_batch``, array for array for the same
    arguments.  Returns ((est_codes, est_lens, gen_codes, gen_lens,
    bands, donor_idx, weighted_pwm, intron_ids, locus), denominator)."""
    rng = np.random.default_rng(seed)
    gen_codes = rng.integers(0, 4, (batch, n_max), dtype=np.int8)
    est_codes = rng.integers(0, 4, (batch, m_max), dtype=np.int8)
    gen_lens = rng.integers(m_max // 2, n_max, (batch,), dtype=np.int32)
    est_lens = np.minimum(
        rng.integers(m_max // 2, m_max, (batch,), dtype=np.int32), gen_lens)
    bands = np.full((batch,), k_max, dtype=np.int32)
    wpwm, denom = pwm_tables(pwm_name)
    L = wpwm.shape[1]
    donor_idx = rng.integers(0, 4, (batch, L), dtype=np.int32)
    intron_ids = rng.integers(0, n_introns, (batch,), dtype=np.int32)
    locus = rng.integers(0, 4, (locus_len,), dtype=np.int32)
    return (est_codes, est_lens, gen_codes, gen_lens, bands, donor_idx,
            wpwm.astype(np.float32), intron_ids, locus), denom


def edge_batch(seed: int = 5, batch: int = 48, n_max: int = 160,
               max_rows: int = 128, k_max: int = 8, n_introns: int = 6):
    """An ``example_batch`` with the cases it lacks: ESTs cut from their
    genomic windows with a few point changes, so that some pairs are
    within their band and some are not (lengths apart by more than the
    band, too many changes), every intron id in the lower half and
    repeated, and donor codes outside 0..3 (-1, 4, 7, 260).  Returns
    (arrays, the step's static arguments)."""
    rng = np.random.default_rng(seed)
    (est, elen, gen, glen, bands, donor, wpwm, ids, locus), denom = \
        example_batch(batch=batch, n_max=n_max, m_max=max_rows,
                      k_max=k_max, n_introns=n_introns, seed=seed)
    for b in range(batch):
        m = int(rng.integers(max_rows // 2, max_rows))
        gap = int(rng.integers(0, 2 * k_max)) if b % 3 else k_max
        n = min(m + gap, n_max)
        est[b, :m] = gen[b, :m]
        for _ in range(int(rng.integers(0, 2 * k_max))):
            est[b, rng.integers(0, m)] = rng.integers(0, 4)
        elen[b], glen[b] = m, n
    bands = rng.integers(1, k_max + 1, batch).astype(np.int32)
    ids = rng.integers(0, n_introns // 2, batch).astype(np.int32)
    donor[0, 0], donor[1, 3], donor[2, 5], donor[3, -1] = -1, 4, 7, 260
    arrays = (est, elen, gen, glen, bands, donor, wpwm, ids, locus)
    return arrays, dict(n_introns=n_introns, max_rows=max_rows,
                        k_max=k_max, denominator=denom)


def to_device(arrays, device):
    """The first eight arrays of an ``example_batch`` (everything but
    the locus) on ``device`` in the types the step's kernels take: int8
    codes, int32 lengths and bands, float32 weights, int64 intron ids.
    The donor codes are narrowed to int8 here, once, with every code
    outside 0..3 made -1 first, so that a wide code cannot wrap into
    0..3 (either way it scores as an all-zero column)."""
    device = check_card(device)
    (est_codes, est_lens, gen_codes, gen_lens, bands, donor_idx, wpwm,
     intron_ids) = arrays[:8]
    donor = np.asarray(donor_idx)
    donor = np.where((donor >= 0) & (donor < 4), donor, -1).astype(np.int8)
    typed = ((est_codes, np.int8), (est_lens, np.int32),
             (gen_codes, np.int8), (gen_lens, np.int32), (bands, np.int32),
             (donor, np.int8), (wpwm, np.float32), (intron_ids, np.int64))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(device)
                 for a, t in typed)
