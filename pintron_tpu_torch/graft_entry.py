"""The port's entry point: the batched scoring step with an example
batch (counterpart of the JAX package's ``__graft_entry__.entry``).

    from pintron_tpu_torch.graft_entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    dist, scores, support = fn(*args)

``fn`` is ``parallel.mesh.alignment_step`` with its static arguments
bound at the JAX entry's sizes: a batch of 64 pairs, genomic windows of
256 codes, ``max_rows`` 192, ``k_max`` 16 (band width 33,
``kband_kernel``'s 2-cells-a-lane instance), 32 candidate introns and
the ``P5_GTAG_U2`` donor matrix.  ``example_args`` are its eight
tensors on ``device``.

The JAX module's ``dryrun_multichip`` (the AMBN pipeline over a device
mesh and over two processes) comes with the port's ``parallel/``
sharding (ROADMAP A3).
"""

from __future__ import annotations

import functools

from pintron_tpu_torch.parallel.mesh import (alignment_step, example_batch,
                                             to_device)

BATCH = 64
N_MAX = 256
MAX_ROWS = 192
K_MAX = 16
N_INTRONS = 32


def entry(device="cuda"):
    """Returns (fn, example_args); ``device="cuda"`` raises without a
    card."""
    arrays, denom = example_batch(batch=BATCH, n_max=N_MAX, m_max=MAX_ROWS,
                                  k_max=K_MAX, n_introns=N_INTRONS)
    example_args = to_device(arrays, device)
    fn = functools.partial(alignment_step, n_introns=N_INTRONS,
                           max_rows=MAX_ROWS, k_max=K_MAX, denominator=denom)
    return fn, example_args


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
