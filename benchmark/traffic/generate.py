"""The benchmark's one traffic generator.  A cell's traffic file
(``benchmark/workloads/<cell>.json``) names its generator and its
parameters; the configuration's file holds each locus's metadata.
Every seed makes the same work, in another order:

  * ``golden``: the upstream regression loci the traffic file lists,
    each with its frozen inputs and upstream outputs
    (``benchmark/data/<locus>.tar.gz``); ``order: "sweeps"`` runs them
    in sweeps, each sweep a permutation of the loci drawn from the
    seed.

``loci(config, traffic, seed, root)`` returns the distinct loci, each a
dict with ``name``, ``genomic`` and ``ests`` (bytes), ``n_ests``,
``gene``, ``organism`` and what the check needs (``gold``, the
unpacked upstream outputs, and ``finals``);
``schedule(traffic, loci, seed)`` yields the loci in the order they
run, without end.
"""

from __future__ import annotations

import os
import random
import tarfile

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def _golden(config, traffic, seed, root):
    out = []
    for name in traffic["loci"]:
        meta = config["loci"][name]
        gold = os.path.join(root, "gold", name)
        os.makedirs(gold, exist_ok=True)
        with tarfile.open(os.path.join(DATA, f"{name}.tar.gz")) as tf:
            tf.extractall(gold, filter="data")
        with open(os.path.join(gold, "genomic.txt"), "rb") as f:
            genomic = f.read()
        with open(os.path.join(gold, "ests.txt"), "rb") as f:
            ests = f.read()
        out.append({"name": name, "genomic": genomic, "ests": ests,
                    "n_ests": ests.count(b"\n>") + ests.startswith(b">"),
                    "gene": meta["gene"], "organism": config["organism"],
                    "gold": gold, "finals": meta["finals"]})
    return out


GENERATORS = {"golden": _golden}


def loci(config: dict, traffic: dict, seed: int, root: str) -> list:
    return GENERATORS[traffic["generator"]](config, traffic, seed, root)


def schedule(traffic: dict, items: list, seed: int):
    """The loci in the order they run: whole sweeps of seeded
    permutations."""
    if traffic["order"] != "sweeps":
        raise ValueError(f"unknown order {traffic['order']!r}")
    rng = random.Random(seed)
    while True:
        perm = list(items)
        rng.shuffle(perm)
        yield from perm


def sweep_length(traffic: dict, items: list) -> int:
    """How many loci make one sweep of the traffic: a window closes only
    after a whole one, so that every seed runs the same work."""
    return len(items)
