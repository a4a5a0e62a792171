"""A synthetic spliced locus: a random genomic sequence and ESTs cut
from it as 1 to 6 exons with point mutations, some reverse-complemented,
some with a poly-A tail.  A copy of ``make_case`` of the JAX package's
``tools/scale_stress.py``: for the same arguments it writes the same
``genomic.txt`` and ``ests.txt``, byte for byte.  The device fuzz
(``pintron_tpu_torch.fuzz_device``) and the bench's stress channel
(``pintron_tpu_torch.bench``) make their loci with it."""

import os
import random


def make_case(tmpdir, glen, n_ests, seed):
    """Write ``genomic.txt`` (``glen`` bases) and ``ests.txt``
    (``n_ests`` ESTs) into ``tmpdir``; returns the number of ESTs."""
    rng = random.Random(seed)
    gen = "".join(rng.choice("ACGT") for _ in range(glen))
    with open(os.path.join(tmpdir, "genomic.txt"), "w") as f:
        f.write(f">chr5:{50_000}:{50_000 + glen - 1}:+1\n{gen}\n")

    def rc(s):
        comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
        return "".join(comp.get(c, c) for c in reversed(s))

    with open(os.path.join(tmpdir, "ests.txt"), "w") as f:
        made = 0
        while made < n_ests:
            n_exons = rng.randrange(1, 7)
            pos = rng.randrange(0, glen - 2000)
            parts = []
            for _ in range(n_exons):
                elen = rng.randrange(40, 400)
                if pos + elen >= glen:
                    break
                parts.append(gen[pos:pos + elen])
                pos += elen + rng.randrange(50, 2000)
                if pos >= glen:
                    break
            if not parts:
                continue
            seq = "".join(parts)
            s = list(seq)
            for _ in range(rng.randrange(0, 6)):
                s[rng.randrange(len(s))] = rng.choice("ACGT")
            seq = "".join(s)
            if rng.random() < 0.3:
                seq = rc(seq)
            if rng.random() < 0.3:
                seq += "A" * rng.randrange(8, 35)
            f.write(f">gi|S{seed}E{made}| /gb=S{seed}E{made}\n{seq}\n")
            made += 1
    return made
