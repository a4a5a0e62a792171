"""The batched scoring step on one device and sharded over a device
mesh (``mesh``), and STEP 2 over several processes joined by
``torch.distributed`` (``multihost``)."""

from pintron_tpu_torch.parallel.mesh import (alignment_step, make_mesh,
                                             sharded_alignment_step)

__all__ = ["alignment_step", "make_mesh", "sharded_alignment_step"]
