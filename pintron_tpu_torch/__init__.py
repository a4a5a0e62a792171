"""pintron-tpu-torch: the PyTorch/CUDA port of pintron-tpu.

A second package beside ``pintron_tpu``, which stays the reference.  The
port owns the device code: plain PyTorch versions of the device ops,
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``), the offload
that feeds them, the device flows of est-fact (STEP 2) and intron
agreement (STEP 4), the GPU-owning device service and the multi-locus
batch driver that shares it.  The host
code (native C runtime, suffix tree, MEG construction, the other
stages) is imported from ``pintron_tpu`` unchanged.  This package
imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from pintron_tpu.config import Config

__all__ = ["Config", "__version__"]
