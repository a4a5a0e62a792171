"""pintron-tpu-torch: the PyTorch/CUDA port of pintron-tpu.

A second package beside ``pintron_tpu``, which stays the reference, and
independent of it: the port carries its own copy of the host pipeline
(native C runtime, suffix tree, MEG construction, the filter cascade,
STEPs 1-8, the regression comparison) and owns the device code: plain
PyTorch versions of the device ops, hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``), the offload that feeds them, the device
flows of est-fact (STEP 2) and intron agreement (STEP 4), the
GPU-owning device service and the multi-locus batch driver that shares
it.  This package never imports ``jax`` nor anything of
``pintron_tpu``.  Its entry points run on the card (``device="cuda"``)
unless the caller asks for ``"cpu"`` (the plain ops) or ``"host"`` (the
native host path with no device batch).

``torch`` loads where a batch runs in the process or a profiler
records: the device service, the in-process device path (its
``offload.check_card``, its first batch), ``PINTRON_TORCH_PROFILE``,
the batch driver's own process (its card check), the kernel wrappers
(``ops/{align,kband,traceback,pwm}.py``), ``parallel/`` and the
measuring tools.  A service client (``PINTRON_TORCH_SERVICE`` set,
as in every job of ``batch.py``) runs STEPs 1-8 without it, and so
does ``device="host"``: the pipeline, the stages, ``ops/offload.py``
and ``runtime/timing.py`` import none of it.
"""

import time as _time

# the package's import starts here: a process's start-up span
# (``runtime/timing.py``, ``pintron_startup``) times the package from
# this line, and starts here where the OS gives no start
IMPORT_START = _time.monotonic()

__version__ = "0.2.0"

from pintron_tpu_torch.config import Config

__all__ = ["Config", "__version__"]
