"""Device ops of the PyTorch/CUDA port: plain PyTorch versions
(``align``), the hand-written CUDA kernels' wrappers (``kband``) and the
K-band offload (``offload``).  Nothing heavy is imported here; the
kernels are built at first use."""
