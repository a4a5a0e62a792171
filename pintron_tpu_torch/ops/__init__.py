"""Device ops of the PyTorch/CUDA port: plain PyTorch versions
(``align``, ``pwm``), the hand-written CUDA kernels' wrappers
(``kband``, ``traceback``, ``pwm``) and the offload (``offload``).
Nothing heavy is imported here; the kernels are built at first use."""
