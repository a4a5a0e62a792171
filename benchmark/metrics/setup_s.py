"""Set-up: process start to the first measured locus's start (imports,
the device service, CUDA, the kernels' build or load, the inputs, the
warm-up pass)."""


def read(ctx):
    return ctx["setup_s"]
