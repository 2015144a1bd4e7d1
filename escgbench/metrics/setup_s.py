"""Seconds from the process's start to the window's first timed chunk:
imports, CUDA start, the kernels' libraries (nvcc on a checkout's first
run), the warm-up study, the lattices from the seed and the lead chunk."""


def read(ctx):
    return ctx.setup_s
