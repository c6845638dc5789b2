"""Seconds from the process's start to the measured window: imports, CUDA
start-up, inputs, the program's set-up and the warm-up of every shape the
cell's traffic uses (and, in a checkout's first run, the kernel build)."""


def read(ctx):
    return ctx.setup_s
