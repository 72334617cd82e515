"""Seconds from the process's start to the window's: CUDA's start, the kernel library, the
inputs, the program's packing and the warm-up chunks."""


def read(run):
    return run.setup_s
