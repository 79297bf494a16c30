"""The run's whole set-up, from the process's start to the window's:
imports and CUDA (and, in a checkout's first run, the kernels' build),
weights, base image, publishing, warm-up."""


def read(run):
    return run["setup_s"]
