"""Seconds from the start of the process to the start of the window:
imports, weights, the pool of pairs, kernel loads and builds, the warm-up
and the CUDA graph's capture."""


def read(run):
    return run.setup_s
