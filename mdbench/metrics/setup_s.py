"""Seconds from the start of the process to the start of the window:
imports, the card's start, the kernels' build (first run of a checkout),
the weights, the port's table and the warm-up call."""


def read(run):
    return run.setup_s
