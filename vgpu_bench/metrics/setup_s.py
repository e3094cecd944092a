"""Seconds from the supervisor's start until the first window opens: the
build, every tenant's start, weights, inputs and warm-up, and the
barriers."""


def read(run):
    return run.setup_s
