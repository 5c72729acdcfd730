"""Seconds from the process's start to the first timed call: imports,
building the model, weights and inputs, the first steps or warm-up calls,
and any kernel build they need (host clock)."""


def read(run):
    return run.setup_s
