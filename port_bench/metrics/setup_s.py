"""Seconds from the process's start to the first timed unit: imports, the
card's context, the kernels' libraries, weights and inputs from the seed,
the warm-up of every shape the cell runs."""


def read(rec):
    return rec["setup_s"]
