"""Seconds from the process's start to the window's opening: loading,
weights, engine, kernel builds, the warm-up and the traffic's ramp."""


def read(run):
    return run.setup_s
