"""The card's energy counter (NVML) across the window over the tokens
delivered in it; None where the counter cannot be read."""
from portbench.readers._common import window_stamps


def read(run):
    n = len(window_stamps(run.served))
    if run.energy_j is None or n == 0:
        return None
    return run.energy_j / n
