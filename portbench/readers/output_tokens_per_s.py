"""Every token delivered in the window over the window's seconds (from
step return to step return)."""
from portbench.readers._common import window_tokens_per_s


def read(run):
    return window_tokens_per_s(run.served)
