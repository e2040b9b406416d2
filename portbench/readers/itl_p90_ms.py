"""90th percentile of every gap between consecutive tokens of a request,
the later token delivered in the window (client clock). The gaps of one
step are equal, so the window's ~300-400 steps are its independent
samples: the 90th percentile has some thirty beyond it, the 99th three."""
from portbench.readers._common import gaps_s, percentile


def read(run):
    p = percentile(gaps_s(run.served), 90)
    return None if p is None else p * 1e3
