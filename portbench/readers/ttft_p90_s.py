"""90th percentile of first-token stamp - due time over all requests due in
the window (client clock)."""
from portbench.readers._common import percentile, ttfts_s


def read(run):
    return percentile(ttfts_s(run.served), 90)
