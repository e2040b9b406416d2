"""Mean of every gap between consecutive tokens of a request, the later
token delivered in the window (client clock): the window's decode time
per token, each step's prefills spread over the tokens it delivered. It
stands where a percentile of the gaps falls between the modes of steps
that admit prompts of different buckets and swings with the seed."""
from portbench.readers._common import gaps_s


def read(run):
    g = gaps_s(run.served)
    return 1e3 * sum(g) / len(g) if g else None
