"""Model flops of the traced window's prefills at their real prompt lengths
(active experts only) over the summed device extent of the program's
``engine.prefill`` ranges, as a share of the card's bf16 peak."""
from portbench.flops import PEAK_BF16_FLOPS
from portbench.readers._common import prefill_flops, share


def read(run):
    tr = run.trace
    if tr is None:
        return None
    f = prefill_flops(run)
    t = tr.device_extent_s("engine.prefill")
    return share(f / PEAK_BF16_FLOPS, t) if f else None
