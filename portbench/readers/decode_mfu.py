"""Model flops of the traced window's decode steps (active rows, live keys;
active experts only) over the summed device extent of the program's
``engine.decode_step`` ranges, as a share of the card's bf16 peak."""
from portbench.flops import PEAK_BF16_FLOPS
from portbench.readers._common import decode_flops, share


def read(run):
    tr = run.trace
    if tr is None:
        return None
    f = decode_flops(run)
    t = tr.device_extent_s("engine.decode_step")
    return share(f / PEAK_BF16_FLOPS, t) if f else None
