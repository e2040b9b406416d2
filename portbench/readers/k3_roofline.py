"""K3 (the prefill flash attention kernel, ``csrc/flash_attention.cu``):
the least time of the traced prefills' attention at their real prompt
lengths, every layer, over K3's device time by kernel name."""
from portbench import flops
from portbench.readers._common import share
from portbench.trace import K3
from portbench.weights import dims


def read(run):
    tr = run.trace
    if tr is None:
        return None
    m = dims(run.config)
    window = run.config.get("window") or run.config.get("sliding_window")
    least = sum(m["L"] * flops.attention_bound_s(1, n, m["H"], m["KH"],
                                                 m["D"], window)
                for s in run.traced_steps for n in s.prefills)
    t = tr.op_seconds(K3)
    return share(least, t) if least and t else None
