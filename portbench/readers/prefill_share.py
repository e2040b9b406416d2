"""Share of the traced window that the host spends inside the program's
``engine.prefill`` ranges (admission's prefills): ``.latency`` and
``.itl_mean`` in the latency cells, ``.offline`` in the saturated one."""
from portbench.readers._common import share


def read(run):
    tr = run.trace
    return None if tr is None else share(tr.host_s("engine.prefill"),
                                         tr.window_s())
