"""Fixed host seconds for the paper functions' real bodies.

``ExecutionModel.measure_real`` times each real body once on the host's
wall clock, so a run's simulated times follow the host's load. The twins of
``examples/serve_fdn.py`` and ``examples/energy_aware_scheduling.py`` are
held against the examples, and against themselves under each decision
backend, with ``measure_real`` replaced by ``pinned_measure_real`` in every
package that runs: then equal decisions give equal bytes. No JAX here:
``chip_smoke.py`` imports this module on the card's machine."""

PINNED_S = {"nodeinfo": 2e-5, "primes-python": 0.05,
            "image-processing": 0.004, "sentiment-analysis": 0.01,
            "JSON-loads": 0.004}


def pinned_measure_real(self, fn, payloads):
    """``ExecutionModel.measure_real`` with ``PINNED_S`` in place of the
    measurement: None for an analytic function, as the original."""
    return None if fn.real_fn is None else PINNED_S[fn.name]
