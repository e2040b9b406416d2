"""Seeded shapes for holding the SSD chunked scan (K5) against its plain
version: the card tests, ``chip_smoke.py`` and the CPU test of the bf16
kernel's rounding (tests/test_torch_ssd_scan.py) take their cases here.

A case is (b, s, h, p, g, n, chunk); ``inputs`` draws its x, dt, A, B and C
(float64 numpy) from ``np.random.default_rng(s + h)``, as tests/test_kernels.py
draws them: dt = |N(0,1)| * 0.1 + 0.01, A = -|N(0,1)| - 0.1. The large-decay
case takes dt = 2 everywhere and A from -4 to -0.5, so |dt*A| sums far past
88 inside a chunk: exp(cum_i - cum_j) above the diagonal would be inf in
f32.
"""
import numpy as np

CASES = [
    # tests/test_kernels.py:69-73
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 256, 8, 16, 1, 32, 64),
    # mamba2-2.7b at full width (H=80, P=64, N=128, G=1, chunk 256): one
    # serving bucket and S=1024
    (1, 256, 80, 64, 1, 128, 256),
    (1, 1024, 80, 64, 1, 128, 256),
    # edges of the bf16 route: groups of several heads (G=2 and 8 at H=16);
    # P not a multiple of its 64-column P tile (48; 80, whose second tile is
    # partial); N = 16, 64, 128; one chunk (S = Q); B=2; chunks 16 to 256
    (1, 256, 16, 64, 2, 64, 128),
    (1, 256, 16, 32, 8, 16, 64),
    (2, 128, 4, 48, 1, 64, 64),
    (1, 256, 2, 80, 1, 128, 256),
    (1, 128, 4, 64, 1, 128, 128),
    (2, 64, 4, 64, 2, 16, 16),
    (1, 512, 8, 64, 1, 64, 32),
]

# mamba2-2.7b at full width over two 256-step chunks, with decays that
# overflow above the diagonal
LARGE_DECAY = (1, 512, 80, 64, 1, 128, 256)


def inputs(b, s, h, p, g, n, chunk, large_decay=False):
    """x, dt, A, B, C of a case as float64 numpy arrays."""
    del chunk
    rng = np.random.default_rng(s + h)
    x = rng.normal(size=(b, s, h, p))
    dt = np.abs(rng.normal(size=(b, s, h))) * 0.1 + 0.01
    A = -np.abs(rng.normal(size=h)) - 0.1
    Bm = rng.normal(size=(b, s, g, n))
    Cm = rng.normal(size=(b, s, g, n))
    if large_decay:
        dt = np.full((b, s, h), 2.0)
        A = -np.linspace(0.5, 4.0, h)
    return x, dt, A, Bm, Cm
