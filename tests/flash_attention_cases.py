"""Seeded shapes for holding flash attention (K3) against its plain version on
the card: the card tests and chip_smoke.py take them, and the CPU test of the
bf16 kernel's rounding (tests/test_torch_flash_attention.py) replays them. A
case is (b, s, t, h, kh, d, causal, window): q of s positions and k/v of t
keys; the values are ``np.random.default_rng(s).normal(size=shape) * 0.3``
for q, k and v in turn.
"""
import numpy as np

CARD_CASES = [
    # tests/test_kernels.py's shapes and windows, at B=1 and 2, + ragged S
    (1, 128, 128, 4, 4, 32, True, None),
    (1, 256, 256, 8, 2, 64, True, None),
    (2, 256, 256, 8, 2, 64, True, None),
    (1, 64, 64, 4, 1, 32, True, None),
    (1, 256, 256, 4, 2, 32, True, 96),
    (2, 256, 256, 4, 2, 32, True, 32),
    (2, 256, 256, 4, 2, 32, True, 96),
    (2, 256, 256, 4, 2, 32, True, 1024),
    (1, 128, 128, 4, 4, 32, False, None),
    (1, 100, 100, 4, 2, 32, True, None),
    (1, 100, 100, 4, 2, 32, True, 40),
    (1, 1024, 1024, 16, 8, 128, True, None),     # qwen3-0.6b
    (1, 128, 128, 16, 1, 256, True, 2048),       # the hybrid's local attention
    (1, 1024, 1024, 16, 1, 256, True, 2048),
    (1, 4096, 4096, 16, 1, 256, True, 2048),     # the window masks
    # edges of the tensor-core kernel: the batch edge of its 4-D TMA view of
    # k/v at a T no tile divides; qwen3's smallest prefill bucket; a ragged
    # S at head_dim 256; no causal mask at head_dim 128
    (2, 100, 100, 4, 2, 128, True, None),
    (1, 16, 16, 16, 8, 128, True, None),
    (1, 1000, 1000, 16, 1, 256, True, 2048),
    (1, 300, 300, 16, 8, 128, False, None),
    # groups that do not divide its 64-row q tile (G=3, 15), so the tile's
    # last rows hold no (position, head); one position a tile (G=64); one
    # position in all; fewer and more queries than keys
    (1, 200, 200, 12, 4, 128, True, None),
    (2, 150, 150, 15, 1, 64, True, 64),
    (1, 40, 40, 64, 1, 32, True, None),
    (1, 1, 1, 16, 8, 128, True, None),
    (1, 1, 1, 16, 1, 256, True, 2048),
    (1, 100, 300, 16, 8, 128, False, None),
    (1, 300, 100, 8, 2, 128, True, None),
    # head_dim 96, three 32-column chunks a row: phi-3-vision's prefill (H =
    # KH = 32, S = 576 image + 448 text positions); a ragged S; B=2 at a T
    # no tile divides; groups of 4; fewer keys than queries without the
    # causal mask
    (1, 1024, 1024, 32, 32, 96, True, None),
    (1, 200, 200, 32, 32, 96, True, None),
    (2, 100, 100, 8, 8, 96, True, None),
    (1, 256, 256, 16, 4, 96, True, None),
    (1, 300, 100, 8, 2, 96, False, None),
    # mixtral-8x7b's grouping (H=32, KH=8, D=128) under a window that masks
    (1, 1024, 1024, 32, 8, 128, True, 256),
]


def card_inputs(b, s, t, h, kh, d):
    """The numpy draws of a case's q, k and v (float64)."""
    rng = np.random.default_rng(s)
    return [rng.normal(size=shape) * 0.3
            for shape in [(b, s, h, d), (b, t, kh, d), (b, t, kh, d)]]
