"""Seeded shapes for holding split-K decode attention (K4) against its plain
version, the JAX package's Pallas kernel and its oracle: the CPU tests, the
card tests and ``chip_smoke.py`` take their cases here.

A case is (b, t, h, kh, d, splits, kv_block, lengths), where ``lengths`` is
None for random draws in [1, t].
"""
CASES = {
    # tests/test_kernels.py:52-57
    "gqa": (2, 256, 8, 4, 64, 4, 64, None),
    "mqa": (3, 512, 4, 1, 32, 8, 64, None),
    "one_split": (1, 128, 2, 2, 64, 1, 64, None),
    # lengths 0, 1, T, split_len and split_len + 1 (split_len = 128)
    "edges": (5, 512, 8, 2, 64, 4, 64, [0, 1, 512, 128, 129]),
    # the serving cache capacity (context 1024 + 128): splits become 3
    "serving_t": (2, 1152, 4, 2, 32, 4, 128, [1152, 385]),
    # T not a multiple of the kernel's 32-key tile: splits become 1
    "short_t": (2, 100, 4, 2, 32, 4, 128, [0, 100]),
    # groups of more than 8 query heads, which take the tensor-core route
    # in bf16: G=12 at D=128, a 16-row tile with 4 rows empty; G=16 at D=64
    # and at D=256 (with a row of length 0); G=24, rows not a multiple of
    # the 16-row tile, at D=32; G=64 at D=128, in two blocks of 32 rows;
    # G=48 at D=256, in three blocks of 16
    "g12": (2, 256, 24, 2, 128, 4, 64, [256, 77]),
    "g16": (2, 256, 32, 2, 64, 4, 64, None),
    "g16_d256": (2, 384, 16, 1, 256, 3, 128, [0, 300]),
    "g24": (1, 256, 48, 2, 32, 4, 64, [200]),
    "g64": (1, 128, 64, 1, 128, 2, 64, [128]),
    "g48_d256": (1, 128, 48, 1, 256, 1, 128, [100]),
}

# The serving caches at context 1024 (T = 1024 + 128), bf16, as
# (B, T, H, KH, D): qwen3-0.6b's, and recurrentgemma-9b's local attention
SERVING = {"d128": (4, 1152, 16, 8, 128), "d256": (4, 1152, 16, 1, 256)}
# ragged lengths for checking the kernel at each serving shape
SERVING_LENGTHS = {"d128": [64, 300, 700, 1152], "d256": [0, 1, 1000, 1152]}


def serving_case(name):
    """A serving shape as a case, under the reference's default split."""
    return (*SERVING[name], 4, 128, SERVING_LENGTHS[name])
