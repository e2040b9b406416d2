"""Operation and byte counts against hand counts at small shapes, and the
trace's arithmetic (union of intervals, device extents, idle gaps)."""
import pytest

from portbench import flops
from portbench.trace import Trace

DENSE = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
         "head_dim": 4, "intermediate_size": 16, "num_hidden_layers": 3,
         "vocab_size": 10, "model_type": "qwen3", "tie_word_embeddings": True}
MOE = dict(DENSE, model_type="mixtral", num_local_experts=4,
           num_experts_per_tok=2, tie_word_embeddings=False)


def test_causal_pairs():
    assert flops.causal_pairs(4) == 1 + 2 + 3 + 4
    assert flops.causal_pairs(5, window=2) == 1 + 2 + 2 + 2 + 2
    assert flops.causal_pairs(3, window=8) == 6


def test_dense_counts_by_hand():
    # q 8x8, k/v 8x4 each, o 8x8; mlp 3 x 8x16
    per_token = 2 * (64 + 32 + 32 + 64 + 3 * 128)
    assert flops.matmul_flops_per_token(DENSE) == per_token
    assert flops.head_flops(DENSE) == 2 * 8 * 10
    attn = 4 * 4 * 2 * flops.causal_pairs(5)
    assert flops.prefill_flops(DENSE, 5) == 3 * (5 * per_token + attn) \
        + 2 * 8 * 10
    # two rows with 7 and 3 live keys
    assert flops.decode_flops(DENSE, [7, 3]) == \
        2 * (3 * per_token + 160) + 3 * 4 * 4 * 2 * 10


def test_moe_counts_only_the_experts_routed_to():
    per_token = 2 * (64 + 32 + 32 + 64 + 8 * 4 + 2 * 3 * 128)
    assert flops.matmul_flops_per_token(MOE) == per_token


def test_attention_bound_by_ops_and_by_bytes():
    b, s, h, kh, d = 1, 4096, 16, 8, 128
    want_ops = 4 * d * h * flops.causal_pairs(s) / flops.PEAK_BF16_FLOPS
    assert flops.attention_bound_s(b, s, h, kh, d) == pytest.approx(want_ops)
    # one query row: bytes bound it
    nbytes = 2 * (2 * 1 * h * d + 2 * 1 * kh * d)
    assert flops.attention_bound_s(1, 1, h, kh, d) == pytest.approx(
        nbytes / flops.PEAK_BYTES)


def trace():
    host = {"harness.loop": [(0, 100)], "engine.prefill": [(10, 30)],
            "engine.decode_step": [(40, 90)]}
    ops = [("flash_fwd_wgmma<128>", 20, 35, 1), ("gemm", 30, 45, 2),
           ("gemm", 50, 60, 3), ("attend", 55, 70, 4),
           ("late", 95, 120, 5)]
    launch = {1: 12, 2: 25, 3: 41, 4: 60, 5: 92}
    return Trace((0, 100), host, ops, launch)


def test_busy_is_the_union_within_the_window():
    tr = trace()
    # [20,45] + [50,70] + [95,100]
    assert tr.busy_s() == pytest.approx(50 / 1e9)
    assert tr.window_s() == pytest.approx(100 / 1e9)


def test_device_extent_of_a_range():
    tr = trace()
    assert tr.device_extent_s("engine.prefill") == pytest.approx(25 / 1e9)
    assert tr.device_extent_s("engine.decode_step") == pytest.approx(
        20 / 1e9)
    assert tr.op_seconds("flash_fwd") == pytest.approx(15 / 1e9)


def test_idle_gaps_labelled_by_the_host_range():
    gaps = trace().idle_gaps()
    # [0,20) under the loop, [45,50) and [70,95) inside the decode step
    assert gaps == [["engine.decode_step", pytest.approx(25 / 1e9)],
                    ["harness.loop", pytest.approx(20 / 1e9)],
                    ["engine.decode_step", pytest.approx(5 / 1e9)]]
