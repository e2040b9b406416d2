"""recurrentgemma-9b — RG-LRU + local attention, 2 recurrent : 1 attention.
[arXiv:2402.19427; unverified]

Hybrid family: O(1)-state decode (RG-LRU state + window-2048 local cache),
so the long_500k shape runs. The RG-LRU recurrence is computed with
jax.lax.associative_scan (TPU-native parallel scan) rather than a CUDA-style
sequential kernel — see DESIGN.md hardware-adaptation notes.
"""
from repro_torch.configs.base import ModelConfig, HYBRID

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family=HYBRID,
    num_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,           # MQA in the local-attention blocks
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv_width=4,
    local_window=2048,
    tie_embeddings=True,
)
