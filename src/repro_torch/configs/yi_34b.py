"""yi-34b — llama-arch dense GQA. [arXiv:2403.04652; hf]

56 query heads are not divisible by the 16-way model axis; projections stay
2-D (d_model, n_heads*head_dim) and shard on the flattened output dim
(7168 / 16 = 448). See DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="yi-34b",
    family=DENSE,
    num_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    head_dim=128,
    rope_theta=5_000_000.0,
)
