"""dbrx-132b — fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]

16 experts divide the 16-way model axis exactly -> clean expert parallelism.
"""
from repro_torch.configs.base import ModelConfig, MOE

CONFIG = ModelConfig(
    name="dbrx-132b",
    family=MOE,
    num_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100_352,
    head_dim=128,
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    param_fsdp=True,      # 264 GB bf16 / 16-way TP is borderline for HBM
)
