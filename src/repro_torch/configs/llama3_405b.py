"""llama3-405b — dense GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="llama3-405b",
    family=DENSE,
    num_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    # TP-only param shards (810 GB / 16 = 50 GB) overflow a v5e's 16 GB HBM:
    # FSDP-shard params over the data axes and recompute activations fully.
    param_fsdp=True,
    remat="full",
)
