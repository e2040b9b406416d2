"""mamba2-2.7b — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]

SSM family: chunked SSD forward (intra-chunk on the MXU, inter-chunk state
scan), O(1)-state decode -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSM

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family=SSM,
    num_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    head_dim=0,
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    ssm_expand=2,
    tie_embeddings=True,
)
