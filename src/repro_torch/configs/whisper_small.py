"""whisper-small — encoder/decoder, conv frontend (stub).
[arXiv:2212.04356; unverified]

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (n_enc_frames, d_model). Decode shapes use the
decoder's self-attention KV cache at the stated sequence length plus the
fixed-length cross-attention cache.
"""
from repro_torch.configs.base import ModelConfig, ENCDEC

CONFIG = ModelConfig(
    name="whisper-small",
    family=ENCDEC,
    num_layers=12,            # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    head_dim=64,
    n_enc_layers=12,
    n_enc_frames=1500,
    causal=True,
    rope_theta=10_000.0,      # (whisper uses learned abs pos; rope unused in enc)
)
