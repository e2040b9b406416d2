"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The modality frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings (n_img_tokens, d_model) which are
concatenated ahead of the text tokens. kv=32 == n_heads -> plain MHA.
"""
from repro_torch.configs.base import ModelConfig, VLM

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family=VLM,
    num_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    head_dim=96,
    n_img_tokens=576,       # one 336px CLIP tile -> 24x24 patches
    rope_theta=10_000.0,
)
