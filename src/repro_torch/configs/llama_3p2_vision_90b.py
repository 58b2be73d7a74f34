"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256.
The vision frontend is a STUB: input_specs() supplies precomputed patch
embeddings of shape (batch, vision_tokens, vision_dim).
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    vlm=VLMConfig(cross_attn_every=5, vision_tokens=1601, vision_dim=8192),
    remat="full",
)
