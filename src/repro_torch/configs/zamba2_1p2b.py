"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000
ssm_state=64.  Sub-quadratic -> eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,               # MLP of the shared attention block
    vocab_size=32000,
    ssm=SSMConfig(state_size=64, conv_kernel=4, head_dim=64, expand=2,
                  chunk_size=256, attn_every=6),
    subquadratic=True,       # attention blocks use sliding window at long ctx
)
