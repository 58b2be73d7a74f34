"""codeqwen1.5-7b [dense] — qwen1.5 arch.  [hf:Qwen/CodeQwen1.5-7B; hf]
32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
)
