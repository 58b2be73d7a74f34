"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub).
[arXiv:2212.04356; unverified]
32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
The conv/mel frontend is a STUB: input_specs() supplies precomputed frame
embeddings of shape (batch, source_positions, d_model).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,           # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    gated_mlp=False,         # whisper uses plain GELU fc1/fc2
    encdec=EncDecConfig(encoder_layers=32, source_positions=1500),
)
