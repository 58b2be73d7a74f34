"""xlstm-350m [ssm] — sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]
24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.
Sub-quadratic (recurrent) -> eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,                  # projections live inside the xLSTM blocks
    vocab_size=50304,
    # xLSTM[7:1]-style: one sLSTM block per 8 layers, rest mLSTM
    ssm=SSMConfig(state_size=256, conv_kernel=4, head_dim=256, expand=2,
                  chunk_size=256, slstm_layers=(3, 11, 19)),
    subquadratic=True,
)
