"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]  61L d_model=7168 128H (GQA kv=128) expert d_ff=2048
vocab=129280.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,            # v head dim; qk dims come from MLA
    d_ff=0,                  # all FFNs are MoE (after first_k_dense)
    vocab_size=129280,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=256, num_shared_experts=1, top_k=8,
                  d_ff=2048, first_k_dense=3, dense_d_ff=18432),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
    remat="full",
)
