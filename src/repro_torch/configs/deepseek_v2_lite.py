"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H MLA(kv_lora=512) MoE 64e top-6
2 shared, expert d_ff=1408, first layer dense d_ff=10944, vocab 102400.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="mla_moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,  # used only by the first dense layer
    vocab=102400,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_d_ff=1408,
        num_shared=2,
        shared_d_ff=2816,  # 2 shared experts x 1408
        first_dense_layers=1,
        first_dense_d_ff=10944,
    ),
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-smoke",
    family="mla_moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab=256,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32, num_shared=2, shared_d_ff=64,
                  first_dense_layers=1, first_dense_d_ff=128),
)
