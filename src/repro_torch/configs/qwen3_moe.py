"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4, head_dim=128, qk-norm)
128 experts top-8 expert d_ff=768, vocab 151936. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,  # informational; experts carry the FFN
    vocab=151936,
    norm="rmsnorm",
    mlp="swiglu",
    use_qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
)

SMOKE = ArchConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab=256,
    use_qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64),
)
