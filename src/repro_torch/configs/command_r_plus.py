"""command-r-plus-104b [dense]: 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, parallel attn+mlp block (cohere), no bias.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    norm="layernorm",
    mlp="swiglu",
    parallel_block=True,
    use_bias=False,
    rope_theta=75000000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="command-r-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab=256,
    norm="layernorm",
    mlp="swiglu",
    parallel_block=True,
    tie_embeddings=True,
)
