"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152,
GQA + RoPE, layernorm + gelu MLP w/ bias.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    norm="layernorm",
    mlp="gelu",
    use_bias=True,
    rope_theta=100000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="starcoder2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab=256,
    norm="layernorm",
    mlp="gelu",
    use_bias=True,
    tie_embeddings=True,
)
