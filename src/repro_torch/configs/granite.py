"""granite-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152,
llama-arch (rmsnorm + swiglu), code model.  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="granite-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab=256,
)
