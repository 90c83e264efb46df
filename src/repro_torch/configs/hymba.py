"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attention + mamba heads, ssm_state=16.  Long mode: SSM heads carry
global state, attention heads use a 2048 sliding window -> sub-quadratic,
so the long_500k cell runs.  [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    norm="rmsnorm",
    mlp="swiglu",
    ssm=SSMConfig(d_inner=3200, state=16, conv_width=4, dt_rank=100),
    long_window=2048,
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="hymba-smoke",
    family="hybrid",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab=256,
    ssm=SSMConfig(d_inner=128, state=8, conv_width=4, dt_rank=8),
    long_window=32,
    sub_quadratic=True,
)
