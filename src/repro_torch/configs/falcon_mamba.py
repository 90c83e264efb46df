"""falcon-mamba-7b [ssm]: 64L d=4096 attn-free mamba1, d_inner=8192,
ssm_state=16, vocab=65024.  Pure SSM -> long_500k runs (O(1) decode state).
[arXiv:2410.05355]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab=65024,
    norm="rmsnorm",
    ssm=SSMConfig(d_inner=8192, state=16, conv_width=4, dt_rank=256),
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="falcon-mamba-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab=256,
    ssm=SSMConfig(d_inner=128, state=8, conv_width=4, dt_rank=8),
    sub_quadratic=True,
)
