"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (MHA kv=32) d_ff=8192 vocab=32064,
phi3-mini backbone + CLIP frontend STUB (input_specs supplies precomputed
patch/text embeddings for training; decode embeds generated tokens).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
    input_mode="embeddings",
)

SMOKE = ArchConfig(
    name="phi3v-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab=256,
    input_mode="embeddings",
)
