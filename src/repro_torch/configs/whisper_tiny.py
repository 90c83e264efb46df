"""whisper-tiny [audio]: 4L enc + 4L dec, d=384 6H d_ff=1536 vocab=51865,
enc-dec with conv frontend STUB (input_specs supplies precomputed frame
embeddings).  [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,  # decoder layers
    enc_layers=4,
    enc_seq=1500,  # 30 s of audio at 50 Hz after the (stubbed) conv frontend
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    mlp="gelu",
    use_bias=True,
    input_mode="embeddings",
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="encdec",
    num_layers=2,
    enc_layers=2,
    enc_seq=32,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab=256,
    norm="layernorm",
    mlp="gelu",
    use_bias=True,
    input_mode="embeddings",
)
