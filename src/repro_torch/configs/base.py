"""ArchConfig: one dataclass describes every architecture of the JAX package.

A copy of ``repro/configs/base.py``'s dataclasses.  The port builds only the
dense family so far (``models/model.py``); the MoE, MLA and SSM configs are
here as the field types of ``ArchConfig``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared: int = 0
    shared_d_ff: int = 0
    first_dense_layers: int = 0
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    state: int = 16
    conv_width: int = 4
    dt_rank: int = 0  # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | mla_moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    parallel_block: bool = False  # command-r style parallel attn+mlp
    use_qk_norm: bool = False  # qwen3-style per-head q/k RMSNorm
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # enc-dec only
    enc_layers: int = 0
    enc_seq: int = 1500  # stub-frontend frame count for train shape
    # inputs: 'tokens' or 'embeddings' (audio/vlm stub frontends)
    input_mode: str = "tokens"
    # long-context support: 0 = full attention only;
    # >0 = sliding-window size used by attention in long mode
    long_window: int = 0
    sub_quadratic: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads it (its
        embedding table and logits shard over a model axis)."""
        return -(-self.vocab // 256) * 256
