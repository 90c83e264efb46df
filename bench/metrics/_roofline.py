"""The yardstick of the per-layer metrics: one H100's published peaks, the
least time attention's forward and backward can take, and a training
step's model FLOPs.

Frozen copies, with the corrections marked, of ``chip_smoke.py``'s
``H100_BF16_FLOPS`` and ``H100_BYTES_PER_S``, ``attention_bound_ms``,
``attention_bwd_bound_ms`` and ``model_flops``.
"""
from __future__ import annotations

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
BF16_BYTES = 2


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask leaves visible in one sequence."""
    return seq * (seq + 1) // 2


def attention_bound_s(b: int, s: int, h: int, hkv: int, hd: int, hd_v: int) -> float:
    """Least time of one causal forward call (bf16): 2 * (hd + hd_v)
    operations per visible (query, key) pair and query head at the bf16
    peak, or Q, K, V read once, O written once and both position arrays
    read.  From ``chip_smoke.py::attention_bound_ms``, corrected for
    hd_v < hd: it counted 4 * hd operations a pair and O and V at hd."""
    ops_s = 2.0 * (hd + hd_v) * causal_pairs(s) * b * h / H100_BF16_FLOPS
    nbytes = BF16_BYTES * b * s * (h * (hd + hd_v) + hkv * (hd + hd_v)) + 4 * 2 * s
    return max(ops_s, nbytes / H100_BYTES_PER_S)


def attention_bwd_bound_s(b: int, s: int, h: int, hkv: int, hd: int, hd_v: int) -> float:
    """Least time of one causal backward call (bf16): five products per
    visible pair and query head, each at its own width (S again, dK, dQ: 2 *
    hd; dP, dV: 2 * hd_v), or q, k, v, o, dO and the row log-sum-exp read once
    and dq, dk, dv written once.  ``chip_smoke.py::attention_bwd_bound_ms``,
    which counted K, V and their gradients at ``k.numel()``: the same here."""
    ops_s = 2.0 * (3 * hd + 2 * hd_v) * causal_pairs(s) * b * h / H100_BF16_FLOPS
    nbytes = (BF16_BYTES * (2 * b * s * h * hd + 2 * b * s * hkv * hd + 2 * b * s * hkv * hd_v
                            + 2 * b * s * h * hd_v) + 4 * b * h * s)
    return max(ops_s, nbytes / H100_BYTES_PER_S)


def model_flops(model, batch: int, seq: int) -> float:
    """Model FLOPs of one training step, no recomputation counted: 6 per
    weight a token multiplies and token (the reference's
    ``active_matmul_params``: a MoE's routed top-k and shared experts, not all
    of them; the head, not the embedding lookup), and attention's 2 * (qk +
    v width) per visible pair and head forward, three times that with its
    backward.  ``chip_smoke.py::model_flops`` counted every parameter (all
    experts, an untied embedding twice) and 4 * hd a pair."""
    att = model.attention()
    attn = 6.0 * (att["qk_dim"] + att["v_dim"]) * att["heads"] * causal_pairs(seq) * batch \
        * att["layers"]
    return 6.0 * model.active_matmul_params() * batch * seq + attn
