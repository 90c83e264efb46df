"""The benchmark's FLOP and byte counts against shapes worked out by hand."""
from __future__ import annotations

import math

import pytest
from smoke_cell import file_cell as load_cell
from metrics._roofline import (H100_BF16_FLOPS, H100_BYTES_PER_S, attention_bound_s,
                               attention_bwd_bound_s, causal_pairs, model_flops)


def _model(cell_name: str, **over):
    cell = load_cell(cell_name)
    return cell.reference.Model({**cell.config, **over})


def test_deepseek_active_parameters_at_one_dense_and_four_moe_layers():
    # a layer's MLA: wq 2048*16*192, w_dkv 2048*576, w_uk 512*16*128, w_uv 512*16*128,
    # wo 16*128*2048; the dense MLP 3*2048*10944; an MoE layer: router 2048*64, six
    # routed experts and two shared of 3*2048*1408 each; the untied head 102400*2048
    mla = 6_291_456 + 1_179_648 + 1_048_576 + 1_048_576 + 4_194_304
    dense = mla + 67_239_936
    moe = mla + 131_072 + 8 * 8_650_752
    head = 209_715_200
    m = _model("deepseek-v2-lite-16b.train_4k", num_hidden_layers=5)
    assert m.active_matmul_params() == dense + 4 * moe + head
    assert round(m.active_matmul_params() / 1e6) == 623


def test_starcoder2_active_parameters_are_every_product_and_the_tied_head():
    m = _model("starcoder2-3b.train_4k")
    per_layer = 2 * 3072 * 3072 + 2 * 3072 * 256 + 2 * 3072 * 12288
    assert m.active_matmul_params() == 17 * per_layer + 49152 * 3072
    table = m.param_table()
    total = sum(math.prod(leaf.shape) for leaf in table.values())
    biases_and_norms = total - m.active_matmul_params()
    assert 0 < biases_and_norms < 1e-3 * total  # only biases and norm scales are left


@pytest.mark.parametrize("cell_name, layers, qk, v, heads", [
    ("starcoder2-3b.train_4k", 17, 128, 128, 24),
    ("deepseek-v2-lite-16b.train_4k", 2, 192, 128, 16),
    ("deepseek-v2-lite-16b.train_16k", 2, 192, 128, 16)])
def test_model_flops_is_six_per_product_weight_and_attention_pairs(cell_name, layers, qk, v,
                                                                   heads):
    cell = load_cell(cell_name)
    m = cell.reference.Model(cell.config)
    b, s = cell.traffic["batch"], cell.traffic["seq"]
    attention = 6 * (qk + v) * heads * (s * (s + 1) // 2) * b * layers
    assert model_flops(m, b, s) == 6 * m.active_matmul_params() * b * s + attention


def test_attention_bounds_at_the_kernel_tables_shapes():
    # starcoder2's microbatch: 4 x 4096, 24 heads over 2, hd 128: operations bound
    fwd = attention_bound_s(4, 4096, 24, 2, 128, 128)
    assert fwd == pytest.approx(4 * 128 * causal_pairs(4096) * 4 * 24 / H100_BF16_FLOPS)
    assert fwd * 1e3 == pytest.approx(0.4170, abs=5e-5)
    assert attention_bwd_bound_s(4, 4096, 24, 2, 128, 128) * 1e3 == pytest.approx(1.0425, abs=5e-5)
    # MLA at hd 192 / hd_v 128: the backward as chip_smoke counted it (0.2259 ms at B 1);
    # the forward's products at 2 * (192 + 128) a pair, not 4 * 192
    assert attention_bwd_bound_s(1, 4096, 16, 16, 192, 128) * 1e3 == pytest.approx(0.2259,
                                                                                  abs=5e-5)
    assert attention_bound_s(1, 4096, 16, 16, 192, 128) == pytest.approx(
        2 * 320 * causal_pairs(4096) * 16 / H100_BF16_FLOPS)


def test_attention_bound_is_bytes_where_the_sequence_is_short():
    # one query row a head: Q, O, K, V and the positions moved once
    b, s, h, hkv, hd = 1, 1, 8, 8, 64
    nbytes = 2 * (h * 2 * hd + hkv * 2 * hd) + 8
    assert attention_bound_s(b, s, h, hkv, hd, hd) == pytest.approx(nbytes / H100_BYTES_PER_S)
