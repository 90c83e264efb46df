"""The plain reference against the port on the SMOKE presets, on the CPU:
with the port's compute dtype set to float32 both compute the same
mathematics, so three AdamW steps of two microbatches agree to float32
rounding, leaf by leaf."""
from __future__ import annotations

import numpy as np
import pytest
import smoke_cell
import torch
from inputs import make_weights

CELLS = ["starcoder2-3b.train_4k", "deepseek-v2-lite-16b.train_4k"]


@pytest.fixture(autouse=True)
def _one_thread():
    old = smoke_cell.one_thread()
    yield
    torch.set_num_threads(old)


@pytest.fixture
def f32_port():
    from repro_torch.models import layers

    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    yield
    layers.COMPUTE_DTYPE = old


def _batches(vocab: int, steps: int, rows: int, seq: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, vocab, (steps, rows, seq + 1), generator=gen)
    return [(t[:, :-1], t[:, 1:]) for t in toks]


@pytest.mark.parametrize("cell_name", CELLS)
def test_parameter_tables_equal_the_ports(cell_name):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build

    cell = smoke_cell.smoke_cell(cell_name)
    table = cell.reference.Model(cell.config).param_table()
    specs = build(get_smoke(cell.config["port"]["arch"])).param_specs()
    assert {k: tuple(v.shape) for k, v in table.items()} == \
        {k: tuple(s.shape) for k, s in specs.items()}


@pytest.mark.parametrize("cell_name", CELLS)
def test_three_steps_equal_the_ports_in_float32(cell_name, f32_port):
    from reference.common import AdamW, Precision, train_steps
    from repro_torch.configs import get_smoke
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.step import make_train_step

    cell = smoke_cell.smoke_cell(cell_name)
    model = cell.reference.Model(cell.config)
    arch = get_smoke(cell.config["port"]["arch"])
    tr = cell.traffic
    batches = _batches(model.v, 3, 4, 32, seed=5)
    adamw = opt_mod.AdamWConfig(**tr["optimizer"])
    step = make_train_step(arch, None, adamw, num_microbatches=2)
    state = opt_mod.init_state(make_weights(model.param_table(), 11, "cpu"))
    port_losses, port_norms = [], []
    for x, y in batches:
        state, metrics = step(state, {"tokens": x, "labels": y})
        port_losses.append(float(metrics["loss"]))
        port_norms.append(float(metrics["grad_norm"]))
    params = make_weights(model.param_table(), 11, "cpu")
    recs = train_steps(model, params, batches, AdamW(**tr["optimizer"]), 2, Precision("f32"))
    np.testing.assert_allclose([r["loss"] for r in recs], port_losses, rtol=1e-5)
    np.testing.assert_allclose([r["grad_norm"] for r in recs], port_norms, rtol=1e-4)
    for k, p in params.items():
        moved = float((p - make_weights({k: model.param_table()[k]}, 11, "cpu")[k]).norm())
        gap = float((p - state["params"][k]).norm())
        assert gap <= 1e-3 * moved + 1e-6, (k, gap, moved)


def test_attention_gradients_equal_autograd_of_the_plain_softmax():
    from reference.common import Precision, causal_attention

    gen = torch.Generator().manual_seed(3)
    b, s, h, hkv, dq, dv = 2, 40, 4, 2, 24, 16
    q = torch.randn(b, s, h, dq, generator=gen, requires_grad=True)
    k = torch.randn(b, s, hkv, dq, generator=gen, requires_grad=True)
    v = torch.randn(b, s, hkv, dv, generator=gen, requires_grad=True)
    do = torch.randn(b, s, h, dv, generator=gen)
    out = causal_attention(q, k, v, 0.3, Precision("f32"))
    gq, gk, gv = torch.autograd.grad(out, (q, k, v), do)
    kk, vv = k.repeat_interleave(h // hkv, dim=2), v.repeat_interleave(h // hkv, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) * 0.3
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vv)
    wq, wk, wv = torch.autograd.grad(want, (q, k, v), do)
    for a, w in ((out, want), (gq, wq), (gk, wk), (gv, wv)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
