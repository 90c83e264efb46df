"""The port's Multi-head Latent Attention and the ``mla_moe`` family
(deepseek-v2-lite) held against the JAX package, on the CPU at smoke widths.

Attention with a value head dim below the q/k head dim (``layers.
flash_attention``, V zero-padded for the kernels) and its gradient through
``ops.FlashAttention``'s plain path; ``apply_mla_full`` (the expanded path
and its latent cache) and ``apply_mla_decode`` (the absorbed decode);
parameter and cache trees with the leading dense layer (``dense0``); the
loss with its aux loss over the MoE layers and every gradient leaf; prefill
(last logits, the MoE layers' ``c_kv``/``k_rope``); the decode step and its
four caches; decode against prefill; train-state checkpoints across
packages; the ``launch`` entry points.  Weights are drawn with numpy from
the JAX package's ParamSpecs by its init rules (plus a seeded
perturbation), carried into the port by ``params_from_numpy``; inputs are
seeded numpy arrays handed to both.  The JAX package's functions are
compiled with XLA's CPU backend optimisation level 0.

Tolerances:
* f32 compute in both packages (their ``COMPUTE_DTYPE`` patched to f32):
  the same algorithm up to summation order.  Attention (hd 24, hd_v 16):
  output and gradients atol 1e-5.  One MLA layer: output and cache atol
  1e-4.  Loss and aux atol 1e-5 (observed 0 and 4.8e-7); each gradient
  leaf within 1e-3 of its own largest entry (tests/test_torch_families.py's
  bounds; observed <= 3.6e-5); prefill and decode logits and caches atol
  1e-4 (over 6 decode positions).
* bf16 compute, as configured (tests/test_torch_families.py's bounds):
  loss atol 0.02; gradients at the initial weights within three times the
  JAX package's own bf16 error plus 0.01 of their norm, leaf by leaf;
  logits within 0.15 plus the JAX package's own bf16 error on them; caches
  within 2^-4 of their largest entry plus that error.  Tokens are compared
  where the reference's top-2 margin exceeds twice the logit bound; the
  bf16 prefill cache on the tokens whose every MoE layer below chose its
  experts by a margin of at least ``ROUTE_TIE_MARGIN`` (a top-k swap under
  rounding).
* Decode against prefill (tests/test_models.py::test_decode_matches_prefill's
  bounds, bf16, the MoE drop-free at capacity factor 100): logits within
  0.25, at least half the greedy tokens equal.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget_full
from repro.configs import get_smoke as jget
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models.model import build as jbuild
from repro.sharding import AxisCtx, ParamSpec as JParamSpec
from repro.storage import checkpoint as jck
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.cluster import build_cluster
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMoE
from repro_torch.models.model import build as tbuild
from repro_torch.sharding import flatten, params_from_numpy, state_from_numpy
from repro_torch.storage import checkpoint as tck
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer

ARCH = "deepseek-v2-lite-16b"
B, S = 2, 24
DECODE_STEPS = 6
ATTN_ATOL = 1e-5
LAYER_ATOL = 1e-4
F32 = dict(loss_atol=1e-5, grad_rel_max=1e-3, atol=1e-4)
BF16 = dict(loss_atol=0.02, grad_noise_factor=3.0, grad_floor=0.01, logit_atol=0.15,
            cache_rel_max=2**-4)
ROUTE_TIE_MARGIN = 0.01
CTX = AxisCtx()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU thread pool makes these small shapes slower, not faster."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@contextlib.contextmanager
def compute(dtype: str):
    """Both packages' COMPUTE_DTYPE: "bf16" as configured, or "f32"."""
    if dtype == "bf16":
        yield
        return
    old = JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE
    JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = old


def _numpy_init(specs, rng: np.random.Generator):
    """A tree of the JAX package's ParamSpecs drawn with numpy by its init
    rules ("scaled" divides by sqrt(shape[-2]))."""
    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        scale = 1.0 / np.sqrt(spec.shape[-2]) if spec.init == "scaled" and len(spec.shape) >= 2 \
            else spec.scale
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    return jax.tree.map(draw, specs, is_leaf=lambda x: isinstance(x, JParamSpec))


def _compiled(fn):
    """``jax.jit(fn)`` compiled at its first call with XLA's CPU backend
    optimisation level 0 and reused for the same shapes."""
    jitted, exe = jax.jit(fn), []

    def call(*args):
        if not exe:
            exe.append(jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return exe[0](*args)

    return call


@functools.cache
def _jax_params(perturbed: bool = True, seed: int = 1):
    rng = np.random.default_rng(seed)
    params = _numpy_init(jbuild(jget(ARCH)).param_specs(), rng)
    if not perturbed:
        return params
    return jax.tree.map(lambda x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _port_params(perturbed: bool = True):
    return params_from_numpy(_jax_params(perturbed), device="cpu")


@functools.cache
def _batch(b: int = B, s: int = S, seed: int = 3):
    rng = np.random.default_rng(seed)
    vocab = jget(ARCH).vocab
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


# -- parameter and cache trees ------------------------------------------------------------
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_reference(size):
    jcfg = jget(ARCH) if size == "smoke" else jget_full(ARCH)
    tcfg = tconfigs.get_smoke(ARCH) if size == "smoke" else tconfigs.get(ARCH)
    jspecs = jax.tree_util.tree_flatten_with_path(
        jbuild(jcfg).param_specs(), is_leaf=lambda x: isinstance(x, JParamSpec))[0]
    tspecs = tbuild(tcfg).param_specs()
    assert list(tspecs) == [".".join(k.key for k in path) for path, _ in jspecs]
    assert any(k.startswith("dense0.mla.") for k in tspecs)
    for (_, j), t in zip(jspecs, tspecs.values()):
        assert (t.shape, t.axes, t.init, t.scale) == (j.shape, j.axes, j.init, j.scale)
    assert tbuild(tcfg).param_count() == jcfg.param_count()
    for cache_len in (25, 4096):
        cj = jbuild(jcfg).cache_specs(4, cache_len)
        ct = tbuild(tcfg).cache_specs(4, cache_len)
        assert set(ct) == {"c_kv", "k_rope", "c_kv0", "k_rope0"}
        assert {k: (s.shape, s.axes, s.init) for k, s in ct.items()} == \
            {k: (s.shape, s.axes, s.init) for k, s in cj.items()}
        assert {k: str(s.dtype).split(".")[-1] for k, s in ct.items()} == \
            {k: np.dtype(s.dtype).name for k, s in cj.items()}


def test_chip_cut_param_count():
    """The depth cut of the card's mla_encdec phase: 27 -> 2 layers, the
    leading dense layer and one MLA + MoE layer."""
    cut = dataclasses.replace(tconfigs.get(ARCH), num_layers=2)
    assert tbuild(cut).param_count() == 1_085_287_424
    assert tbuild(tconfigs.get(ARCH)).param_count() == 15_706_484_224


# -- attention with hd_v != hd --------------------------------------------------------------
@pytest.mark.parametrize("causal,sq,sk", [(True, 20, 20), (False, 13, 33)])
def test_flash_attention_hd_v_matches_reference(causal, sq, sk):
    """hd 24, hd_v 16 (MLA-smoke's widths), f32: the output and, through
    ``ops.FlashAttention`` (whose backward here is the plain version), the
    gradients of q, k and v equal the JAX package's chunked attention and
    its XLA gradient (kv_chunk >= Sk: Queue 3 item 3 does not arise)."""
    rng = np.random.default_rng(sq)
    q = rng.normal(size=(2, sq, 4, 24)).astype(np.float32)
    k = rng.normal(size=(2, sk, 4, 24)).astype(np.float32)
    v = rng.normal(size=(2, sk, 4, 16)).astype(np.float32)
    do = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    scale = 1 / np.sqrt(24.0)

    def ref(q, k, v):
        return JL.flash_attention(q, k, v, mask=JL.MaskSpec(causal=causal), scale=scale)

    want, vjp = jax.vjp(jax.jit(ref), q, k, v)
    want_grads = vjp(do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    calls = []
    real = tfab.flash_attention_bwd_ref

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfab, "flash_attention_bwd_ref", counting)
        out = TL.flash_attention(tq, tk, tv, mask=TL.MaskSpec(causal=causal), scale=float(scale))
        grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert out.shape == (2, sq, 4, 16)
    assert calls == [(2, sq, 4, 24)]  # one backward, at the padded head dim
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATTN_ATOL)
    for g, w in zip(grads, want_grads):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_ATOL)


def test_flash_attention_refuses_hd_v_above_hd():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="hd_v"):
        TL.flash_attention(q, q, torch.zeros((1, 4, 2, 32)), mask=TL.MaskSpec())


# -- one MLA layer ------------------------------------------------------------------------------
def _mla_layer():
    cfg = jget(ARCH)
    layer = _numpy_init(JMLA.mla_specs(cfg, 1), np.random.default_rng(4))
    layer = {k: v[0] + 0.05 * np.random.default_rng(5).normal(size=v.shape[1:]).astype(np.float32)
             for k, v in layer.items()}
    return cfg, layer, {k: torch.from_numpy(v) for k, v in layer.items()}


def test_apply_mla_full_matches_reference():
    cfg, layer, tlayer = _mla_layer()
    tcfg = tconfigs.get_smoke(ARCH)
    x = np.random.default_rng(6).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    with compute("f32"):
        want, want_cache = jax.jit(lambda p, x: JMLA.apply_mla_full(p, x, cfg, CTX))(layer, x)
        got, cache = TMLA.apply_mla_full(tlayer, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)
    assert set(cache) == set(want_cache) == {"c_kv", "k_rope"}
    assert cache["c_kv"].shape == (B, S, cfg.mla.kv_lora_rank)
    assert cache["k_rope"].shape == (B, S, cfg.mla.qk_rope_head_dim)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(want_cache[name]),
                                   atol=LAYER_ATOL, err_msg=name)


@pytest.mark.parametrize("pos", [0, 6, 9])
def test_apply_mla_decode_matches_reference(pos):
    """The absorbed decode at ``pos`` over a 10-slot cache whose slots hold
    seeded latents (those past ``pos`` masked), f32."""
    cfg, layer, tlayer = _mla_layer()
    tcfg = tconfigs.get_smoke(ARCH)
    rng = np.random.default_rng(7 + pos)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    cache = {"c_kv": rng.normal(size=(B, 10, cfg.mla.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.normal(size=(B, 10, cfg.mla.qk_rope_head_dim)).astype(np.float32)}
    with compute("f32"):
        want, want_cache = jax.jit(
            lambda p, x, c, pos: JMLA.apply_mla_decode(p, x, c, pos, cfg, None))(
            layer, x, cache, jnp.int32(pos))
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        got, new = TMLA.apply_mla_decode(tlayer, torch.from_numpy(x), tcache, pos, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)
    for name in new:
        assert new[name] is tcache[name]  # written in place
        np.testing.assert_allclose(new[name].numpy(), np.asarray(want_cache[name]),
                                   atol=LAYER_ATOL, err_msg=name)


# -- loss and gradients -------------------------------------------------------------------------
@functools.cache
def _jitted(kind: str, dtype: str):
    model = jbuild(jget(ARCH))
    if kind == "loss":
        return _compiled(jax.value_and_grad(lambda p, b: model.loss(p, b, CTX), has_aux=True))
    if kind == "prefill":
        return _compiled(lambda p, b: model.prefill(p, b, CTX))
    return _compiled(lambda p, c, t, pos: model.decode_step(p, c, t, pos, CTX))


@functools.cache
def _jax_loss_and_grads(dtype: str, perturbed: bool = True):
    with compute(dtype):
        (loss, metrics), grads = _jitted("loss", dtype)(_jax_params(perturbed), _batch())
    return float(loss), float(metrics["aux"]), flatten(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(dtype: str, perturbed: bool = True):
    model = tbuild(tconfigs.get_smoke(ARCH))
    params = {k: p.requires_grad_(True) for k, p in _port_params(perturbed).items()}
    with compute(dtype):
        loss, metrics = model.loss(params, _port_batch(_batch()))
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    return float(loss.detach()), float(metrics["aux"].detach()), dict(zip(params, grads))


def test_loss_and_grads_f32():
    want_loss, want_aux, want = _jax_loss_and_grads("f32")
    loss, aux, got = _port_loss_and_grads("f32")
    assert abs(loss - want_loss) <= F32["loss_atol"]
    assert aux > 0 and abs(aux - want_aux) <= F32["loss_atol"]
    assert list(got) == list(want)
    for name, g in got.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[name].shape, name
        assert np.abs(want[name]).max() > 0, name  # every leaf is read by the loss
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= F32["grad_rel_max"] * float(np.abs(want[name]).max()), (name, err)


def test_loss_and_grads_bf16():
    want_loss, _, want = _jax_loss_and_grads("bf16", perturbed=False)
    _, _, exact = _jax_loss_and_grads("f32", perturbed=False)
    loss, _, got = _port_loss_and_grads("bf16", perturbed=False)
    assert np.isfinite(loss) and abs(loss - want_loss) <= BF16["loss_atol"]
    for name, g in got.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        noise = float(np.linalg.norm(want[name] - exact[name]))
        err = float(np.linalg.norm(g.numpy() - want[name]))
        bound = BF16["grad_noise_factor"] * noise + BF16["grad_floor"] * np.linalg.norm(exact[name])
        assert err <= bound, (name, err, noise)


# -- prefill ----------------------------------------------------------------------------------
@functools.cache
def _jax_prefill(dtype: str):
    with compute(dtype):
        logits, cache = _jitted("prefill", dtype)(_jax_params(), _inputs(_batch()))
    return (np.asarray(logits, np.float32)[..., :jget(ARCH).vocab],
            {k: np.asarray(v, np.float32) for k, v in cache.items()})


def _logit_atol(dtype: str, want_bf16: np.ndarray, want_f32: np.ndarray) -> float:
    if dtype == "f32":
        return F32["atol"]
    return BF16["logit_atol"] + float(np.abs(want_bf16 - want_f32).max())


def _cache_atol(want_bf16: np.ndarray, want_f32: np.ndarray) -> float:
    return (BF16["cache_rel_max"] * float(np.abs(want_bf16).max())
            + float(np.abs(want_bf16 - want_f32).max()))


@functools.cache
def _near_ties():
    """(MoE layers, B*S) bool: a token whose experts some MoE layer below
    this one chose by a margin (the top-k-th against the next probability,
    f32) under ROUTE_TIE_MARGIN."""
    margins = []
    real = TMoE._route

    def recording(x, w, k):
        probs = torch.softmax(x.float() @ w.float(), dim=-1).sort(-1, descending=True).values
        margins.append(probs[:, k - 1] - probs[:, k])
        return real(x, w, k)

    with pytest.MonkeyPatch.context() as mp, compute("f32"):
        mp.setattr(TMoE, "_route", recording)
        tstep.make_prefill_step(tconfigs.get_smoke(ARCH))(_port_params(),
                                                          _port_batch(_inputs(_batch())))
    tie = torch.stack(margins) < ROUTE_TIE_MARGIN
    below = torch.cumsum(tie.int(), 0) - tie.int()
    out = (below > 0).numpy()
    assert out.sum(1).max() <= B * S // 4  # the check still holds most tokens
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_reference(dtype):
    cfg = jget(ARCH)
    want_logits, want_cache = _jax_prefill(dtype)
    with compute(dtype):
        logits, cache = tstep.make_prefill_step(tconfigs.get_smoke(ARCH))(
            _port_params(), _port_batch(_inputs(_batch())))
    # the MoE layers' latents only: the JAX package's prefill keeps none of dense0's
    assert set(cache) == set(want_cache) == {"c_kv", "k_rope"}
    assert logits.shape == (B, 1, cfg.padded_vocab)
    atol = _logit_atol(dtype, want_logits, _jax_prefill("f32")[0])
    np.testing.assert_allclose(logits.float().numpy()[..., :cfg.vocab], want_logits, atol=atol)
    for name, c in cache.items():
        assert tuple(c.shape) == want_cache[name].shape, name
        got, want = c.float().numpy(), want_cache[name]
        atol = F32["atol"]
        if dtype == "bf16":
            atol = _cache_atol(want, _jax_prefill("f32")[1][name])
            keep = ~_near_ties().reshape(-1, B, S)
            got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


# -- decode -----------------------------------------------------------------------------------
@functools.cache
def _teacher_forced(dtype: str, steps: int = DECODE_STEPS):
    """Both packages' decode steps over the same tokens from empty caches:
    (jax logits, port logits, jax cache, port cache), logits (steps, B, vocab)."""
    jcfg, tcfg = jget(ARCH), tconfigs.get_smoke(ARCH)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp, tp = _jax_params(), _port_params()
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, steps)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jc = {k: jnp.zeros(s.shape, jdt) for k, s in jm.cache_specs(B, steps + 1).items()}
    tc = {k: torch.zeros(s.shape, dtype=tdt) for k, s in tm.cache_specs(B, steps + 1).items()}
    step = _jitted("decode", dtype)
    tstep_fn = tstep.make_decode_step(tcfg)
    jl, tl = [], []
    with compute(dtype):
        for pos in range(steps):
            a, jc = step(jp, jc, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
            t, tc = tstep_fn(tp, tc, torch.from_numpy(toks[:, pos:pos + 1]).long(), pos)
            jl.append(np.asarray(a, np.float32)[:, 0, :jcfg.vocab])
            tl.append(t.float().numpy()[:, 0, :jcfg.vocab])
    return (np.stack(jl), np.stack(tl), {k: np.asarray(v, np.float32) for k, v in jc.items()},
            {k: v.float().numpy() for k, v in tc.items()})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_matches_reference(dtype):
    want, got, jc, tc = _teacher_forced(dtype)
    assert set(tc) == set(jc) == {"c_kv", "k_rope", "c_kv0", "k_rope0"}
    assert np.isfinite(got).all()
    atol = _logit_atol(dtype, want, _teacher_forced("f32")[0])
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if dtype == "bf16":
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * atol
        np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    exact = _teacher_forced("f32")[2]
    for name in tc:
        assert tc[name].shape == jc[name].shape, name
        assert np.abs(tc[name][:, :, :DECODE_STEPS]).max() > 0, name  # every slot written
        assert not tc[name][:, :, DECODE_STEPS:].any(), name  # and no other
        atol = F32["atol"] if dtype == "f32" else _cache_atol(jc[name], exact[name])
        np.testing.assert_allclose(tc[name], jc[name], atol=atol, rtol=0, err_msg=name)


def test_decode_matches_prefill():
    """Absorbed decode from an empty cache agrees with a fresh (expanded)
    prefill at every prefix, bf16 (tests/test_models.py::
    test_decode_matches_prefill and its bounds, in the port), the MoE made
    drop-free as there: capacity drops depend on the batch's shape."""
    cfg = tconfigs.get_smoke(ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    model = tbuild(cfg)
    params = _port_params()
    t = 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, t))).long()
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in model.cache_specs(B, t + 1).items()}
    prefill, decode = tstep.make_prefill_step(cfg), tstep.make_decode_step(cfg)
    for pos in range(t):
        dec, cache = decode(params, cache, toks[:, pos:pos + 1], pos)
        ref, _ = prefill(params, {"tokens": toks[:, :pos + 1]})
        d, r = dec[:, 0].float().numpy(), ref[:, 0].float().numpy()
        assert np.abs(d - r).max() < 0.25 and (d.argmax(-1) == r.argmax(-1)).mean() >= 0.5, pos


# -- checkpoints across packages and the entry points -----------------------------------------
def _equal(a, b) -> bool:
    fa, fb = flatten(a), flatten(b)
    return list(fa) == list(fb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(fa.values(), fb.values()))


def test_train_state_checkpoints_restore_across_packages(cluster):
    """A deepseek-smoke train state (``dense0`` included) written by either
    package restores in the other, byte for byte."""
    jstate = jax.tree.map(np.asarray, jopt.init_state(_jax_params()))
    jstate["step"] = np.int32(3)
    tstate = state_from_numpy(jstate, device="cpu")
    assert tck.serialize_pytree(tstate) == jck.serialize_pytree(jstate)
    rec = jck.CheckpointManager(cluster[3], num_host_shards=2).save(3, jstate)
    data = b"".join(r.data for r in cluster[3].get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    assert _equal(tck.deserialize_pytree(data[: rec.total_bytes], tstate), tstate)
    _, _, _, client = build_cluster(device="cpu")
    trainer = Trainer(tconfigs.get_smoke(ARCH), device="cpu",
                      ckpt=tck.CheckpointManager(client, num_host_shards=2))
    state = trainer.init_state(seed=4)
    rec = trainer.ckpt.save(2, state)
    data = b"".join(r.data for r in client.get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    assert _equal(jck.deserialize_pytree(data[: rec.total_bytes], jstate), state)


def test_launch_train_runs_mla():
    run = ttrain.train(tconfigs.get_smoke(ARCH), steps=3, batch=2, seq=16, ckpt_every=2,
                       device="cpu")
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert int(run.state["step"]) == 3


def test_launch_serve_mla_on_the_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "4",
                       "--gen", "6", "--device", "cpu", "--kill-sp"])
    assert out.shape == (2, 10)
    assert "restored+verified" in capsys.readouterr().out
