"""The port's MoE, SSM, hybrid and embedding-input families held against the
JAX package, on the CPU at smoke widths: phi-3-vision (dense, embedding
inputs), qwen3-moe (MoE, qk-norm), falcon-mamba (SSM) and hymba (hybrid,
long mode).

Parameter trees, the loss with its MoE aux loss and every gradient leaf,
prefill (last logits and the cache, empty for the SSM family as the JAX
package's), the decode step and its cache (``k``/``v``/``conv``/``h_ssm``),
long-mode decode past hymba-smoke's 32-slot window, routing and dispatch,
capacity drops, the selective scan and its recurrence, the ring cache
against windowed attention, the stub frontend's embeddings, train-state
checkpoints across packages and the ``launch`` entry points.  Weights are
drawn with numpy from the JAX package's ParamSpecs by its init rules (plus
a seeded perturbation), carried into the port by ``params_from_numpy``;
inputs are seeded numpy arrays handed to both.  The JAX package's model
functions are compiled once per shape with XLA's CPU backend optimisation
level 0 (the same HLO, half the compile time).

Tolerances:
* f32 compute in both packages (their ``COMPUTE_DTYPE`` patched to f32):
  the same algorithm up to summation order (the scan combines in
  ``jax.lax.associative_scan``'s order; XLA may contract ``a2 * b1 + b2``
  into one rounding).  Loss and aux atol 1e-5 (losses near 5.7, aux near
  3.7); each gradient leaf within 1e-3 of its own largest entry (observed
  <= 2.5e-5); prefill and decode logits and caches atol 1e-4 (observed
  <= 2.5e-5), over 6 decode positions and 40 in long mode.
  ``F.softplus`` returns x above 20 where ``jax.nn.softplus`` adds
  log1p(exp(-x)) < 2.1e-9: below f32 rounding at such x.
* bf16 compute, as configured: both packages round products and
  activations to bf16 at different places (tests/test_torch_train.py).
  Loss atol 0.02; gradients at the initial weights within three times the
  JAX package's own bf16 error (||g - g_bf16|| <= 3 ||g_bf16 - g_f32|| +
  0.01 ||g_f32||, leaf by leaf).  Logits (prefill, and decode
  teacher-forced) within 0.15 (tests/test_torch_serve.py's bound) plus the
  JAX package's own bf16 error on them, max |l_bf16 - l_f32|: the SSM
  families round far more than the dense ones (falcon-mamba's decode
  logits move 0.33 in the JAX package from f32 to bf16, hymba's long-mode
  ones 0.45; the port's own move 0.27 and 0.43).  Caches likewise: 2^-4 of
  each one's largest entry plus the JAX package's own bf16 error on it.
  Tokens are compared where the reference's top-2 margin exceeds twice the
  logit bound.  A MoE router's top-k choice can swap between the packages
  where two experts' probabilities lie within bf16 rounding (qwen3-smoke's
  token 17 has a margin of 0.0009 in layer 0): the bf16 prefill cache is
  compared on the tokens whose every MoE layer below chose by a margin of
  at least ``ROUTE_TIE_MARGIN`` = 0.01 in f32 (at most a quarter of them
  may be left out; 5 of 48 are here).
* Routing, dispatch and capacity drops: expert ids and destinations equal,
  routing weights and aux within 1e-6 (f32 softmax, equal inputs).
* The mamba recurrence against the full scan (the JAX package's own
  test's bounds): atol 0.15, rtol 0.1 in bf16; the port's scan against
  ``jax.lax.associative_scan`` on the same f32 pairs: rtol 1e-6.
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
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import moe as JMoE
from repro.models.model import build as jbuild
from repro.sharding import AxisCtx, ParamSpec as JParamSpec
from repro.storage import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train.loop import Trainer as JTrainer
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.cluster import build_cluster
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.model import build as tbuild
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import AxisCtx as TAxisCtx, flatten, params_from_numpy, state_from_numpy
from repro_torch.storage import checkpoint as tck
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer, stub_embeddings

FAMILIES = ["phi-3-vision-4.2b", "qwen3-moe-30b-a3b", "falcon-mamba-7b", "hymba-1.5b"]
B, S = 2, 24
DECODE_STEPS, LONG_STEPS = 6, 40  # hymba-smoke's long_window is 32: 40 positions wrap it
F32 = dict(loss_atol=1e-5, grad_rel_max=1e-3, atol=1e-4)
BF16 = dict(loss_atol=0.02, grad_noise_factor=3.0, grad_floor=0.01, logit_atol=0.15,
            cache_rel_max=2**-4)
ROUTE_ATOL = 1e-6
ROUTE_TIE_MARGIN = 0.01  # router probabilities this close may swap under bf16 rounding
SCAN_RTOL = 1e-6
RECURRENCE = dict(atol=0.15, rtol=0.1)
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
    """A parameter tree of the JAX package's ParamSpecs drawn with numpy by
    its init rules (``repro/sharding.py::init_params``: "scaled" divides by
    sqrt(shape[-2]))."""
    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        scale = 1.0 / np.sqrt(spec.shape[-2]) if spec.init == "scaled" and len(spec.shape) >= 2 \
            else spec.scale
        return (scale * rng.standard_normal(spec.shape)).astype(np.float32)

    return jax.tree.map(draw, specs, is_leaf=lambda x: isinstance(x, JParamSpec))


@functools.cache
def _jax_params(arch: str, perturbed: bool = True, seed: int = 1):
    """The JAX package's weights from a seed (plus, ``perturbed``, seeded
    noise so that norms and biases are not trivial), numpy leaves."""
    rng = np.random.default_rng(seed)
    params = _numpy_init(jbuild(jget(arch)).param_specs(), rng)
    if not perturbed:
        return params
    return jax.tree.map(lambda x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _port_params(arch: str, perturbed: bool = True):
    return params_from_numpy(_jax_params(arch, perturbed), device="cpu")


@functools.cache
def _batch(arch: str, b: int = B, s: int = S, seed: int = 3):
    """numpy inputs: tokens or (for embedding-input models) embeddings, labels."""
    rng = np.random.default_rng(seed)
    cfg = jget(arch)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


# -- parameter trees --------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_reference(arch, size):
    jcfg = jget(arch) if size == "smoke" else jget_full(arch)
    tcfg = tconfigs.get_smoke(arch) if size == "smoke" else tconfigs.get(arch)
    jspecs = jax.tree_util.tree_flatten_with_path(
        jbuild(jcfg).param_specs(), is_leaf=lambda x: isinstance(x, JParamSpec))[0]
    tspecs = tbuild(tcfg).param_specs()
    assert list(tspecs) == [".".join(k.key for k in path) for path, _ in jspecs]
    for (_, j), t in zip(jspecs, tspecs.values()):
        assert (t.shape, t.axes, t.init, t.scale) == (j.shape, j.axes, j.init, j.scale)
    assert tbuild(tcfg).param_count() == jcfg.param_count()
    for long_mode in (False, True):
        for cache_len in (25, 4096):
            cj = jbuild(jcfg).cache_specs(4, cache_len, long_mode=long_mode)
            ct = tbuild(tcfg).cache_specs(4, cache_len, long_mode=long_mode)
            assert {k: (s.shape, s.axes, s.init) for k, s in ct.items()} == \
                {k: (s.shape, s.axes, s.init) for k, s in cj.items()}
            assert {k: str(s.dtype).split(".")[-1] for k, s in ct.items()} == \
                {k: np.dtype(s.dtype).name for k, s in cj.items()}


def test_chip_cuts_param_counts():
    """The depth cuts of the card's families phase, as its docstring states."""
    hymba = tconfigs.get("hymba-1.5b")
    qwen = tconfigs.get("qwen3-moe-30b-a3b")
    assert tbuild(dataclasses.replace(hymba, num_layers=2)).param_count() == 200_712_000
    assert tbuild(dataclasses.replace(qwen, num_layers=1)).param_count() == 1_245_976_832


# -- loss and gradients -------------------------------------------------------------------
def _compiled(fn):
    """``jax.jit(fn)`` compiled at its first call for those arguments' shapes
    and reused: the same HLO, compiled with XLA's CPU backend optimisation
    level 0, which halves these tests' compile time."""
    jitted, exe = jax.jit(fn), []

    def call(*args):
        if not exe:
            exe.append(jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return exe[0](*args)

    return call


@functools.cache
def _jitted(arch: str, kind: str, dtype: str, long_mode: bool = False):
    """One compiled function of the JAX package per (arch, kind, compute
    dtype): traced at its first call, under ``compute(dtype)``."""
    model = jbuild(jget(arch))
    if kind == "loss":
        return _compiled(jax.value_and_grad(lambda p, b: model.loss(p, b, CTX), has_aux=True))
    if kind == "prefill":
        return _compiled(lambda p, b: model.prefill(p, b, CTX))
    return _compiled(lambda p, c, t, pos: model.decode_step(p, c, t, pos, CTX,
                                                            long_mode=long_mode))


@functools.cache
def _jax_loss_and_grads(arch: str, dtype: str, perturbed: bool = True):
    with compute(dtype):
        (loss, metrics), grads = _jitted(arch, "loss", dtype)(_jax_params(arch, perturbed),
                                                              _batch(arch))
    return float(loss), float(metrics["aux"]), flatten(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(arch: str, dtype: str, perturbed: bool = True):
    model = tbuild(tconfigs.get_smoke(arch))
    params = {k: p.requires_grad_(True) for k, p in _port_params(arch, perturbed).items()}
    with compute(dtype):
        loss, metrics = model.loss(params, _port_batch(_batch(arch)))
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    return float(loss.detach()), float(metrics["aux"].detach()), dict(zip(params, grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_f32(arch):
    want_loss, want_aux, want = _jax_loss_and_grads(arch, "f32")
    loss, aux, got = _port_loss_and_grads(arch, "f32")
    assert abs(loss - want_loss) <= F32["loss_atol"]
    assert abs(aux - want_aux) <= F32["loss_atol"]
    assert (aux > 0) == (jget(arch).moe is not None)
    assert list(got) == list(want)
    for name, g in got.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[name].shape, name
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= F32["grad_rel_max"] * float(np.abs(want[name]).max()), (name, err)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_bf16(arch):
    want_loss, _, want = _jax_loss_and_grads(arch, "bf16", perturbed=False)
    _, _, exact = _jax_loss_and_grads(arch, "f32", perturbed=False)
    loss, _, got = _port_loss_and_grads(arch, "bf16", perturbed=False)
    assert np.isfinite(loss) and abs(loss - want_loss) <= BF16["loss_atol"]
    for name, g in got.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        noise = float(np.linalg.norm(want[name] - exact[name]))  # the reference's own bf16 error
        err = float(np.linalg.norm(g.numpy() - want[name]))
        bound = BF16["grad_noise_factor"] * noise + BF16["grad_floor"] * np.linalg.norm(exact[name])
        assert err <= bound, (name, err, noise)


# -- prefill -------------------------------------------------------------------------------
@functools.cache
def _jax_prefill(arch: str, dtype: str):
    with compute(dtype):
        logits, cache = _jitted(arch, "prefill", dtype)(_jax_params(arch), _inputs(_batch(arch)))
    return (np.asarray(logits, np.float32)[..., :jget(arch).vocab],
            {k: np.asarray(v, np.float32) for k, v in cache.items()})


def _logit_atol(dtype: str, want_bf16: np.ndarray, want_f32: np.ndarray) -> float:
    """f32: F32["atol"]; bf16: BF16["logit_atol"] plus the JAX package's own
    bf16 error on these logits (its bf16 against its f32 result)."""
    if dtype == "f32":
        return F32["atol"]
    return BF16["logit_atol"] + float(np.abs(want_bf16 - want_f32).max())


def _cache_atol(want_bf16: np.ndarray, want_f32: np.ndarray) -> float:
    """bf16: BF16["cache_rel_max"] of the cache's largest entry plus the JAX
    package's own bf16 error on it."""
    return (BF16["cache_rel_max"] * float(np.abs(want_bf16).max())
            + float(np.abs(want_bf16 - want_f32).max()))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_reference(arch, dtype):
    cfg = jget(arch)
    want_logits, want_cache = _jax_prefill(arch, dtype)
    with compute(dtype):
        logits, cache = tstep.make_prefill_step(tconfigs.get_smoke(arch))(
            _port_params(arch), _port_batch(_inputs(_batch(arch))))
    # the JAX package's prefill carries no SSM state: the ssm family's cache is empty
    assert set(cache) == set(want_cache) == (set() if cfg.family == "ssm" else {"k", "v"})
    assert logits.shape == (B, 1, cfg.padded_vocab)
    atol = _logit_atol(dtype, want_logits, _jax_prefill(arch, "f32")[0])
    np.testing.assert_allclose(logits.float().numpy()[..., :cfg.vocab], want_logits, atol=atol)
    ties = _near_ties(arch) if dtype == "bf16" else None
    for name, c in cache.items():
        assert tuple(c.shape) == want_cache[name].shape, name
        got, want = c.float().numpy(), want_cache[name]
        if dtype == "bf16":
            atol = _cache_atol(want, _jax_prefill(arch, "f32")[1][name])
            if ties is not None:  # a near-tie's token may route otherwise in either package
                keep = ~ties.reshape(ties.shape[0], B, S)
                got, want = got[keep], want[keep]
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


@functools.cache
def _near_ties(arch: str):
    """For the MoE family: (layers, B*S) bool, a token whose expert set some
    MoE layer below this one chose by a margin (the top-k-th against the
    next probability, f32) under ROUTE_TIE_MARGIN; None for the others."""
    if jget(arch).moe is None:
        return None
    margins = []
    real = TMoE._route

    def recording(x, w, k):
        probs = torch.softmax(x.float() @ w.float(), dim=-1).sort(-1, descending=True).values
        margins.append(probs[:, k - 1] - probs[:, k])
        return real(x, w, k)

    with pytest.MonkeyPatch.context() as mp, compute("f32"):
        mp.setattr(TMoE, "_route", recording)
        tstep.make_prefill_step(tconfigs.get_smoke(arch))(
            _port_params(arch), _port_batch(_inputs(_batch(arch))))
    tie = torch.stack(margins) < ROUTE_TIE_MARGIN  # (layers, B*S)
    below = torch.cumsum(tie.int(), 0) - tie.int()  # a tie in a layer below this one
    out = (below > 0).numpy()
    assert out.sum(1).max() <= B * S // 4  # the check still holds most tokens
    return out


# -- decode ----------------------------------------------------------------------------------
@functools.cache
def _teacher_forced(arch: str, dtype: str, steps: int, long_mode: bool = False):
    """Both packages' decode steps over the same tokens from empty caches:
    (jax logits, port logits, jax cache, port cache), logits (steps, B, vocab)."""
    jcfg, tcfg = jget(arch), tconfigs.get_smoke(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp, tp = _jax_params(arch), _port_params(arch)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, steps)).astype(np.int32)

    def dt(name, spec, jax_side):  # f32 compute: every cache in f32 (h_ssm always is)
        if dtype == "f32":
            return jnp.float32 if jax_side else torch.float32
        return spec.dtype

    jc = {k: jnp.zeros(s.shape, dt(k, s, True))
          for k, s in jm.cache_specs(B, steps + 1, long_mode=long_mode).items()}
    tc = {k: torch.zeros(s.shape, dtype=dt(k, s, False))
          for k, s in tm.cache_specs(B, steps + 1, long_mode=long_mode).items()}
    step = _jitted(arch, "decode", dtype, long_mode)
    tstep_fn = tstep.make_decode_step(tcfg, long_mode=long_mode)
    jl, tl = [], []
    with compute(dtype):
        for pos in range(steps):
            a, jc = step(jp, jc, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
            t, tc = tstep_fn(tp, tc, torch.from_numpy(toks[:, pos:pos + 1]).long(), pos)
            jl.append(np.asarray(a, np.float32)[:, 0, :jcfg.vocab])
            tl.append(t.float().numpy()[:, 0, :jcfg.vocab])
    return (np.stack(jl), np.stack(tl), {k: np.asarray(v, np.float32) for k, v in jc.items()},
            {k: v.float().numpy() for k, v in tc.items()})


def _check_decode(arch, dtype, steps, long_mode=False):
    want, got, jc, tc = _teacher_forced(arch, dtype, steps, long_mode)
    assert set(tc) == set(jc)
    assert np.isfinite(got).all()
    atol = _logit_atol(dtype, want, _teacher_forced(arch, "f32", steps, long_mode)[0])
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if dtype == "bf16":
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * atol
        np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    exact = _teacher_forced(arch, "f32", steps, long_mode)[2]
    for name in tc:
        assert tc[name].shape == jc[name].shape, name
        atol = F32["atol"] if dtype == "f32" else _cache_atol(jc[name], exact[name])
        np.testing.assert_allclose(tc[name], jc[name], atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_matches_reference(arch, dtype):
    expect = {"dense": {"k", "v"}, "moe": {"k", "v"}, "ssm": {"conv", "h_ssm"},
              "hybrid": {"k", "v", "conv", "h_ssm"}}[jget(arch).family]
    assert set(_teacher_forced(arch, dtype, DECODE_STEPS)[3]) == expect
    _check_decode(arch, dtype, DECODE_STEPS)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_long_mode_decode_wraps_the_ring(dtype):
    """hymba-smoke in long mode past its 32-slot window: the ring of the KV
    cache wraps after position 31, and both packages' decode agree."""
    cfg = tconfigs.get_smoke("hymba-1.5b")
    assert cfg.long_window == 32 < LONG_STEPS
    assert _teacher_forced("hymba-1.5b", dtype, LONG_STEPS, True)[3]["k"].shape[2] == \
        cfg.long_window
    _check_decode("hymba-1.5b", dtype, LONG_STEPS, long_mode=True)


def test_engine_long_mode_equals_full_cache_before_the_wrap():
    """ServeEngine(long_mode=True) makes the same tokens as without long mode
    while the ring has not wrapped, and decodes past the window."""
    cfg = tconfigs.get_smoke("hymba-1.5b")
    params = _port_params("hymba-1.5b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    full = ServeEngine(cfg, params, max_len=25).generate(prompts, num_tokens=16)
    ring = ServeEngine(cfg, params, max_len=25, long_mode=True).generate(prompts, num_tokens=16)
    np.testing.assert_array_equal(ring, full)
    long = ServeEngine(cfg, params, max_len=49, long_mode=True)
    assert long._empty_cache(2)["k"].shape[2] == cfg.long_window
    out = long.generate(prompts[:1], num_tokens=40)
    assert out.shape == (1, 48) and ((out >= 0) & (out < cfg.vocab)).all()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "falcon-mamba-7b", "hymba-1.5b"])
def test_decode_matches_prefill(arch):
    """Greedy decode from an empty cache agrees with a fresh prefill at every
    prefix, bf16 (tests/test_models.py::test_decode_matches_prefill and its
    bounds, in the port; the MoE made drop-free, as there: capacity drops
    depend on the batch's shape)."""
    cfg = tconfigs.get_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    model = tbuild(cfg)
    params = _port_params(arch)
    t = 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, t))).long()
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in model.cache_specs(B, t + 1).items()}
    prefill, decode = tstep.make_prefill_step(cfg), tstep.make_decode_step(cfg)
    for pos in range(t):
        dec, cache = decode(params, cache, toks[:, pos:pos + 1], pos)
        ref, _ = prefill(params, {"tokens": toks[:, :pos + 1]})
        d, r = dec[:, 0].float().numpy(), ref[:, 0].float().numpy()
        assert np.abs(d - r).max() < 0.25 and (d.argmax(-1) == r.argmax(-1)).mean() >= 0.5, pos


# -- MoE routing, dispatch and capacity ------------------------------------------------------
def _router_inputs(arch: str, t: int = 48):
    cfg = jget(arch)
    x = np.random.default_rng(11).normal(size=(t, cfg.d_model)).astype(np.float32)
    router = _jax_params(arch)["blocks"]["moe"]["router"][0]
    return cfg, x, router


def test_routing_and_dispatch_match_reference():
    cfg, x, router = _router_inputs("qwen3-moe-30b-a3b")
    m = cfg.moe
    jidx, jw, jaux = jax.jit(JMoE._route, static_argnums=2)(x, router, m.top_k)
    idx, w, aux, _ = TMoE._route(torch.from_numpy(x), torch.from_numpy(router), m.top_k)
    dispatch = jax.jit(JMoE._dispatch_indices, static_argnums=(1, 2, 3, 4))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ROUTE_ATOL)
    assert float(aux) == pytest.approx(float(jaux), abs=ROUTE_ATOL)
    for capacity in (1, 3, TMoE.capacity_of(x.shape[0], cfg)):
        for lo, hi in ((0, m.num_experts), (2, 5)):
            jd, js = dispatch(jidx, m.num_experts, capacity, lo, hi)
            d, s = TMoE._dispatch_indices(idx, m.num_experts, capacity, lo, hi)
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_top_k_ties_keep_the_lower_expert_first():
    """Equal router probabilities: the lower expert id first, as jax.lax.top_k."""
    cfg = jget("qwen3-moe-30b-a3b")
    x = np.zeros((5, cfg.d_model), np.float32)  # every logit 0: all experts tie
    router = np.ones((cfg.d_model, cfg.moe.num_experts), np.float32)
    jidx, _, _ = jax.jit(JMoE._route, static_argnums=2)(x, router, cfg.moe.top_k)
    idx, _, _, _ = TMoE._route(torch.from_numpy(x), torch.from_numpy(router), cfg.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [list(range(cfg.moe.top_k))] * 5


def test_moe_capacity_drops_overflow():
    """capacity_factor 0.1 (tests/test_models.py's case): most assignments
    overflow and are dropped; the layer's output, drops included, equals the
    JAX package's, and the loss stays finite."""
    jcfg = jget("qwen3-moe-30b-a3b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.1))
    tcfg = tconfigs.get_smoke("qwen3-moe-30b-a3b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=0.1))
    layer = {k: v[0] for k, v in _jax_params("qwen3-moe-30b-a3b")["blocks"]["moe"].items()}
    x = np.random.default_rng(5).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    t = B * S
    capacity = TMoE.capacity_of(t, tcfg)
    assert capacity == jcfg.moe.top_k  # ceil(48 * 2 / 8 * 0.1) = 2 = top_k
    idx, _, _, _ = TMoE._route(torch.from_numpy(x.reshape(t, -1)),
                               torch.from_numpy(layer["router"]), tcfg.moe.top_k)
    dest, _ = TMoE._dispatch_indices(idx, tcfg.moe.num_experts, capacity, 0, tcfg.moe.num_experts)
    size = tcfg.moe.num_experts * capacity
    assert int((dest == size).sum()) > t  # most of the 96 assignments are dropped
    with compute("f32"):
        want, want_aux = jax.jit(lambda p, x: JMoE.apply_moe(p, x, jcfg, CTX))(layer, x)
        got, aux = TMoE.apply_moe({k: torch.from_numpy(v) for k, v in layer.items()},
                                  torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32["atol"])
    assert float(aux) == pytest.approx(float(want_aux), abs=ROUTE_ATOL)
    dropped = (dest == size).reshape(t, -1).all(-1).numpy()  # tokens with every choice dropped
    assert dropped.any() and np.all(got.numpy().reshape(t, -1)[dropped] == 0)
    model = tbuild(tcfg)
    loss, _ = model.loss(_port_params("qwen3-moe-30b-a3b"),
                         _port_batch(_batch("qwen3-moe-30b-a3b")))
    assert np.isfinite(float(loss))


def test_moe_expert_parallel_path_raises():
    cfg = tconfigs.get_smoke("qwen3-moe-30b-a3b")
    layer = {k: torch.from_numpy(v[0])
             for k, v in _jax_params("qwen3-moe-30b-a3b")["blocks"]["moe"].items()}

    class Mesh:
        shape = {"data": 1, "model": 2}

    # the path runs under sharding.MeshCtx (tests/test_torch_mesh.py); a context
    # without its collectives and a mesh set refuses it rather than run one rank's share
    ctx = TAxisCtx()
    ctx.mesh = Mesh()
    with pytest.raises(TypeError, match="needs a sharding.MeshCtx"):
        TMoE.apply_moe(layer, torch.zeros((1, 4, cfg.d_model)), cfg, ctx)
    with pytest.raises(TypeError, match="needs a sharding.MeshCtx"):  # through the model
        tbuild(cfg).loss(_port_params("qwen3-moe-30b-a3b"),
                         _port_batch(_batch("qwen3-moe-30b-a3b")), ctx)


# -- the selective scan ------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 7, 24, 33])
def test_associative_scan_matches_jax(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, s, 3, 4)).astype(np.float32)

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1))(a, b)
    ta, tb = TM.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=SCAN_RTOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=SCAN_RTOL, atol=1e-6)
    h, want = np.zeros_like(b[:, 0]), []  # the recurrence, step by step
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(tb.numpy(), np.stack(want, 1), rtol=1e-5, atol=1e-5)


def test_mamba_decode_matches_scan():
    """Token-by-token SSM recurrence == the full scan, in the port and
    against the JAX package's full scan (tests/test_models.py's case)."""
    cfg = jget("falcon-mamba-7b")
    layer = _numpy_init(JM.ssm_specs(cfg), np.random.default_rng(0))
    tlayer = {k: torch.from_numpy(v) for k, v in layer.items()}
    x = np.random.default_rng(0).normal(size=(2, 10, cfg.d_model)).astype(np.float32) * 0.3
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    full_j = np.asarray(jax.jit(lambda p, x: JM.apply_ssm(p, x, cfg, CTX))(layer, xj), np.float32)
    full = TM.apply_ssm(tlayer, xt, cfg)
    shapes = TM.init_ssm_cache_shape(cfg, 2)
    cache = {"conv": torch.zeros(shapes["conv"], dtype=torch.bfloat16),
             "h": torch.zeros(shapes["h"], dtype=torch.float32)}
    outs = []
    for t in range(10):
        y, cache = TM.apply_ssm_decode(tlayer, xt[:, t:t + 1], cache, cfg)
        outs.append(y)
    step = torch.cat(outs, dim=1).float().numpy()
    np.testing.assert_allclose(full.float().numpy(), step, **RECURRENCE)
    np.testing.assert_allclose(full.float().numpy(), full_j, atol=BF16["logit_atol"])
    assert cache["conv"].dtype == torch.bfloat16 and cache["h"].dtype == torch.float32


# -- the ring cache ------------------------------------------------------------------------------
def test_ring_cache_matches_windowed_attention():
    """Long-mode decode (ring KV cache, window W) equals full attention with a
    sliding-window mask at every position, past the wrap too
    (tests/test_models.py's case), in the port and against the JAX package."""
    T, W = 20, 8
    jcfg = dataclasses.replace(jget("granite-8b"), long_window=W, sub_quadratic=True)
    tcfg = dataclasses.replace(tconfigs.get_smoke("granite-8b"), long_window=W, sub_quadratic=True)
    layer = _numpy_init(JA.attn_specs(jcfg), np.random.default_rng(0))
    tlayer = {k: torch.from_numpy(v) for k, v in layer.items()}
    x = np.random.default_rng(0).normal(size=(2, T, jcfg.d_model)).astype(np.float32) * 0.3
    mask_j = JL.MaskSpec(causal=True, window=W)
    full_j = np.asarray(jax.jit(lambda p, x: JA.attn_full(p, x, jcfg, CTX, mask=mask_j))(
        layer, jnp.asarray(x, jnp.bfloat16)), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    full = TA.attn_full(tlayer, xt, tcfg, mask=TL.MaskSpec(causal=True, window=W)).float().numpy()
    shape = (2, W, tcfg.num_kv_heads, tcfg.head_dim_)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
             "v": torch.zeros(shape, dtype=torch.bfloat16)}
    outs = []
    for pos in range(T):
        o, cache = TA.attn_decode(tlayer, xt[:, pos:pos + 1], cache, pos, tcfg, window=W)
        outs.append(o)
    stepped = torch.cat(outs, dim=1).float().numpy()
    np.testing.assert_allclose(full, stepped, atol=0.08, rtol=0.05)
    np.testing.assert_allclose(full, full_j, atol=0.08, rtol=0.05)


# -- the stub frontend ------------------------------------------------------------------------------
def test_stub_embeddings_equal_the_reference_bytes():
    cfg = jget("phi-3-vision-4.2b")
    x = np.random.default_rng(2).integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    y = np.zeros_like(x)
    want = JTrainer.__new__(JTrainer)
    want.cfg = cfg
    ref = want._to_batch(x, y)
    assert set(ref) == {"embeddings", "labels"}
    trainer = Trainer(tconfigs.get_smoke("phi-3-vision-4.2b"), device="cpu")
    got = trainer._to_batch(x, y)
    assert set(got) == {"embeddings", "labels"}
    emb = got["embeddings"]
    assert emb.dtype == torch.float32 and emb.shape == ref["embeddings"].shape
    assert emb.numpy().tobytes() == np.ascontiguousarray(ref["embeddings"]).tobytes()
    assert torch.equal(stub_embeddings(torch.from_numpy(x).long(), cfg.d_model), emb)


def test_unused_table_gets_a_zero_gradient():
    """phi-3-vision's token table is read by decode only: its gradient is
    zero, as jax.grad gives it, and the train step runs."""
    arch = "phi-3-vision-4.2b"
    _, _, want = _jax_loss_and_grads(arch, "f32")
    assert not want["embed"].any()
    state = state_from_numpy(jax.tree.map(np.asarray, jopt.init_state(_jax_params(arch))),
                             device="cpu")
    new, metrics = tstep.make_train_step(tconfigs.get_smoke(arch))(
        state, _port_batch(_batch(arch)))
    assert np.isfinite(float(metrics["loss"])) and int(new["step"]) == 1
    assert not new["m"]["embed"].any() and not new["v"]["embed"].any()


# -- train-state checkpoints across packages ----------------------------------------------------------
def test_hymba_train_state_checkpoints_restore_across_packages(cluster):
    arch = "hymba-1.5b"
    jstate = jax.tree.map(np.asarray, jopt.init_state(_jax_params(arch)))
    jstate["step"] = np.int32(5)
    tstate = state_from_numpy(jstate, device="cpu")
    assert tck.serialize_pytree(tstate) == jck.serialize_pytree(jstate)

    def equal(a, b):
        fa, fb = flatten(a), flatten(b)
        return list(fa) == list(fb) and all(
            np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(fa.values(), fb.values()))

    rec = jck.CheckpointManager(cluster[3], num_host_shards=2).save(5, jstate)
    data = b"".join(r.data for r in cluster[3].get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    assert equal(tck.deserialize_pytree(data[: rec.total_bytes], tstate), tstate)
    _, _, _, client = build_cluster(device="cpu")
    trainer = Trainer(tconfigs.get_smoke(arch), device="cpu",
                      ckpt=tck.CheckpointManager(client, num_host_shards=2))
    state = trainer.init_state(seed=4)
    rec = trainer.ckpt.save(2, state)
    data = b"".join(r.data for r in client.get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    assert equal(jck.deserialize_pytree(data[: rec.total_bytes], jstate), state)
    restored, step = trainer.restore_latest(state)
    assert step == 2 and equal(restored, state)


# -- the launch entry points -----------------------------------------------------------------------
def test_launch_train_embedding_inputs_on_the_cpu(capsys):
    """phi-3-vision's stub embeddings through the blob pipeline, an SP crash,
    the restore and the repair (the card's families phase runs the same)."""
    losses = ttrain.main(["--arch", "phi-3-vision-4.2b", "--smoke", "--steps", "8",
                          "--fail-at", "5", "--ckpt-every", "2", "--seq", "32", "--device", "cpu"])
    assert len(losses) == 5 + 8 - 4 and all(np.isfinite(losses))
    text = capsys.readouterr().out
    assert "restarted from step 4 with SP 0 down" in text and "restored == saved: True" in text
    assert "repaired" in text and "UNRECOVERABLE" not in text


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "falcon-mamba-7b"])
def test_launch_train_runs_the_family(arch):
    run = ttrain.train(tconfigs.get_smoke(arch), steps=3, batch=2, seq=16, ckpt_every=2,
                       device="cpu")
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert int(run.state["step"]) == 3


def test_launch_serve_hymba_on_the_cpu(capsys):
    out = tserve.main(["--arch", "hymba-1.5b", "--smoke", "--batch", "2", "--prompt-len", "4",
                       "--gen", "6", "--device", "cpu", "--kill-sp"])
    assert out.shape == (2, 10)
    assert "restored+verified" in capsys.readouterr().out
