"""The port's encoder-decoder (whisper-tiny) and cross-attention held against
the JAX package, on the CPU at smoke widths.

Parameter and cache trees; cross-attention (``attn_full(kv_source=...,
rope=False)``, non-causal, Sq != Sk); ``EncDecLM.encode``, ``loss`` and every
gradient leaf, ``prefill`` (logits, ``k``/``v``, ``enc_out``) and the
teacher-forced ``decode_step``; the non-causal attention past the JAX
package's ``kv_chunk`` (ROADMAP Queue 3 item 3); ``ServeEngine.generate``
with frames; a ``Trainer`` step on the stub frontend's zero frames;
train-state checkpoints across packages; the ``launch`` entry points.
Weights are drawn with numpy from the JAX package's ParamSpecs by its init
rules (plus a seeded perturbation), carried into the port by
``params_from_numpy``; frames and tokens are seeded numpy arrays handed to
both.  At smoke widths the encoder's 32 frames lie below the JAX package's
``kv_chunk`` of 1024, where its non-causal attention is right.

Tolerances:
* f32 compute in both packages (their ``COMPUTE_DTYPE`` patched to f32):
  the same algorithm up to summation order.  Cross-attention and the
  encoder's output atol 1e-4; loss atol 1e-5; each gradient leaf within
  1e-3 of its own largest entry (tests/test_torch_families.py's bounds),
  but cross-attention's key bias: its gradient is zero (without RoPE,
  q . bk is added to every score of a row, which the softmax ignores), so
  both packages' are rounding noise, held within ``ZERO_GRAD_ATOL`` = 1e-6
  of zero (observed <= 5e-8); prefill and decode logits and caches atol 1e-4 (over 6 decode
  positions).
* bf16 compute, as configured (tests/test_torch_families.py's bounds):
  loss atol 0.02; gradients at the initial weights within three times the
  JAX package's own bf16 error plus 0.01 of their norm, leaf by leaf;
  logits within 0.15 plus the JAX package's own bf16 error on them; caches
  within 2^-4 of their largest entry plus that error; greedy tokens equal
  where the reference's top-2 margin exceeds twice the logit bound.  The
  engine's greedy tokens are not compared across packages: the perturbed
  smoke model's own bf16 error reaches 1.4 on logits near 2 in the JAX
  package, so near-ties abound; its steps' logits are.
* Queue 3 item 3 (Sk = 1100 > kv_chunk = 1024, one encoder layer, f32,
  inputs scaled by 0.1 so that scores lie near 0): equal within 1e-4 with
  the JAX package's ``kv_chunk`` set to Sk (observed 1.8e-7), and apart by
  more than 1e-2 with its default (observed 0.14: the 948 zero keys of the
  padded chunk take almost half of every row's softmax).
"""
import contextlib
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
from repro_torch.models.model import EncDecLM, build as tbuild
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import flatten, params_from_numpy, state_from_numpy
from repro_torch.storage import checkpoint as tck
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer

ARCH = "whisper-tiny"
B, S = 2, 12
DECODE_STEPS = 6
F32 = dict(loss_atol=1e-5, grad_rel_max=1e-3, atol=1e-4)
BF16 = dict(loss_atol=0.02, grad_noise_factor=3.0, grad_floor=0.01, logit_atol=0.15,
            cache_rel_max=2**-4)
KV_CHUNK = 1024  # the JAX package's default in models/layers.py::flash_attention
LONG_SK = 1100
ZERO_GRAD_ATOL = 1e-6
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
def _batch(seed: int = 3):
    rng = np.random.default_rng(seed)
    cfg = jget(ARCH)
    return {"frames": rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


# -- parameter and cache trees ------------------------------------------------------------
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_reference(size):
    jcfg = jget(ARCH) if size == "smoke" else jget_full(ARCH)
    tcfg = tconfigs.get_smoke(ARCH) if size == "smoke" else tconfigs.get(ARCH)
    model = tbuild(tcfg)
    assert isinstance(model, EncDecLM) and tcfg.is_encdec
    jspecs = jax.tree_util.tree_flatten_with_path(
        jbuild(jcfg).param_specs(), is_leaf=lambda x: isinstance(x, JParamSpec))[0]
    tspecs = model.param_specs()
    assert list(tspecs) == [".".join(k.key for k in path) for path, _ in jspecs]
    for (_, j), t in zip(jspecs, tspecs.values()):
        assert (t.shape, t.axes, t.init, t.scale) == (j.shape, j.axes, j.init, j.scale)
    assert model.param_count() == jcfg.param_count()
    if size == "full":
        assert model.param_count() == 56_477_184  # served whole from Shelby on the card
    for cache_len in (25, 448):
        cj = jbuild(jcfg).cache_specs(4, cache_len)
        ct = model.cache_specs(4, cache_len)
        assert set(ct) == {"k", "v", "enc_out"}
        assert {k: (s.shape, s.axes, s.init) for k, s in ct.items()} == \
            {k: (s.shape, s.axes, s.init) for k, s in cj.items()}
        assert {k: str(s.dtype).split(".")[-1] for k, s in ct.items()} == \
            {k: np.dtype(s.dtype).name for k, s in cj.items()}


# -- cross-attention ----------------------------------------------------------------------------
def test_cross_attention_matches_reference():
    """``attn_full`` with ``kv_source`` (Sq 12, Sk 32), non-causal, no RoPE,
    with biases, f32."""
    cfg, tcfg = jget(ARCH), tconfigs.get_smoke(ARCH)
    layer = {k: v[0] for k, v in _jax_params()["dec_blocks"]["cross_attn"].items()}
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    with compute("f32"):
        want = jax.jit(lambda p, x, e: JA.attn_full(
            p, x, cfg, CTX, mask=JL.MaskSpec(causal=False), rope=False, kv_source=e))(
            layer, x, enc)
        got = TA.attn_full({k: torch.from_numpy(v) for k, v in layer.items()},
                           torch.from_numpy(x), tcfg, mask=TL.MaskSpec(causal=False),
                           rope=False, kv_source=torch.from_numpy(enc))
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32["atol"])


@functools.cache
def _jitted(kind: str, dtype: str):
    model = jbuild(jget(ARCH))
    if kind == "loss":
        return _compiled(jax.value_and_grad(lambda p, b: model.loss(p, b, CTX), has_aux=True))
    if kind == "encode":
        return _compiled(lambda p, f: model.encode(p, f, CTX))
    if kind == "prefill":
        return _compiled(lambda p, b: model.prefill(p, b, CTX))
    return _compiled(lambda p, c, t, pos: model.decode_step(p, c, t, pos, CTX))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_matches_reference(dtype):
    frames = _batch()["frames"]
    with compute(dtype):
        want = np.asarray(_jitted("encode", dtype)(_jax_params(), frames), np.float32)
        got = tbuild(tconfigs.get_smoke(ARCH)).encode(_port_params(), torch.from_numpy(frames))
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32["atol"])
        return
    with compute("f32"):
        exact = np.asarray(_jitted("encode", "f32")(_jax_params(), frames), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=_cache_atol(want, exact))


# -- loss and gradients -------------------------------------------------------------------------
@functools.cache
def _jax_loss_and_grads(dtype: str, perturbed: bool = True):
    with compute(dtype):
        (loss, _), grads = _jitted("loss", dtype)(_jax_params(perturbed), _batch())
    return float(loss), flatten(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(dtype: str, perturbed: bool = True):
    model = tbuild(tconfigs.get_smoke(ARCH))
    params = {k: p.requires_grad_(True) for k, p in _port_params(perturbed).items()}
    with compute(dtype):
        loss, metrics = model.loss(params, _port_batch(_batch()))
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    assert float(metrics["aux"]) == 0.0
    return float(loss.detach()), dict(zip(params, grads))


def test_loss_and_grads_f32():
    want_loss, want = _jax_loss_and_grads("f32")
    loss, got = _port_loss_and_grads("f32")
    assert abs(loss - want_loss) <= F32["loss_atol"]
    assert list(got) == list(want)
    for name, g in got.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[name].shape, name
        if name == "dec_blocks.cross_attn.bk":  # zero: the softmax ignores a per-row constant
            assert float(np.abs(want[name]).max()) <= ZERO_GRAD_ATOL, name
            assert float(g.abs().max()) <= ZERO_GRAD_ATOL, name
            continue
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= F32["grad_rel_max"] * float(np.abs(want[name]).max()), (name, err)
    assert np.abs(want["enc_blocks.attn.wq"]).max() > 0  # the encoder learns through cross-attn


def test_loss_and_grads_bf16():
    want_loss, want = _jax_loss_and_grads("bf16", perturbed=False)
    _, exact = _jax_loss_and_grads("f32", perturbed=False)
    loss, got = _port_loss_and_grads("bf16", perturbed=False)
    assert np.isfinite(loss) and abs(loss - want_loss) <= BF16["loss_atol"]
    for name, g in got.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        noise = float(np.linalg.norm(want[name] - exact[name]))
        err = float(np.linalg.norm(g.numpy() - want[name]))
        bound = BF16["grad_noise_factor"] * noise + BF16["grad_floor"] * np.linalg.norm(exact[name])
        assert err <= bound, (name, err, noise)


# -- prefill and decode -------------------------------------------------------------------------
def _logit_atol(dtype: str, want_bf16: np.ndarray, want_f32: np.ndarray) -> float:
    if dtype == "f32":
        return F32["atol"]
    return BF16["logit_atol"] + float(np.abs(want_bf16 - want_f32).max())


def _cache_atol(want_bf16: np.ndarray, want_f32: np.ndarray) -> float:
    return (BF16["cache_rel_max"] * float(np.abs(want_bf16).max())
            + float(np.abs(want_bf16 - want_f32).max()))


@functools.cache
def _jax_prefill(dtype: str):
    with compute(dtype):
        logits, cache = _jitted("prefill", dtype)(_jax_params(), {"frames": _batch()["frames"]})
    return (np.asarray(logits, np.float32)[..., :jget(ARCH).vocab],
            {k: np.asarray(v, np.float32) for k, v in cache.items()})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_reference(dtype):
    cfg = jget(ARCH)
    want_logits, want_cache = _jax_prefill(dtype)
    with compute(dtype):
        logits, cache = tstep.make_prefill_step(tconfigs.get_smoke(ARCH))(
            _port_params(), {"frames": torch.from_numpy(_batch()["frames"])})
    assert set(cache) == set(want_cache) == {"k", "v", "enc_out"}
    assert logits.shape == (B, 1, cfg.padded_vocab)
    atol = _logit_atol(dtype, want_logits, _jax_prefill("f32")[0])
    np.testing.assert_allclose(logits.float().numpy()[..., :cfg.vocab], want_logits, atol=atol)
    for name, c in cache.items():
        assert tuple(c.shape) == want_cache[name].shape, name
        atol = F32["atol"] if dtype == "f32" else \
            _cache_atol(want_cache[name], _jax_prefill("f32")[1][name])
        np.testing.assert_allclose(c.float().numpy(), want_cache[name], atol=atol, err_msg=name)


@functools.cache
def _teacher_forced(dtype: str, steps: int = DECODE_STEPS):
    """Both packages' decode steps over the same tokens from empty ``k``/``v``
    and the same ``enc_out`` (the JAX package's encoding of the frames, in
    the caches' dtype): (jax logits, port logits, jax cache, port cache)."""
    jcfg, tcfg = jget(ARCH), tconfigs.get_smoke(ARCH)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp, tp = _jax_params(), _port_params()
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, steps)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    with compute(dtype):
        enc = np.asarray(_jitted("encode", dtype)(jp, _batch()["frames"]), np.float32)
    jc = {k: jnp.zeros(s.shape, jdt) for k, s in jm.cache_specs(B, steps + 1).items()}
    tc = {k: torch.zeros(s.shape, dtype=tdt) for k, s in tm.cache_specs(B, steps + 1).items()}
    jc["enc_out"], tc["enc_out"] = jnp.asarray(enc, jdt), torch.tensor(enc).to(tdt)
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
    assert set(tc) == set(jc) == {"k", "v", "enc_out"}
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
        atol = F32["atol"] if dtype == "f32" else _cache_atol(jc[name], exact[name])
        np.testing.assert_allclose(tc[name], jc[name], atol=atol, rtol=0, err_msg=name)


# -- ROADMAP Queue 3 item 3: non-causal attention past kv_chunk -------------------------------
def test_noncausal_past_kv_chunk_equals_reference_only_at_kv_chunk_sk(monkeypatch):
    """The JAX package's chunked attention pads Sk = 1100 to two chunks of
    1024 and lets the 948 zero keys of the last chunk into a non-causal
    softmax; the port's kernel leaves keys past Sk out.  One encoder layer
    (whisper-smoke's, f32) equals the reference's with ``kv_chunk = Sk``
    and differs from it with the default."""
    cfg, tcfg = jget(ARCH), tconfigs.get_smoke(ARCH)
    layer = {k: v[0] for k, v in _jax_params()["enc_blocks"]["attn"].items()}
    x = 0.1 * np.random.default_rng(9).normal(size=(1, LONG_SK, cfg.d_model)).astype(np.float32)
    assert LONG_SK % KV_CHUNK
    mask = JL.MaskSpec(causal=False)

    def ref():  # traced anew at each call: it reads the patched function
        return np.asarray(jax.jit(lambda p, x: JA.attn_full(p, x, cfg, CTX, mask=mask))(layer, x))

    with compute("f32"):
        default = ref()
        monkeypatch.setattr(JA, "flash_attention",
                            functools.partial(JL.flash_attention, kv_chunk=LONG_SK))
        fixed = ref()
        got = TA.attn_full({k: torch.from_numpy(v) for k, v in layer.items()},
                           torch.from_numpy(x), tcfg, mask=TL.MaskSpec(causal=False)).numpy()
    np.testing.assert_allclose(got, fixed, atol=F32["atol"])
    assert np.abs(got - default).max() > 1e-2


# -- the engine, the trainer, checkpoints and the entry points --------------------------------
def _engine_flow(dtype: str, toks: np.ndarray, frames: np.ndarray):
    """Each package's serving flow teacher-forced on ``toks``: the frames
    encoded by its own ``encode`` into ``enc_out`` (in the caches' dtype),
    then its decode steps from empty ``k``/``v`` of ``DECODE_STEPS + 1``
    slots (the compiled step's shapes): (jax logits, port logits), (steps,
    B, vocab)."""
    jcfg, tcfg = jget(ARCH), tconfigs.get_smoke(ARCH)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp, tp = _jax_params(), _port_params()
    b, steps = toks.shape
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jc = {k: jnp.zeros(s.shape, jdt) for k, s in jm.cache_specs(b, DECODE_STEPS + 1).items()}
    tc = {k: torch.zeros(s.shape, dtype=tdt) for k, s in tm.cache_specs(b, DECODE_STEPS + 1).items()}
    step, tstep_fn = _jitted("decode", dtype), tstep.make_decode_step(tcfg)
    jl, tl = [], []
    with compute(dtype):
        jc["enc_out"] = _jitted("encode", dtype)(jp, frames).astype(jdt)
        tc["enc_out"] = tm.encode(tp, torch.from_numpy(frames)).to(tdt)
        for pos in range(steps):
            a, jc = step(jp, jc, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
            t, tc = tstep_fn(tp, tc, torch.from_numpy(toks[:, pos:pos + 1]).long(), pos)
            jl.append(np.asarray(a, np.float32)[:, 0, :jcfg.vocab])
            tl.append(t.float().numpy()[:, 0, :jcfg.vocab])
    return np.stack(jl), np.stack(tl)


def test_engine_generate_with_frames_round_trip():
    """``ServeEngine.generate(prompts, n, frames=)`` encodes the frames into
    ``enc_out`` and decodes greedily: its output starts with the prompts and
    each generated token is the argmax of the port's decode step
    teacher-forced on the output, whose logits lie within the bf16 bound of
    the JAX package's serving flow on the same tokens and frames; without
    frames it raises."""
    cfg = tconfigs.get_smoke(ARCH)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab, (B, 2)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    engine = ServeEngine(cfg, _port_params(), max_len=8)
    out = engine.generate(prompts, num_tokens=DECODE_STEPS - 1, frames=frames)
    assert out.shape == (B, DECODE_STEPS + 1) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, :2], prompts)
    want, got = _engine_flow("bf16", out[:, :-1], frames)
    np.testing.assert_array_equal(got[1:].argmax(-1).T, out[:, 2:])
    atol = _logit_atol("bf16", want, _engine_flow("f32", out[:, :-1], frames)[0])
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    with pytest.raises(ValueError, match="frames"):
        engine.generate(prompts, num_tokens=2)


def test_trainer_step_on_zero_frames_matches_reference():
    """``Trainer._to_batch`` gives an encoder-decoder zero frames (B,
    enc_seq, d_model), as the JAX package's does (before the embeddings
    branch: whisper's inputs are "embeddings"); one ``Trainer.run`` step from
    the reference's train state has the reference's loss (bf16)."""
    jcfg, tcfg = jget(ARCH), tconfigs.get_smoke(ARCH)
    assert tcfg.input_mode == "embeddings"
    rng = np.random.default_rng(12)
    x = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jtrainer = JTrainer.__new__(JTrainer)
    jtrainer.cfg = jcfg
    ref = jtrainer._to_batch(x, y)
    trainer = Trainer(tcfg, device="cpu")
    got = trainer._to_batch(x, y)
    assert set(got) == set(ref) == {"frames", "tokens", "labels"}
    assert got["frames"].dtype == torch.float32 and not got["frames"].any()
    assert tuple(got["frames"].shape) == ref["frames"].shape == (B, jcfg.enc_seq, jcfg.d_model)
    (want_loss, _), _ = _jitted("loss", "bf16")(_jax_params(perturbed=False), ref)
    jstate = jax.tree.map(np.asarray, jopt.init_state(_jax_params(perturbed=False)))
    state, report = trainer.run(state_from_numpy(jstate, device="cpu"), iter([(x, y)]), 1)
    assert int(state["step"]) == 1 and len(report.losses) == 1
    assert abs(report.losses[0] - float(want_loss)) <= BF16["loss_atol"]


def test_train_state_checkpoints_restore_across_packages(cluster):
    jstate = jax.tree.map(np.asarray, jopt.init_state(_jax_params()))
    jstate["step"] = np.int32(2)
    tstate = state_from_numpy(jstate, device="cpu")
    assert tck.serialize_pytree(tstate) == jck.serialize_pytree(jstate)
    rec = jck.CheckpointManager(cluster[3], num_host_shards=2).save(2, jstate)
    data = b"".join(r.data for r in cluster[3].get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    restored = tck.deserialize_pytree(data[: rec.total_bytes], tstate)
    assert all(torch.equal(a, b) for a, b in zip(flatten(restored).values(),
                                                 flatten(tstate).values()))
    _, _, _, client = build_cluster(device="cpu")
    trainer = Trainer(tconfigs.get_smoke(ARCH), device="cpu",
                      ckpt=tck.CheckpointManager(client, num_host_shards=2))
    state = trainer.init_state(seed=4)
    rec = trainer.ckpt.save(1, state)
    data = b"".join(r.data for r in client.get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    back = flatten(jck.deserialize_pytree(data[: rec.total_bytes], jstate))
    assert list(back) == list(flatten(state))
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(back.values(), flatten(state).values()))


def test_launch_train_runs_encdec():
    run = ttrain.train(tconfigs.get_smoke(ARCH), steps=3, batch=2, seq=16, ckpt_every=2,
                       device="cpu")
    assert len(run.losses) == 3 and all(np.isfinite(run.losses))
    assert int(run.state["step"]) == 3


def test_launch_serve_encdec_on_the_cpu(capsys):
    """The port's CLI serves whisper over seeded stub frames (the JAX
    package's passes none and fails: ROADMAP Queue 3 item 7)."""
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "4",
                       "--gen", "6", "--device", "cpu", "--kill-sp"])
    assert out.shape == (2, 10)
    assert "restored+verified" in capsys.readouterr().out
