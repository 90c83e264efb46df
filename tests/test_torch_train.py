"""The port's training path held against the JAX package, on the CPU at smoke size.

The dense decoder's loss and parameter gradients (``DecoderLM.loss`` under
autograd, attention's backward the plain version here), prefill (last
logits and the KV cache), AdamW, the microbatched train step, train-state
checkpoints across packages and the ``launch/train.py`` driver.  Weights are
the JAX package's (``init_params`` from a PRNG key plus a seeded numpy
perturbation), carried into the port by ``params_from_numpy``; tokens are
seeded numpy arrays handed to both.

Tolerances:
* f32 compute in both packages (their ``COMPUTE_DTYPE`` patched to f32):
  the same algorithm up to summation order.  Loss atol 1e-5 (a mean
  cross-entropy near 5.5; observed <= 1e-6); each gradient leaf within 1e-3
  of its own largest entry, max |g - g_ref| <= 1e-3 max |g_ref| (observed
  <= 1.2e-4: rounding compounded through the softmax and cross-entropy
  backward, where terms cancel); prefill logits and cache atol 1e-4.  The
  train step's moments (m = 0.1 g, v = 0.05 g^2 after one step) within 1e-3
  of each leaf's largest entry, as the gradients; its new parameters within
  1e-6, but for at most 0.2% of each leaf's entries, which must lie within
  lr = 3e-4: Adam's first step divides each gradient entry by its own
  magnitude, g / (|g| + 1e-8), which rounding sets for entries with |g|
  near 1e-8 (observed: at most 10 of 16,384 entries, by <= 3.4e-5).
* bf16 compute, as configured: both packages round products and
  activations to bf16 (8 significant bits) at different places (PyTorch
  rounds after every eager op; XLA keeps fused elementwise chains in f32;
  the JAX layers round attention scores and probabilities).  Loss atol
  0.02 (observed <= 0.0023).  Gradients: these two-layer, 64-wide models
  amplify rounding, so that the JAX package's own bf16 gradients lie
  10-70% (relative norm, leaf by leaf) from its f32 ones; each leaf of the
  port's must lie within three times that distance of the reference's
  bf16 gradient, ||g - g_bf16|| <= 3 ||g_bf16 - g_f32|| + 0.01 ||g_f32||
  (observed <= 2.0 times).  They are compared at the initial weights, the
  state training starts from: with the perturbed weights attention scores
  reach ~80, the softmax is one-hot to bf16 precision and a score's
  rounding moves the q/k gradients by O(1) in either package.  Prefill
  logits atol 0.15 (as the decode step's in tests/test_torch_serve.py),
  the cache (entries up to ~22) within 2^-4 of its largest entry
  (observed <= 3.8%: a few bf16 steps, compounded over the first layer).
* AdamW from equal gradients, f32: atol 5e-7 on parameters up to ~3 (the
  ops are the reference's, in its order: only the rounding of XLA's fused
  products differs; observed 1.2e-7, 4 units in the last place).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro.sharding import AxisCtx, init_params as jinit
from repro.storage import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.launch.cluster import build_cluster
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import build as tbuild
from repro_torch.sharding import AxisCtx as TAxisCtx, flatten, params_from_numpy, state_from_numpy
from repro_torch.storage import checkpoint as tck
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

DENSE = ["yi-9b", "granite-8b", "starcoder2-3b", "command-r-plus-104b"]
B, S = 2, 24
F32 = dict(loss_atol=1e-5, grad_rel_max=1e-3, prefill_atol=1e-4)
BF16 = dict(loss_atol=0.02, grad_noise_factor=3.0, grad_floor=0.01, prefill_atol=0.15,
            cache_rel_max=2**-4)
STEP = dict(param_atol=1e-6, param_outliers=2e-3, lr=3e-4, moment_rel_max=1e-3)
ADAMW_ATOL = 5e-7


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


@functools.cache
def _jax_params(arch: str, perturbed: bool = True, seed: int = 1):
    """The JAX package's initial weights, plus (``perturbed``) seeded noise
    so that norms and biases are not trivial."""
    params = jax.tree.map(np.asarray, jinit(jbuild(jget(arch)).param_specs(),
                                            jax.random.PRNGKey(seed)))
    if not perturbed:
        return params
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)


def _batch(arch: str, b: int = B, s: int = S, seed: int = 3):
    rng = np.random.default_rng(seed)
    vocab = jget(arch).vocab
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@functools.cache
def _jax_loss_and_grads(arch: str, dtype: str, perturbed: bool = True):
    model = jbuild(jget(arch))
    with compute(dtype):
        fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, AxisCtx()), has_aux=True))
        (loss, _), grads = fn(_jax_params(arch, perturbed), _batch(arch))
    return float(loss), flatten(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(arch: str, dtype: str, perturbed: bool = True):
    model = tbuild(tconfigs.get_smoke(arch))
    params = {k: p.requires_grad_(True)
              for k, p in params_from_numpy(_jax_params(arch, perturbed), device="cpu").items()}
    with compute(dtype):
        loss, metrics = model.loss(params, _port_batch(_batch(arch)))
        grads = torch.autograd.grad(loss, list(params.values()))
    assert torch.equal(metrics["xent"], loss) and float(metrics["aux"]) == 0.0
    return float(loss.detach()), dict(zip(params, grads))


# -- loss and gradients ------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_f32(arch):
    want_loss, want = _jax_loss_and_grads(arch, "f32")
    loss, got = _port_loss_and_grads(arch, "f32")
    assert abs(loss - want_loss) <= F32["loss_atol"]
    assert list(got) == list(want)
    for name, g in got.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[name].shape, name
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= F32["grad_rel_max"] * float(np.abs(want[name]).max()), (name, err)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_bf16(arch):
    want_loss, want = _jax_loss_and_grads(arch, "bf16", perturbed=False)
    _, exact = _jax_loss_and_grads(arch, "f32", perturbed=False)
    loss, got = _port_loss_and_grads(arch, "bf16", perturbed=False)
    assert np.isfinite(loss) and abs(loss - want_loss) <= BF16["loss_atol"]
    for name, g in got.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        noise = float(np.linalg.norm(want[name] - exact[name]))  # the reference's own bf16 error
        err = float(np.linalg.norm(g.numpy() - want[name]))
        bound = BF16["grad_noise_factor"] * noise + BF16["grad_floor"] * np.linalg.norm(exact[name])
        assert err <= bound, (name, err, noise)


def test_layers_are_recomputed_in_the_backward_pass():
    """Each layer runs under ``torch.utils.checkpoint`` when autograd records
    (the JAX package's per-layer ``jax.checkpoint``): the layer's forward
    runs again during the backward pass, and not without a gradient."""
    cfg = tconfigs.get_smoke("granite-8b")
    model = tbuild(cfg)
    params = {k: p.requires_grad_(True)
              for k, p in params_from_numpy(_jax_params("granite-8b"), device="cpu").items()}
    calls = []
    real = TA.attn_full

    def counting(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*a, **kw)

    batch = _port_batch(_batch("granite-8b"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TA, "attn_full", counting)
        loss, _ = model.loss(params, batch)
        assert len(calls) == cfg.num_layers
        loss.backward()
        assert len(calls) == 2 * cfg.num_layers
        with torch.no_grad():
            model.loss(params, batch)
        assert len(calls) == 3 * cfg.num_layers


# -- prefill -------------------------------------------------------------------------------
@functools.cache
def _jax_prefill(arch: str, dtype: str):
    model = jbuild(jget(arch))
    with compute(dtype):
        logits, cache = jax.jit(lambda p, b: model.prefill(p, b, AxisCtx()))(
            _jax_params(arch), {"tokens": _batch(arch)["tokens"]})
    return np.asarray(logits, np.float32), {k: np.asarray(v, np.float32) for k, v in cache.items()}


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_reference(arch, dtype):
    want_logits, want_cache = _jax_prefill(arch, dtype)
    step = tstep.make_prefill_step(tconfigs.get_smoke(arch))
    with compute(dtype):
        logits, cache = step(params_from_numpy(_jax_params(arch), device="cpu"),
                             {"tokens": torch.from_numpy(_batch(arch)["tokens"]).long()})
    cfg = jget(arch)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in want_cache.items()}
    atol = F32["prefill_atol"] if dtype == "f32" else BF16["prefill_atol"]
    v = cfg.vocab
    np.testing.assert_allclose(logits.float().numpy()[..., :v], want_logits[..., :v], atol=atol)
    for name, c in cache.items():
        if dtype == "bf16":
            atol = BF16["cache_rel_max"] * float(np.abs(want_cache[name]).max())
        np.testing.assert_allclose(c.float().numpy(), want_cache[name], atol=atol, err_msg=name)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """Greedy decode from an empty cache agrees with a fresh prefill at every
    prefix (tests/test_models.py::test_decode_matches_prefill, in the port)."""
    cfg = tconfigs.get_smoke(arch)
    model = tbuild(cfg)
    params = params_from_numpy(_jax_params(arch), device="cpu")
    t = 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, t))).long()
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in model.cache_specs(B, t + 1).items()}
    prefill = tstep.make_prefill_step(cfg)
    decode = tstep.make_decode_step(cfg)
    for pos in range(t):
        dec, cache = decode(params, cache, toks[:, pos:pos + 1], pos)
        ref, _ = prefill(params, {"tokens": toks[:, :pos + 1]})
        d, r = dec[:, 0].float().numpy(), ref[:, 0].float().numpy()
        assert np.abs(d - r).max() < 0.25 and (d.argmax(-1) == r.argmax(-1)).mean() >= 0.5, pos


# -- AdamW and the train step ----------------------------------------------------------------
def _numpy_state(arch: str):
    return jax.tree.map(np.asarray, jopt.init_state(_jax_params(arch)))


def test_adamw_update_and_schedule_match_reference():
    cfg = jopt.AdamWConfig(warmup_steps=3)
    tcfg = topt.AdamWConfig(warmup_steps=3)
    rng = np.random.default_rng(5)
    jstate = _numpy_state("starcoder2-3b")
    tstate = state_from_numpy(jstate, device="cpu")
    assert tstate["step"].dtype == torch.int32 and tstate["step"].shape == ()
    update = jax.jit(lambda s, g: jopt.update(s, g, cfg))
    for it in range(4):  # warmup, then the full rate; the third step's gradients are clipped
        scale = 30.0 if it == 2 else 0.01
        grads = jax.tree.map(lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32),
                             jstate["params"])
        jstate, jm = update(jstate, grads)
        jstate = jax.tree.map(np.asarray, jstate)
        tstate, tm = topt.update(tstate, params_from_numpy(grads, device="cpu"), tcfg)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        want = flatten(jstate)
        got = flatten(tstate)
        assert list(got) == list(want)
        for name, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[name], atol=ADAMW_ATOL, rtol=0,
                                       err_msg=f"step {it + 1}: {name}")
    for step in range(6):
        assert float(topt._schedule(tcfg, torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(jopt._schedule(cfg, jnp.int32(step))), rel=1e-7)


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_train_step_matches_reference(num_microbatches):
    arch = "granite-8b"
    batch = _batch(arch, b=4)
    jcfg = jopt.AdamWConfig(warmup_steps=1)
    with compute("f32"):
        jfn = jax.jit(jmake_train_step(jget(arch), AxisCtx(), jcfg, num_microbatches))
        jstate, jm = jfn(_numpy_state(arch), batch)
        tfn = tstep.make_train_step(tconfigs.get_smoke(arch), None,
                                    topt.AdamWConfig(warmup_steps=1), num_microbatches)
        tstate, tm = tfn(state_from_numpy(_numpy_state(arch), device="cpu"), _port_batch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=F32["loss_atol"])
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-3)
    assert int(tstate["step"]) == 1
    want = flatten(jax.tree.map(np.asarray, jstate))
    for name, t in flatten(tstate).items():
        err = np.abs(t.numpy() - want[name])
        if name.startswith(("m.", "v.")):
            assert err.max() <= STEP["moment_rel_max"] * np.abs(want[name]).max(), name
        elif name.startswith("params."):
            assert err.max() <= STEP["lr"], name
            assert (err > STEP["param_atol"]).mean() <= STEP["param_outliers"], name
        else:
            assert err.max() == 0, name
    leaf = next(iter(tstate["params"]))
    assert not torch.equal(tstate["params"][leaf],
                           state_from_numpy(_numpy_state(arch), device="cpu")["params"][leaf])


def test_microbatches_average_the_gradients():
    """Two microbatches of the same examples step exactly as one batch of them
    would up to rounding: the gradients are averaged, not summed."""
    arch = "yi-9b"
    half = _batch(arch, b=2)
    doubled = {k: np.concatenate([v, v]) for k, v in half.items()}
    state = state_from_numpy(_numpy_state(arch), device="cpu")
    cfg = tconfigs.get_smoke(arch)
    with compute("f32"):
        a, ma = tstep.make_train_step(cfg)(state, _port_batch(half))
        b, mb = tstep.make_train_step(cfg, num_microbatches=2)(state, _port_batch(doubled))
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), abs=1e-6)
    for name, t in flatten(a).items():
        torch.testing.assert_close(flatten(b)[name], t, atol=1e-6, rtol=0)


def test_unported_options_raise():
    cfg = tconfigs.get_smoke("granite-8b")
    tstep.make_decode_step(cfg, long_mode=True)  # long mode is ported
    mesh_ctx = TAxisCtx()  # a mesh without MeshCtx's collectives (tests/test_torch_mesh.py)
    mesh_ctx.mesh = object()
    with pytest.raises(TypeError, match="needs a sharding.MeshCtx"):
        tstep.make_train_step(cfg, mesh_ctx, shard_grad_accum=True)
    tstep.make_train_step(cfg, TAxisCtx(), shard_grad_accum=True)  # no mesh: nothing to shard
    p = params_from_numpy(_jax_params("granite-8b"), device="cpu")
    layer0 = {k.split(".", 2)[2]: v[0] for k, v in p.items() if k.startswith("blocks.attn.")}
    x = torch.zeros((1, 4, cfg.d_model))
    x16, enc = x.bfloat16(), torch.zeros((1, 9, cfg.d_model), dtype=torch.bfloat16)
    assert TA.attn_full(layer0, x16, cfg, kv_source=enc, rope=False).shape == x.shape  # ported
    import dataclasses

    tbuild(dataclasses.replace(cfg, use_qk_norm=True))  # qwen3's qk-norm is ported
    tbuild(tconfigs.get_smoke("deepseek-v2-lite-16b"))  # and MLA with its leading dense layer
    from repro_torch.models import moe as TMoE

    moe_cfg = tconfigs.get_smoke("qwen3-moe-30b-a3b")
    moe_layer = {k.split(".", 2)[2]: torch.zeros(v.shape[1:])
                 for k, v in tbuild(moe_cfg).param_specs().items() if k.startswith("blocks.moe.")}
    ep_ctx = TAxisCtx()
    ep_ctx.mesh = type("Mesh", (), {"shape": {"data": 1, "model": 2}})()
    with pytest.raises(TypeError, match="needs a sharding.MeshCtx"):
        TMoE.apply_moe(moe_layer, torch.zeros((1, 2, moe_cfg.d_model)), moe_cfg, ep_ctx)


# -- train-state checkpoints across packages --------------------------------------------------
def test_train_state_checkpoints_restore_across_packages(cluster):
    jstate = _numpy_state("starcoder2-3b")
    jstate["step"] = np.int32(7)
    tstate = state_from_numpy(jstate, device="cpu")
    assert tck.serialize_pytree(tstate) == jck.serialize_pytree(jstate)

    def equal(a, b):
        fa, fb = flatten(a), flatten(b)
        return list(fa) == list(fb) and all(
            np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(fa.values(), fb.values()))

    # the JAX package writes through its Shelby deployment; the port restores the bytes
    rec = jck.CheckpointManager(cluster[3], num_host_shards=2).save(7, jstate)
    data = b"".join(r.data for r in cluster[3].get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    assert equal(tck.deserialize_pytree(data[: rec.total_bytes], tstate), tstate)
    # the port's trainer writes through its own; the JAX package restores the bytes
    _, _, _, client = build_cluster(device="cpu")
    trainer = ttrain.Trainer(tconfigs.get_smoke("starcoder2-3b"), device="cpu",
                             ckpt=tck.CheckpointManager(client, num_host_shards=2))
    state = trainer.init_state(seed=4)
    rec = trainer.ckpt.save(2, state)
    data = b"".join(r.data for r in client.get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    back = jck.deserialize_pytree(data[: rec.total_bytes], jstate)
    assert equal(back, state)
    restored, step = trainer.restore_latest(state)
    assert step == 2 and trainer.restarts == 1 and equal(restored, state)


# -- the driver -------------------------------------------------------------------------------
def test_launch_train_on_the_cpu_with_a_failure(capsys):
    losses = ttrain.main(["--arch", "granite-8b", "--smoke", "--steps", "12", "--fail-at", "7",
                          "--ckpt-every", "3", "--device", "cpu"])
    assert len(losses) == 7 + 12 - 6 and all(np.isfinite(losses))
    text = capsys.readouterr().out
    assert "restarted from step 6 with SP 0 down" in text and "restored == saved: True" in text
    assert "repaired" in text and "UNRECOVERABLE" not in text and "on cpu" in text


def test_train_run_reports_the_restart():
    """The reference's end-to-end settings (tests/test_system.py) with two
    microbatches: a checkpoint at step 4, a crash at 6, a restore of step 4
    equal to what was saved, verified repairs, steps 5-16 again."""
    run = ttrain.train(tconfigs.get_smoke("granite-8b"), steps=16, batch=4, seq=48,
                       ckpt_every=4, fail_at=6, num_microbatches=2, device="cpu")
    assert run.restored_step == 4 and run.restored_equal and run.victim == 0
    assert len(run.repairs) > 0 and not run.repair_failures
    assert all(r.verified for r in run.repairs)
    assert [r.steps_run for r in run.reports] == [6, 12] and len(run.losses) == 18
    assert len(run.reports[0].step_s) == len(run.reports[0].data_s) == 6
    assert run.reports[0].ckpt_bytes == run.restore_bytes > 0
    assert run.reports[1].ckpt_bytes == 3 * run.restore_bytes  # steps 8, 12, 16
    assert int(run.state["step"]) == 16 and ttrain.loss_fell(run.losses)


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "granite-8b", "--smoke", "--steps", "2"])
