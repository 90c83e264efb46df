"""The port's serving path held against the JAX package: configs, parameter
trees, the dense decoder's decode step, checkpoints through Shelby, the
greedy engine and the ``launch/serve.py`` driver, on the CPU at smoke sizes.

Weights are the JAX package's (``init_params`` from a PRNG key, then a
seeded numpy perturbation so that norms and biases are not trivial),
carried into the port by ``params_from_numpy``.

Tolerances for the decode step's logits, teacher-forced over 12 positions:
* f32 compute in both packages (their ``COMPUTE_DTYPE`` patched to f32):
  atol 1e-4 — the same algorithm up to summation order (observed <= 1.2e-5
  for logits up to 2.6).
* bf16 compute, as configured: atol 0.15.  Both packages round every
  product and activation to bf16 (8 significant bits), but at different
  places (XLA and PyTorch fuse and accumulate differently; the JAX layers
  also round attention scores and probabilities to bf16), and two layers
  compound it: observed <= 0.091 for logits up to 2.6, where one bf16 ulp
  is 0.0156.  Tokens are compared only where the reference's top-2 margin
  exceeds twice the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget_full
from repro.configs import get_smoke as jget
from repro.models import layers as JL
from repro.models.model import build as jbuild
from repro.sharding import AxisCtx, ParamSpec as JParamSpec, init_params as jinit
from repro.storage import checkpoint as jck
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.cluster import build_cluster
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models.model import DecoderLM, build as tbuild
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import flatten, params_from_numpy, unflatten
from repro_torch.storage import checkpoint as tck

DENSE = ["yi-9b", "granite-8b", "starcoder2-3b", "command-r-plus-104b"]
F32_ATOL = 1e-4
BF16_ATOL = 0.15


def _jax_params(arch: str, seed: int = 1):
    model = jbuild(jget(arch))
    params = jinit(model.param_specs(), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
                        params)


def _teacher_forced(arch: str, compute: str, steps: int = 12, b: int = 2):
    """Logits of both packages' decode steps over the same tokens: (jax, port)."""
    jcfg, tcfg = jget(arch), tconfigs.get_smoke(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = _jax_params(arch)
    tp = params_from_numpy(jp, device="cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (b, steps)).astype(np.int32)
    cdt = (jnp.float32, torch.float32) if compute == "f32" else (jnp.bfloat16, torch.bfloat16)
    jc = {k: jnp.zeros(s.shape, cdt[0]) for k, s in jm.cache_specs(b, steps + 2).items()}
    tc = {k: torch.zeros(s.shape, dtype=cdt[1]) for k, s in tm.cache_specs(b, steps + 2).items()}
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, AxisCtx()))
    jl, tl = [], []
    for pos in range(steps):
        a, jc = step(jp, jc, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos))
        t, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, pos:pos + 1]).long(), pos)
        jl.append(np.asarray(a, np.float32)[:, 0, :jcfg.vocab])
        tl.append(t.float().numpy()[:, 0, :jcfg.vocab])
    return np.stack(jl), np.stack(tl)


# -- configs and parameter trees --------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    for jcfg, tcfg in ((jget_full(arch), tconfigs.get(arch)), (jget(arch), tconfigs.get_smoke(arch))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert (tcfg.head_dim_, tcfg.padded_vocab) == (jcfg.head_dim_, jcfg.padded_vocab)


def test_other_architectures_raise():
    for arch in tconfigs.ALL_ARCHS:
        if arch in DENSE:
            continue
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            tconfigs.get(arch)
        with pytest.raises(NotImplementedError):
            tconfigs.get_smoke(arch)
    with pytest.raises(KeyError):
        tconfigs.get("no-such-model")
    with pytest.raises(NotImplementedError):
        DecoderLM(ArchConfig(name="m", family="moe", num_layers=1, d_model=8, num_heads=2,
                             num_kv_heads=1, d_ff=8, vocab=16))


@pytest.mark.parametrize("arch", DENSE)
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
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
    cache_j = jbuild(jcfg).cache_specs(4, 25)
    cache_t = tbuild(tcfg).cache_specs(4, 25)
    assert {k: s.shape for k, s in cache_t.items()} == {k: s.shape for k, s in cache_j.items()}


def test_param_count_matches_reference_and_the_chip_cut():
    yi = tconfigs.get("yi-9b")
    assert tbuild(yi).param_count() == jget_full("yi-9b").param_count()
    assert tbuild(dataclasses.replace(yi, num_layers=2)).param_count() == 870_338_560


def test_flatten_round_trip_and_params_from_numpy():
    jp = _jax_params("starcoder2-3b")
    tp = params_from_numpy(jp, device="cpu")
    assert list(tp) == list(flatten(jp))
    leaves = jax.tree_util.tree_leaves(jp)
    assert all(np.array_equal(t.numpy(), j) for t, j in zip(tp.values(), leaves))
    assert flatten(unflatten(tp)) == tp


# -- the decode step ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_logits_f32(arch, monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    want, got = _teacher_forced(arch, "f32")
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_logits_bf16(arch):
    want, got = _teacher_forced(arch, "bf16")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * BF16_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_engine_tokens_are_reference_greedy_choices():
    """The port's greedy generation, replayed teacher-forced through the JAX
    decode step: every generated token is the reference's argmax, or within
    the bf16 tolerance of it."""
    arch = "granite-8b"
    jcfg = jget(arch)
    jp = _jax_params(arch)
    engine = ServeEngine(tconfigs.get_smoke(arch), params_from_numpy(jp, device="cpu"), max_len=25)
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
    out = engine.generate(prompts, num_tokens=16)
    assert out.shape == (4, 24) and out.dtype == np.int32
    assert (out[:, :8] == prompts).all() and engine.stats.decoded_tokens == 4 * 23
    jm = jbuild(jcfg)
    jc = jinit(jm.cache_specs(4, 25), jax.random.PRNGKey(0))
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos, AxisCtx()))
    for pos in range(23):
        logits, jc = step(jp, jc, jnp.asarray(out[:, pos:pos + 1]), jnp.int32(pos))
        if pos + 1 >= 8:
            lg = np.asarray(logits, np.float32)[:, 0, :jcfg.vocab]
            chosen = lg[np.arange(4), out[:, pos + 1]]
            assert (chosen >= lg.max(-1) - BF16_ATOL).all(), pos


# -- checkpoints ---------------------------------------------------------------------------
def _state(rng):
    return {
        "params": {"w": rng.normal(size=(64, 32)).astype(np.float32),
                   "b": rng.normal(size=(32,)).astype(np.float32)},
        "m": {"w": np.zeros((64, 32), np.float32), "b": np.zeros((32,), np.float32)},
        "step": np.int32(17),
        "nested": [np.arange(5, dtype=np.int64), np.float16(2.5)],
    }


def _equal(a, b) -> bool:
    fa, fb = flatten(a), flatten(b)
    return list(fa) == list(fb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(fa.values(), fb.values()))


@pytest.mark.parametrize("which", ["state", "yi-9b", "starcoder2-3b"])
def test_serialized_bytes_identical_across_packages(which, rng):
    jtree = _state(rng) if which == "state" else _jax_params(which)
    ttree = jtree if which == "state" else params_from_numpy(jtree, device="cpu")
    data = jck.serialize_pytree(jtree)
    assert tck.serialize_pytree(ttree) == data
    assert _equal(tck.deserialize_pytree(data, ttree), ttree)
    assert _equal(jck.deserialize_pytree(tck.serialize_pytree(ttree), jtree), jtree)


def test_checkpoint_written_by_either_package_restores_in_the_other(cluster):
    jp = _jax_params("yi-9b")
    tp = params_from_numpy(jp, device="cpu")
    # the JAX package writes through its Shelby deployment; the port restores the bytes
    jmgr = jck.CheckpointManager(cluster[3], num_host_shards=2)
    rec = jmgr.save(3, jp)
    data = b"".join(r.data for r in cluster[3].get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    assert _equal(tck.deserialize_pytree(data[: rec.total_bytes], tp), tp)
    # the port writes through its own; the JAX package restores the bytes
    _, _, _, client = build_cluster(device="cpu")
    tmgr = tck.CheckpointManager(client, num_host_shards=3)
    rec = tmgr.save(5, tp)
    data = b"".join(r.data for r in client.get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    assert _equal(jck.deserialize_pytree(data[: rec.total_bytes], jp), jp)
    assert _equal(tmgr.restore(5, tp), tp)


@pytest.fixture
def port_cluster():
    return build_cluster(device="cpu")


def test_checkpoint_manager_elastic_restore(port_cluster, rng):
    mgr = tck.CheckpointManager(port_cluster[3], num_host_shards=4)
    s = _state(rng)
    mgr.save(10, s)
    for hosts in (None, 1, 2, 3, 8):
        assert _equal(mgr.restore(10, s, reading_hosts=hosts), s)


def test_checkpoint_restore_survives_sp_failures(port_cluster, rng):
    contract, sps, rpc, client = port_cluster
    mgr = tck.CheckpointManager(client, num_host_shards=2)
    s = _state(rng)
    rec = mgr.save(10, s)
    meta = contract.blobs[rec.shard_blob_ids[0]]
    sps[meta.placement[(0, 0)]].crash()
    sps[meta.placement[(0, 1)]].crash()
    rpc._cache.clear()
    assert _equal(mgr.restore(10, s), s)


def test_checkpoint_keep_policy_and_rejections(port_cluster, rng):
    mgr = tck.CheckpointManager(port_cluster[3], keep=2)
    s = {"x": np.zeros(4, np.float32)}
    for step in (1, 2, 3, 4):
        mgr.save(step, s)
    assert sorted(mgr.records) == [3, 4] and mgr.latest_step() == 4
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(4, {"x": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(4, {"x": np.zeros(4, np.float32), "y": np.zeros(1)})
    with pytest.raises(ValueError, match="not a shelby checkpoint"):
        tck.deserialize_pytree(b"garbage", s)
    with pytest.raises(TypeError, match="bfloat16"):
        tck.serialize_pytree({"x": torch.zeros(2, dtype=torch.bfloat16)})


# -- the serving driver ----------------------------------------------------------------------
def test_launch_serve_on_the_cpu(capsys):
    out = tserve.main(["--arch", "yi-9b", "--smoke", "--device", "cpu", "--kill-sp"])
    assert out.shape == (4, 24)
    text = capsys.readouterr().out
    assert "crashed" in text and "tok/s on cpu" in text


def test_serve_restores_the_published_bytes():
    run = tserve.serve(tconfigs.get_smoke("starcoder2-3b"), batch=2, prompt_len=3, gen=4,
                       kill_sp=True, device="cpu")
    assert list(run.served) == list(run.published)
    assert all(torch.equal(run.served[k], run.published[k]) for k in run.published)
    assert run.outputs.shape == (2, 7) and (run.outputs[:, :3] == run.prompts).all()
    assert run.decoded_tokens == 2 * 6


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(tconfigs.get_smoke("yi-9b"))
