"""Every other family on the port's mesh, held against the JAX package on the CPU.

One 2 x 2 ``("data", "model")`` world of four Gloo processes (a module
fixture) runs, through the port's entry points and each rank on its
shards, falcon-mamba (SSM), hymba (the hybrid; long mode too),
deepseek-v2-lite (MLA with its leading dense layer, and the MoE),
whisper-tiny (the encoder-decoder) and phi-3-vision (embedding inputs), all
at their smoke widths with weights made by the JAX package's
``init_params`` and passed through ``params_from_numpy``:

* decode under ``DECODE_RULES``: batch 4 over data, a 16-slot cache split
  over model (k/v, MLA's latents c_kv/k_rope and dense0's, Mamba's conv and
  h_ssm split by channel, whisper's enc_out by batch), position 3 from a
  seeded cache;
* hymba in long mode under ``LONG_RULES`` (batch 1): its 32-slot ring split
  over model, 16 slots a rank, at position 3 (the second rank's slots are
  unwritten: it sees no key) and 40 (the ring has wrapped); then positions
  0-47 teacher-forced from an empty ring against the port in one process;
* a train step under ``TRAIN_RULES``: 4 x 16 in 2 microbatches;
* ``ServeEngine.generate`` (whisper encodes each rank's rows of seeded
  frames into its cache), against the port in one process;
* the f32 gradient of every leaf, against the port in one process.

Yardsticks: the JAX package's local path and its own mesh path, both in
one subprocess (4 fake XLA devices, a 2 x 2 ``jax.sharding.Mesh``, auto
axes; ``jax.make_mesh``'s explicit axes do not
lower these steps in this jax, ROADMAP Queue 3 item 4).  Tolerances, as
``tests/test_torch_mesh.py``'s where the packages allow them: decode
logits within 0.05 of the port in one process, and within 0.15 of both JAX
paths, the bound ``tests/test_torch_serve.py`` and
``tests/test_torch_families.py`` hold bf16 logits between the packages to
(here the port in one process is itself 0.125 from the JAX package's local
decode for deepseek and 0.082 for whisper: the packages round bf16 products
at different places); caches: the layer that the embedding alone writes
within 1e-6 (k/v, conv, enc_out, deepseek's dense0 latents), every other
within 2^-4 of its largest value (Queue 3 item 11; deepseek's MoE-layer
latents and Mamba's h_ssm, an f32 state from bf16 products, in every
layer); loss 0.02, parameters after the step 1e-5.  f32 gradients within
``GRAD_RTOL`` (1e-4) of each leaf's largest entry plus ``GRAD_ATOL`` (a
leaf whose gradient is 0 in exact arithmetic, as a bias added to every key
of whisper's cross-attention, holds rounding noise of ~3e-8), the loss
within 1e-5; whisper's within 1e-3 of each leaf's largest entry (the f32
bound of ``tests/test_torch_families.py``): at the JAX package's init its
attention is one-hot (scores of ~100, ROADMAP Queue 3 item 5), so the
mesh's summation order (row-parallel partials summed, where one process
takes one product) moves its gradients by up to 1.7e-4 of their largest
entry.  The long-mode sequence's caches within 2^-6 relative L2 of one
process's (observed: k/v 0.0031, conv 0.0044, h_ssm 0.0078): the mesh
rounds in_proj's and out_proj's sums of partials where one process rounds
one product, and 48 steps of the SSM recurrence carry it.  deepseek runs
with capacity factor 64, so that no token is
dropped on the local path or the mesh (a data shard's capacity on the mesh
is the JAX mesh path's, not the local one's: Queue 3 item 12); its mesh
gradient is held against the mean of the data shards' gradients in one
process (each shard's aux, as the mesh takes it).  A planted fault, Mamba's
fused ``in_proj`` [x | z] split contiguously over model (rank 0 all of x,
rank 1 all of z), must fail the decode and gradient comparisons.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import sharding as S
from repro_torch.configs import ALL_ARCHS, get, get_smoke
from repro_torch.distributed import Axis
from repro_torch.launch.mesh import launch
from repro_torch.models import layers as TL
from repro_torch.models.model import build
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import (DECODE_RULES, LONG_RULES, TRAIN_RULES, MeshCtx, params_from_numpy,
                                  unflatten, unshard)
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = {"mamba": "falcon-mamba-7b", "hymba": "hymba-1.5b", "mla": "deepseek-v2-lite-16b",
         "whisper": "whisper-tiny", "phi3": "phi-3-vision-4.2b"}
LOGIT_TOL, CACHE_TOL, LOSS_TOL, PARAM_TOL = 0.05, 1e-6, 0.02, 1e-5
JAX_LOGIT_TOL = 0.15  # bf16 logits between the packages (tests/test_torch_serve.py)
CACHE_BF16_REL = 2**-4  # deeper cache layers (and h_ssm) against the JAX package
GRAD_RTOL = {"whisper": 1e-3}  # f32 gradients, mesh against one process, of each leaf's
GRAD_RTOL_DEFAULT, GRAD_ATOL = 1e-4, 1e-6  # largest entry (module docstring)
BATCH, SLOTS, POS, SEQ = 4, 16, 3, 16
LONG_SLOTS, LONG_POSITIONS, LONG_STEPS = 64, (3, 40), 48  # hymba-smoke's ring: 32 slots
SEQ_CACHE_REL = 2**-6  # the long-mode sequence's caches against one process, relative L2
PROMPT, GEN = 3, 5  # the engine's generation


def _config(key: str, full: bool = False):
    cfg = (get if full else get_smoke)(ARCHS[key])
    if cfg.moe is not None:  # nothing dropped: the local path and the mesh keep every token
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    return cfg


def _jit0(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with XLA's CPU backend optimisation
    level 0: the same HLO in about half the compile time (each program here
    runs once)."""
    import jax

    exe = jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})
    return exe(*args)


def _group(npz, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix)}


def _inputs(path: pathlib.Path) -> None:
    """Each family's weights (the JAX package's ``init_params``), seeded caches,
    tokens and batches, written to ``path`` (an npz of flat dotted keys)."""
    import jax

    from repro.models.model import build as jbuild
    from repro.sharding import init_params

    from repro_torch.sharding import flatten

    rng = np.random.default_rng(0)
    out = {}
    for i, key in enumerate(ARCHS):
        cfg = _config(key)
        model = jbuild(cfg)
        params = _jit0(lambda k, m=model: init_params(m.param_specs(), k), jax.random.PRNGKey(10 + i))
        out.update({f"{key}.p.{k}": np.asarray(v) for k, v in flatten(params).items()})
        for name, spec in flatten(model.cache_specs(BATCH, SLOTS)).items():
            out[f"{key}.cache.{name}"] = rng.normal(size=spec.shape).astype(np.float32)
        out[f"{key}.toks"] = rng.integers(0, cfg.vocab, (BATCH, 1)).astype(np.int32)
        out[f"{key}.tokens"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        out[f"{key}.labels"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        if cfg.input_mode == "embeddings":
            width = (BATCH, cfg.enc_seq if cfg.is_encdec else SEQ, cfg.d_model)
            out[f"{key}.embeddings"] = (rng.normal(size=width) * 0.5).astype(np.float32)
    cfg = _config("hymba")
    for name, spec in flatten(jbuild(cfg).cache_specs(1, LONG_SLOTS, long_mode=True)).items():
        out[f"long.cache.{name}"] = rng.normal(size=spec.shape).astype(np.float32)
    out["long.toks"] = rng.integers(0, cfg.vocab, (1, LONG_STEPS)).astype(np.int32)
    np.savez(path, **out)


def _batch(npz, key: str, cfg) -> dict:
    """The train batch as the JAX package's trainer builds it: tokens (and
    frames) for the encoder-decoder, embeddings for an embedding-input model."""
    out = {"labels": npz[f"{key}.labels"]}
    if cfg.is_encdec:
        out.update(frames=npz[f"{key}.embeddings"], tokens=npz[f"{key}.tokens"])
    elif cfg.input_mode == "embeddings":
        out["embeddings"] = npz[f"{key}.embeddings"]
    else:
        out["tokens"] = npz[f"{key}.tokens"]
    return out


def jax_run(path: str, mesh: bool) -> dict:
    """Decode, long-mode decode and a 2-microbatch train step through the JAX
    package, local (``mesh`` False) or on a 2 x 2 ``jax.sharding.Mesh`` of
    the process's first four devices."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import build as jbuild
    from repro.sharding import DECODE_RULES as JD
    from repro.sharding import LONG_RULES as JL
    from repro.sharding import TRAIN_RULES as JT
    from repro.sharding import AxisCtx
    from repro.train.optimizer import init_state
    from repro.train.step import make_train_step as jstep

    from repro_torch.sharding import flatten

    npz = np.load(path)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model")) \
        if mesh else None

    def ctx(rules):
        return AxisCtx(dict(rules), jmesh) if mesh else AxisCtx()

    def cache_of(model, prefix, *spec_args, **spec_kw):
        specs = flatten(model.cache_specs(*spec_args, **spec_kw))
        return {k: jnp.asarray(v, specs[k].dtype) for k, v in _group(npz, prefix).items()}

    out = {}
    for key in ARCHS:
        cfg = _config(key)
        model = jbuild(cfg)
        params = jax.tree.map(jnp.asarray, unflatten(_group(npz, f"{key}.p.")))
        cache = cache_of(model, f"{key}.cache.", BATCH, SLOTS)
        lg, nc = _jit0(lambda p, c, t, m=model: m.decode_step(p, c, t, jnp.int32(POS), ctx(JD)),
                       params, cache, jnp.asarray(npz[f"{key}.toks"]))
        out[f"{key}.logits"] = np.asarray(lg, np.float32)
        out.update({f"{key}.cache.{k}": np.asarray(v, np.float32) for k, v in nc.items()})
        st, met = _jit0(jstep(cfg, ctx(JT), num_microbatches=2), init_state(params),
                        _batch(npz, key, cfg))
        out[f"{key}.loss"] = np.float32(met["loss"])
        out.update({f"{key}.params.{k}": np.asarray(v) for k, v in flatten(st["params"]).items()})
        if key == "hymba":
            toks = npz["long.toks"]
            for pos in LONG_POSITIONS:
                cache = cache_of(model, "long.cache.", 1, LONG_SLOTS, long_mode=True)
                lg, nc = _jit0(lambda p, c, t, pos=pos, m=model: m.decode_step(
                    p, c, t, jnp.int32(pos), ctx(JL), long_mode=True),
                    params, cache, jnp.asarray(toks[:, pos:pos + 1]))
                out[f"long{pos}.logits"] = np.asarray(lg, np.float32)
                out.update({f"long{pos}.cache.{k}": np.asarray(v, np.float32)
                            for k, v in nc.items()})
    return out


_JAX_MESH = textwrap.dedent("""
    import os, sys
    # 4 fake devices, each computing on one thread: the suite's other workers share the cores
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    sys.path.insert(0, {tests!r})
    import numpy as np
    from test_torch_mesh_families import jax_run
    np.savez(sys.argv[2], **jax_run(sys.argv[1], mesh=True))
    np.savez(sys.argv[3], **jax_run(sys.argv[1], mesh=False))
""")


# -- the port: one process and the ranks ----------------------------------------------
def _port_batch(npz, key: str, cfg) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in _batch(npz, key, cfg).items()}


def _grads(model, params, batch, ctx=None):
    """(loss, gradients): as the train step takes them, on this rank's shards."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = model.loss(leaves, batch, ctx)
    g = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    g = dict(zip(leaves, g))
    return loss.detach(), (g if ctx is None else ctx.reduce_grads(g))


def _cache(npz, prefix: str, specs: dict) -> dict:
    return {k: torch.from_numpy(v).to(specs[k].dtype) for k, v in _group(npz, prefix).items()}


def _frames(cfg):
    gen = torch.Generator().manual_seed(7)
    return torch.randn((BATCH, cfg.enc_seq, cfg.d_model), generator=gen) * 0.5


def _prompts(cfg):
    return np.random.default_rng(8).integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)


def _long_sequence(model, params, npz, specs, ctx=None, mesh=None) -> dict:
    """hymba in long mode teacher-forced over LONG_STEPS positions from an
    empty ring: every step's logits and the last cache, whole."""
    toks = torch.from_numpy(npz["long.toks"]).long()
    cache = {k: torch.zeros(s.shape if ctx is None else ctx.local_shape(s), dtype=s.dtype)
             for k, s in specs.items()}
    logits = []
    with torch.no_grad():
        for pos in range(LONG_STEPS):
            lg, cache = model.decode_step(params, cache, toks[:, pos:pos + 1], pos, ctx,
                                          long_mode=True)
            logits.append(lg.float())
    if ctx is not None:
        cache = unshard(cache, specs, ctx.rules, mesh)
    return {"seq.logits": torch.stack(logits), **{f"seq.{k}": v.float() for k, v in cache.items()}}


def _decode(model, params, cache, npz, key, ctx=None):
    with torch.no_grad():
        return model.decode_step(params, cache, torch.from_numpy(npz[f"{key}.toks"]).long(), POS,
                                 ctx)


def _rank(mesh, path: str) -> dict:
    npz = np.load(path)
    out = {}
    for key in ARCHS:
        cfg = _config(key)
        model = build(cfg)
        specs = model.param_specs()
        params = params_from_numpy(unflatten(_group(npz, f"{key}.p.")), device="cpu")
        # decode under DECODE_RULES from the seeded cache
        dctx = MeshCtx(DECODE_RULES, mesh, cfg)
        cache_specs = model.cache_specs(BATCH, SLOTS)
        dparams = dctx.shard(params, specs)
        cache = dctx.shard(_cache(npz, f"{key}.cache.", cache_specs), cache_specs)
        lg, nc = _decode(model, dparams, cache, npz, key, dctx)
        out[f"{key}.logits"] = lg
        out.update({f"{key}.cache.{k}": v
                    for k, v in unshard(nc, cache_specs, dctx.rules, mesh).items()})
        # the serving engine (an encoder-decoder encodes each rank's rows of the frames)
        engine = ServeEngine(cfg, dparams, ctx=dctx, max_len=PROMPT + GEN)
        out[f"{key}.generated"] = engine.generate(
            _prompts(cfg), GEN, frames=_frames(cfg) if cfg.is_encdec else None)
        # a train step in two microbatches
        tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
        step = make_train_step(cfg, tctx, num_microbatches=2)
        new, met = step(topt.init_state(tctx.shard(params, specs)), _port_batch(npz, key, cfg))
        out[f"{key}.loss"] = met["loss"]
        out.update({f"{key}.params.{k}": v
                    for k, v in unshard(new["params"], specs, tctx.rules, mesh).items()})
        if key == "hymba":  # long mode: the ring split over model
            lctx = MeshCtx(LONG_RULES, mesh, cfg)
            lparams = lctx.shard(params, specs)
            long_specs = model.cache_specs(1, LONG_SLOTS, long_mode=True)
            toks = torch.from_numpy(npz["long.toks"]).long()
            for pos in LONG_POSITIONS:
                cache = lctx.shard(_cache(npz, "long.cache.", long_specs), long_specs)
                before = {k: v.clone() for k, v in cache.items()}
                with torch.no_grad():
                    lg, nc = model.decode_step(lparams, cache, toks[:, pos:pos + 1], pos, lctx,
                                               long_mode=True)
                out[f"long{pos}.logits"] = lg
                out[f"long{pos}.untouched"] = [k for k in ("k", "v")
                                               if torch.equal(nc[k], before[k])]
                out.update({f"long{pos}.cache.{k}": v
                            for k, v in unshard(nc, long_specs, lctx.rules, mesh).items()})
            out.update(_long_sequence(model, lparams, npz, long_specs, lctx, mesh))
    # f32 gradients of the mean loss
    TL.COMPUTE_DTYPE = torch.float32
    try:
        for key in ARCHS:
            cfg = _config(key)
            model = build(cfg)
            params = params_from_numpy(unflatten(_group(npz, f"{key}.p.")), device="cpu")
            gctx = MeshCtx(TRAIN_RULES, mesh, cfg)
            loss, g = _grads(model, gctx.shard(params, model.param_specs()),
                             _port_batch(npz, key, cfg), gctx)
            out[f"{key}.grad.loss"] = loss
            out.update({f"{key}.grad.{k}": v for k, v in
                        unshard(g, model.param_specs(), gctx.rules, mesh).items()})
    finally:
        TL.COMPUTE_DTYPE = torch.bfloat16
    out.update(_planted(mesh, npz))
    return out


def _planted(mesh, npz) -> dict:
    """falcon-mamba with ``in_proj`` split contiguously over model (no part-wise
    split: ``sharding.FUSED`` emptied): its decode logits and f32 gradient."""
    fused = dict(S.FUSED)
    S.FUSED.clear()
    TL.COMPUTE_DTYPE = torch.float32
    try:
        cfg = _config("mamba")
        model = build(cfg)
        specs = model.param_specs()
        params = params_from_numpy(unflatten(_group(npz, "mamba.p.")), device="cpu")
        gctx = MeshCtx(TRAIN_RULES, mesh, cfg)
        loss, g = _grads(model, gctx.shard(params, specs), _port_batch(npz, "mamba", cfg), gctx)
        grads = unshard(g, specs, gctx.rules, mesh)
    finally:
        TL.COMPUTE_DTYPE = torch.bfloat16
        S.FUSED.update(fused)
    S.FUSED.clear()
    try:
        dctx = MeshCtx(DECODE_RULES, mesh, cfg)
        cache_specs = model.cache_specs(BATCH, SLOTS)
        cache = dctx.shard(_cache(npz, "mamba.cache.", cache_specs), cache_specs)
        lg, _ = _decode(model, dctx.shard(params, specs), cache, npz, "mamba", dctx)
    finally:
        S.FUSED.update(fused)
    return {"planted.logits": lg, "planted.grad.loss": loss,
            **{f"planted.grad.{k}": v for k, v in grads.items()}}


# -- fixtures ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX local, JAX mesh, the port's ranks): one JAX subprocess
    (its mesh path, then its local path, each device on one thread) and the
    port's world run side by side."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    inputs, jax_mesh, jax_local = tmp / "inputs.npz", tmp / "jax_mesh.npz", tmp / "jax_local.npz"
    _inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_MESH.format(tests=str(ROOT / "tests")), str(inputs),
         str(jax_mesh), str(jax_local)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ranks = launch(_rank, str(inputs), data=2, model=2, device="cpu", timeout=600)
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return np.load(inputs), dict(np.load(jax_local)), dict(np.load(jax_mesh)), ranks


@pytest.fixture(scope="module")
def one_process(runs):
    """The port in one process: decode, the engine, long mode and the f32
    gradients (deepseek: the mean of its data shards' gradients)."""
    npz = runs[0]
    out = {}
    old_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for key in ARCHS:
            cfg = _config(key)
            model = build(cfg)
            params = params_from_numpy(unflatten(_group(npz, f"{key}.p.")), device="cpu")
            cache_specs = model.cache_specs(BATCH, SLOTS)
            lg, nc = _decode(model, params, _cache(npz, f"{key}.cache.", cache_specs), npz, key)
            out[f"{key}.logits"] = lg.float().numpy()
            out.update({f"{key}.cache.{k}": v.float().numpy() for k, v in nc.items()})
            engine = ServeEngine(cfg, params, max_len=PROMPT + GEN)
            out[f"{key}.generated"] = engine.generate(
                _prompts(cfg), GEN, frames=_frames(cfg) if cfg.is_encdec else None)
            if key == "hymba":
                specs = model.cache_specs(1, LONG_SLOTS, long_mode=True)
                out.update({k: v.numpy() for k, v in
                            _long_sequence(model, params, npz, specs).items()})
        TL.COMPUTE_DTYPE = torch.float32
        for key in ARCHS:
            cfg = _config(key)
            model = build(cfg)
            params = params_from_numpy(unflatten(_group(npz, f"{key}.p.")), device="cpu")
            batch = _port_batch(npz, key, cfg)
            if cfg.moe is not None:  # the mesh's loss: the mean of its data shards' losses
                parts = [_grads(model, params, {k: v[j * 2:(j + 1) * 2] for k, v in batch.items()})
                         for j in range(2)]
                loss = (parts[0][0] + parts[1][0]) / 2
                g = {k: (parts[0][1][k] + parts[1][1][k]) / 2 for k in parts[0][1]}
            else:
                loss, g = _grads(model, params, batch)
            out[f"{key}.grad.loss"] = float(loss)
            out.update({f"{key}.grad.{k}": v.numpy() for k, v in g.items()})
    finally:
        TL.COMPUTE_DTYPE = torch.bfloat16
        torch.set_num_threads(old_threads)
    return out


# -- the checks --------------------------------------------------------------------
def _max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _cache_failures(got: dict, want: dict, names) -> list[str]:
    """The caches of ``names`` outside the bounds of the module docstring."""
    bad = []
    for name in names:
        g, w = np.asarray(got[name], np.float32), np.asarray(want[name], np.float32)
        deep = CACHE_BF16_REL * np.abs(w).max()
        # h_ssm is f32 from bf16 products; deepseek's c_kv/k_rope start at its second layer
        written_deeper = name.endswith(("h_ssm", "mla.cache.c_kv", "mla.cache.k_rope"))
        first_ok = written_deeper or _max_diff(g[0], w[0]) <= CACHE_TOL
        if not (first_ok and _max_diff(g, w) <= deep):
            bad.append(f"{name}: {_max_diff(g, w):.3g} (first layer {_max_diff(g[0], w[0]):.3g})")
    return bad


class _TwoByTwo:
    """A 2 x 2 mesh's axis names and sizes, and rank 0's axes: what
    ``MeshCtx`` reads to plan its products."""

    shape = {"data": 2, "model": 2}

    def axis(self, name):
        return Axis(name, None, 2, 0)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_meshctx_builds_for_every_config(arch, full):
    """Every architecture, with token or embedding inputs, under every rule table."""
    cfg = (get if full else get_smoke)(arch)
    for rules in (TRAIN_RULES, DECODE_RULES, LONG_RULES):
        ctx = MeshCtx(rules, _TwoByTwo(), cfg)
        assert set(ctx.plans) <= set(S.CONTRACTED)


@pytest.mark.parametrize("rules, want", [
    (TRAIN_RULES, {"in_proj": (True, False, False, False, False),
                   "x_proj": (False, False, True, False, False),
                   "dt_proj": (True, False, False, False, False),
                   "out_proj": (False, False, True, False, False)}),
    (DECODE_RULES, {"in_proj": (True, True, True, False, True),
                    "x_proj": (False, False, True, False, False),
                    "dt_proj": (True, False, False, False, False),
                    "out_proj": (False, False, True, False, False)}),
    (LONG_RULES, {"in_proj": (True, True, True, False, True)}),
], ids=["train", "decode", "long"])
def test_mamba_products_plan_per_rule_table(rules, want):
    """(copy_f, cut_input, reduce_g, gather, cut_output) of each Mamba product:
    under DECODE_RULES in_proj's embed dim takes model first, so its output
    is summed whole and each rank keeps its channels of x and of z (two parts)."""
    ctx = MeshCtx(rules, _TwoByTwo(), get_smoke("falcon-mamba-7b"))
    for name, flags in want.items():
        p = ctx.plans[name]
        assert (p.copy_f, p.cut_input, p.reduce_g, p.gather, p.cut_output) == flags, name
    assert ctx.plans["in_proj"].parts == 2 and ctx.plans["out_proj"].parts == 1


def test_cross_attention_plans_as_self_attention():
    """whisper's cross-attention leaves share attention's names and plans."""
    cfg = get("whisper-tiny")
    specs = build(cfg).param_specs()
    for rules in (TRAIN_RULES, DECODE_RULES):
        for prefix in ("enc_blocks.attn.", "dec_blocks.self_attn.", "dec_blocks.cross_attn."):
            sub = {k: v for k, v in specs.items() if k.startswith(prefix)}
            assert S.product_plans(sub, rules, _TwoByTwo()) == S.product_plans(
                {k: v for k, v in specs.items() if k.startswith("dec_blocks.self_attn.")},
                rules, _TwoByTwo())


def test_in_proj_shards_part_wise():
    """Each rank's in_proj holds its channels of x and of z, in their order."""
    cfg = get_smoke("falcon-mamba-7b")
    specs = build(cfg).param_specs()
    di = cfg.ssm.d_inner
    w = torch.arange(2 * di, dtype=torch.float32).expand(3, cfg.d_model, 2 * di).contiguous()
    for m in range(2):
        got = S.shard_params({"blocks.ssm.in_proj": w}, specs, TRAIN_RULES, _TwoByTwo(),
                             {"data": 0, "model": m})["blocks.ssm.in_proj"]
        half = di // 2
        want = torch.cat([torch.arange(m * half, (m + 1) * half),
                          torch.arange(di + m * half, di + (m + 1) * half)]).float()
        assert torch.equal(got[0, 0], want)
        assert got.shape == (3, cfg.d_model // 2, di)


@pytest.mark.parametrize("key", ARCHS)
def test_decode_matches_the_local_and_mesh_paths(runs, key):
    _, local, jmesh, ranks = runs
    names = [k for k in local if k.startswith(f"{key}.cache.")]
    for ref in (local, jmesh):
        for r in ranks:
            assert _max_diff(r[f"{key}.logits"], ref[f"{key}.logits"]) < JAX_LOGIT_TOL
            assert not _cache_failures(r, ref, names)


@pytest.mark.parametrize("key", ARCHS)
def test_decode_and_generation_match_one_process(runs, one_process, key):
    """The mesh's decode against the port in one process (logits within
    LOGIT_TOL, caches to the same bounds), and the engine's tokens equal."""
    _, _, _, ranks = runs
    names = [k for k in one_process if k.startswith(f"{key}.cache.")]
    for r in ranks:
        assert _max_diff(r[f"{key}.logits"], one_process[f"{key}.logits"]) < LOGIT_TOL
        assert not _cache_failures(r, one_process, names)
        np.testing.assert_array_equal(r[f"{key}.generated"], one_process[f"{key}.generated"])


@pytest.mark.parametrize("key", ARCHS)
def test_train_step_matches_the_local_and_mesh_paths(runs, key):
    npz, local, jmesh, ranks = runs
    names = [k[len(f"{key}.p."):] for k in npz.files if k.startswith(f"{key}.p.")]
    for ref in (local, jmesh):
        for r in ranks:
            assert abs(float(r[f"{key}.loss"]) - float(ref[f"{key}.loss"])) < LOSS_TOL
            for k in names:
                assert _max_diff(r[f"{key}.params.{k}"], ref[f"{key}.params.{k}"]) < PARAM_TOL, k


def _grad_failures(r: dict, one: dict, prefix: str, key: str) -> list[str]:
    bad = []
    if abs(float(r[f"{prefix}.grad.loss"]) - one[f"{key}.grad.loss"]) >= 1e-5:
        bad.append("loss")
    for k in one:
        if k.startswith(f"{key}.grad.") and k != f"{key}.grad.loss":
            name = k[len(f"{key}.grad."):]
            want = one[k]
            rtol = GRAD_RTOL.get(key, GRAD_RTOL_DEFAULT)
            if _max_diff(r[f"{prefix}.grad.{name}"], want) > rtol * np.abs(want).max() + GRAD_ATOL:
                bad.append(name)
    return bad


@pytest.mark.parametrize("key", ARCHS)
def test_gradients_match_one_process_in_f32(runs, one_process, key):
    """Every leaf's gradient of the mean loss, unsharded, on every rank."""
    for r in runs[3]:
        assert not _grad_failures(r, one_process, key, key)


@pytest.mark.parametrize("pos", LONG_POSITIONS)
def test_long_mode_ring_split_matches_the_local_and_mesh_paths(runs, pos):
    """hymba in long mode, its 32-slot ring 16 slots a rank: at position 3 the
    second rank's slots are unwritten (its shard sees no key, weighs 0 and
    stays as it was); at 40 the ring has wrapped and both shards hold keys."""
    _, local, jmesh, ranks = runs
    names = [k for k in local if k.startswith(f"long{pos}.cache.")]
    for ref in (local, jmesh):
        for r in ranks:
            assert _max_diff(r[f"long{pos}.logits"], ref[f"long{pos}.logits"]) < JAX_LOGIT_TOL
            assert not _cache_failures(r, ref, names)
    # the slot written: pos % 32, on the first model rank (3, 8) in both cases
    assert [r[f"long{pos}.untouched"] for r in ranks] == [[], ["k", "v"], [], ["k", "v"]]


def test_long_mode_sequence_matches_one_process(runs, one_process):
    """Positions 0-47 from an empty ring: to 15 the second rank's shard sees
    no key, from 16 both hold keys, from 32 the ring wraps under the window."""
    for r in runs[3]:
        assert _max_diff(r["seq.logits"], one_process["seq.logits"]) < LOGIT_TOL
        for name in ("k", "v", "conv", "h_ssm"):
            got, want = np.asarray(r[f"seq.{name}"]), np.asarray(one_process[f"seq.{name}"])
            assert np.linalg.norm(got - want) <= SEQ_CACHE_REL * np.linalg.norm(want), name


def test_in_proj_split_contiguously_fails(runs, one_process):
    """The planted fault (rank 0 all of x, rank 1 all of z) moves the decode
    logits and the gradients far outside the bounds the right split meets."""
    for r in runs[3]:
        assert _max_diff(r["planted.logits"], one_process["mamba.logits"]) > 10 * LOGIT_TOL
        assert "blocks.ssm.in_proj" in _grad_failures(r, one_process, "planted", "mamba")
