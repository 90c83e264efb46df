"""The port's mesh path (``repro_torch/{distributed,sharding}.py``,
``launch/mesh.py``) held against the JAX package's, on the CPU.

One 2 x 2 ``("data", "model")`` world of four Gloo processes (a module
fixture) runs the checks of the reference's own equivalence test
(``tests/test_sharding.py``) through the port's entry points, each rank on
its shards, with weights made by the JAX package's ``init_params`` and
passed through ``params_from_numpy``:

* the expert-parallel MoE: qwen3-moe-smoke, one layer, capacity factor 64
  (nothing dropped), x (4, 8, d) bf16 under ``TRAIN_RULES``;
* decode: granite-smoke under ``DECODE_RULES``, batch 4 over a 16-slot
  cache split over ``model``, position 3 (on the first model rank's shard:
  the other's shard sees no key and must stay as it was, bit for bit);
  then, against the port in one process, positions 0-11 from an empty
  cache, where from position 8 both shards hold keys and combine;
* a train step: granite-smoke under ``TRAIN_RULES``, 4 x 16 tokens in 2
  microbatches, with and without ``shard_grad_accum``.

Yardsticks: the JAX package's local path, run in this process, and its own
mesh path, run in a subprocess with 4 fake XLA devices on a
``jax.sharding.Mesh`` (auto axes; ``jax.make_mesh``'s explicit axes do not
lower these steps in this jax).  Tolerances are the reference test's or
tighter: MoE y 0.05 (both), aux 1e-5 against the JAX mesh path (its aux is
the mean over data shards of each shard's aux, which is not the local
path's); decode logits 0.05, the first layer's caches 1e-6 (the second
layer's within 2^-4 of its largest value: the port in one process rounds
attention's bf16 products differently from the JAX package); loss 0.02,
parameters after the step 1e-5.  The port's mesh is also held against the port in one process:
decode logits and caches equal, and in f32 (``COMPUTE_DTYPE`` patched in
every rank) the gradient of each leaf within ``GRAD_RTOL`` of its largest
entry, for granite-smoke with a padded vocab (250 of 256 ids: the padding
mask on the second model rank), yi-smoke with one kv head (the kv heads do
not divide the model axis) and qwen3-moe-smoke with drops and the aux loss
(whose reference is the mean of the gradients of the data shards' losses,
each computed in one process with its shard's capacity); the global norm
of shards with replicated leaves.  The other families on the mesh are
``tests/test_torch_mesh_families.py``'s.
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

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import launch
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build
from repro_torch.sharding import (DECODE_RULES, SERVE_RULES, TRAIN_RULES, MeshCtx, init_params,
                                  params_from_numpy, unflatten, unshard)
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_TOL, LOGIT_TOL, CACHE_TOL, LOSS_TOL, PARAM_TOL = 0.05, 0.05, 1e-6, 0.02, 1e-5
AUX_TOL = 1e-5
CACHE_BF16_REL = 2**-4  # deeper cache layers against the JAX package, of their largest value
GRAD_RTOL = 1e-4  # f32 gradients, mesh against one process, of each leaf's largest entry
SEQ_STEPS = 12  # decode positions 0-11 over the 16-slot cache, 8 slots a model rank
SEQ_CACHE_REL = 2**-8  # the sequence's caches against one process: relative L2, bf16's
# unit roundoff (the second layer's inputs carry the combine's bf16 rounding)
GRAD_CASES = (("granite-8b", {"vocab": 250}), ("yi-9b", {"num_kv_heads": 1}),
              ("qwen3-moe-30b-a3b", {}))


def _moe_cfg(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))


def _inputs(path: pathlib.Path) -> None:
    """The checks' inputs, made by the JAX package's ``init_params`` and numpy,
    written to ``path`` (an npz of flat dotted keys)."""
    import jax

    from repro.configs import get_smoke as jget
    from repro.models import moe as jmoe
    from repro.models.model import build as jbuild
    from repro.sharding import init_params

    from repro_torch.sharding import flatten

    rng = np.random.default_rng(0)
    out = {}
    mcfg = _moe_cfg(jget("qwen3-moe-30b-a3b"))
    moe = init_params(jmoe.moe_specs(mcfg, layers=1), jax.random.PRNGKey(1))
    out.update({f"moe.{k}": np.asarray(v)[0] for k, v in flatten(moe).items()})
    out["moe_x"] = (rng.normal(size=(4, 8, mcfg.d_model)) * 0.3).astype(np.float32)
    gcfg = jget("granite-8b")
    model = jbuild(gcfg)
    params = init_params(model.param_specs(), jax.random.PRNGKey(2))
    out.update({f"p.{k}": np.asarray(v) for k, v in flatten(params).items()})
    for name, spec in flatten(model.cache_specs(4, 16)).items():
        out[f"cache.{name}"] = rng.normal(size=spec.shape).astype(np.float32)
    out["toks"] = rng.integers(0, gcfg.vocab, (4, 1)).astype(np.int32)
    out["tokens"] = rng.integers(0, gcfg.vocab, (4, 16)).astype(np.int32)
    out["labels"] = rng.integers(0, gcfg.vocab, (4, 16)).astype(np.int32)
    np.savez(path, **out)


def _group(npz, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix)}


def jax_run(path: str, mesh: bool) -> dict:
    """The three checks through the JAX package, local (``mesh`` False) or on
    a 2 x 2 ``jax.sharding.Mesh`` of the process's first four devices."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as jget
    from repro.models import moe as jmoe
    from repro.models.model import build as jbuild
    from repro.sharding import DECODE_RULES as JD
    from repro.sharding import TRAIN_RULES as JT
    from repro.sharding import AxisCtx
    from repro.train.optimizer import init_state
    from repro.train.step import make_train_step as jstep

    from repro_torch.sharding import flatten

    npz = np.load(path)
    if mesh:
        jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))

    def ctx(rules):
        return AxisCtx(dict(rules), jmesh) if mesh else AxisCtx()

    out = {}
    mcfg = _moe_cfg(jget("qwen3-moe-30b-a3b"))
    lp = {k: jnp.asarray(v) for k, v in _group(npz, "moe.").items()}
    x = jnp.asarray(npz["moe_x"], jnp.bfloat16)
    y, aux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, mcfg, ctx(JT)))(lp, x)
    out["moe_y"], out["moe_aux"] = np.asarray(y, np.float32), np.float32(aux)
    gcfg = jget("granite-8b")
    model = jbuild(gcfg)
    params = jax.tree.map(jnp.asarray, unflatten(_group(npz, "p.")))
    cache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in _group(npz, "cache.").items()}
    lg, nc = jax.jit(lambda p, c, t: model.decode_step(p, c, t, jnp.int32(3), ctx(JD)))(
        params, cache, jnp.asarray(npz["toks"]))
    out["logits"] = np.asarray(lg, np.float32)
    out.update({f"cache.{k}": np.asarray(v, np.float32) for k, v in nc.items()})
    batch = {"tokens": npz["tokens"], "labels": npz["labels"]}
    for sga in (False, True):
        st, met = jax.jit(jstep(gcfg, ctx(JT), num_microbatches=2, shard_grad_accum=sga))(
            init_state(params), batch)
        out[f"loss{int(sga)}"] = np.float32(met["loss"])
        out.update({f"params{int(sga)}.{k}": np.asarray(v)
                    for k, v in flatten(st["params"]).items()})
    return out


_JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {tests!r})
    import numpy as np
    from test_torch_mesh import jax_run
    np.savez(sys.argv[2], **jax_run(sys.argv[1], mesh=True))
""")


# -- the port's ranks ---------------------------------------------------------------
def _config(arch: str, over: dict):
    return dataclasses.replace(get_smoke(arch), **over)


def _grads(model, params, batch, ctx=None):
    """(loss, gradients): as the train step takes them, on this rank's shards."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = model.loss(leaves, batch, ctx)
    g = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    g = dict(zip(leaves, g))
    return loss.detach(), (g if ctx is None else ctx.reduce_grads(g))


def _grad_inputs(cfg, seed: int):
    model = build(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))) for k in ("tokens", "labels")}
    return model, params, batch


def _decode_sequence(model, params, npz, cache_specs, ctx=None, mesh=None) -> dict:
    """Decode teacher-forced over ``npz["tokens"]`` (SEQ_STEPS positions) from
    an empty cache of ``cache_specs``: the logits of every step and the last
    cache, whole."""
    toks = torch.from_numpy(npz["tokens"]).long()
    cache = {k: torch.zeros(s.shape if ctx is None else ctx.local_shape(s), dtype=s.dtype)
             for k, s in cache_specs.items()}
    logits = []
    with torch.no_grad():
        for pos in range(SEQ_STEPS):
            lg, cache = model.decode_step(params, cache, toks[:, pos:pos + 1], pos, ctx)
            logits.append(lg.float())
    if ctx is not None:
        cache = unshard(cache, cache_specs, ctx.rules, mesh)
    return {"seq.logits": torch.stack(logits), **{f"seq.{k}": v.float() for k, v in cache.items()}}


def _rank(mesh, path: str) -> dict:
    npz = np.load(path)
    out = {}
    # the expert-parallel MoE over the rank's data shard of x
    mcfg = _moe_cfg(get_smoke("qwen3-moe-30b-a3b"))
    ctx = MeshCtx(TRAIN_RULES, mesh, mcfg)
    specs = ctx.specs
    full = {f"blocks.moe.{k}": torch.from_numpy(v)[None] for k, v in _group(npz, "moe.").items()}
    shards = ctx.shard(full, specs)
    lp = {k.rsplit(".", 1)[-1]: ctx.gather(k, v[0]) for k, v in shards.items()}
    x = ctx.local_batch(torch.from_numpy(npz["moe_x"]).bfloat16())
    with torch.no_grad():
        y, aux = tmoe.apply_moe(lp, x, mcfg, ctx)
    out["moe_y"], out["moe_aux"] = ctx.whole_batch(y), aux
    # decode over a cache split over model
    gcfg = get_smoke("granite-8b")
    model = build(gcfg)
    params = params_from_numpy(unflatten(_group(npz, "p.")), device="cpu")
    dctx = MeshCtx(DECODE_RULES, mesh, gcfg)
    cache_specs = model.cache_specs(4, 16)
    cache = dctx.shard({k: torch.from_numpy(v).bfloat16()
                        for k, v in _group(npz, "cache.").items()}, cache_specs)
    before = {k: v.clone() for k, v in cache.items()}
    dparams = dctx.shard(params, model.param_specs())
    with torch.no_grad():
        lg, nc = model.decode_step(dparams, cache, torch.from_numpy(npz["toks"]).long(), 3, dctx)
    out["logits"] = lg
    out.update({f"cache.{k}": v for k, v in unshard(nc, cache_specs, dctx.rules, mesh).items()})
    out["shard_unchanged"] = all(torch.equal(nc[k], before[k]) for k in nc)
    # a sequence from an empty cache: from position 8 both model ranks' shards hold keys
    out.update(_decode_sequence(model, dparams, npz, cache_specs, dctx, mesh))
    # prefill on the mesh under SERVE_RULES: the last logits whole, the cache the rank's shard
    sctx = MeshCtx(SERVE_RULES, mesh, gcfg)
    with torch.no_grad():
        plg, pcache = model.prefill(sctx.shard(params, model.param_specs()),
                                    {"tokens": torch.from_numpy(npz["tokens"]).long()}, sctx)
    out["prefill_logits"] = plg
    out["prefill_shapes"] = [[list(v.shape), list(sctx.local_shape(cache_specs[k]))]
                             for k, v in pcache.items()]
    # a train step, with and without shard_grad_accum
    tctx = MeshCtx(TRAIN_RULES, mesh, gcfg)
    batch = {k: torch.from_numpy(npz[k]).long() for k in ("tokens", "labels")}
    for sga in (False, True):
        state = topt.init_state(tctx.shard(params, model.param_specs()))
        step = make_train_step(gcfg, tctx, num_microbatches=2, shard_grad_accum=sga)
        new, met = step(state, batch)
        out[f"loss{int(sga)}"] = met["loss"]
        out[f"grad_norm{int(sga)}"] = met["grad_norm"]
        out.update({f"params{int(sga)}.{k}": v for k, v in
                    unshard(new["params"], model.param_specs(), tctx.rules, mesh).items()})
    # the global norm of shards, replicated leaves counted once
    gen = torch.Generator().manual_seed(5)
    leaves = {k: torch.randn(s.shape, generator=gen) for k, s in model.param_specs().items()}
    out["norm"] = topt.global_norm(tctx.shard(leaves, model.param_specs()), tctx)
    # f32 gradients of the mean loss against one process
    TL.COMPUTE_DTYPE = torch.float32
    for i, (arch, over) in enumerate(GRAD_CASES):
        cfg = _config(arch, over)
        gmodel, gparams, gbatch = _grad_inputs(cfg, i)
        gctx = MeshCtx(TRAIN_RULES, mesh, cfg)
        loss, g = _grads(gmodel, gctx.shard(gparams, gmodel.param_specs()), gbatch, gctx)
        out[f"grad{i}.loss"] = loss
        out.update({f"grad{i}.{k}": v for k, v in
                    unshard(g, gmodel.param_specs(), gctx.rules, mesh).items()})
    TL.COMPUTE_DTYPE = torch.bfloat16
    return out


# -- fixtures ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX local, JAX mesh, the port's ranks): the JAX mesh
    subprocess and the port's world run side by side."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs, jax_mesh = tmp / "inputs.npz", tmp / "jax_mesh.npz"
    _inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_MESH.format(tests=str(ROOT / "tests")), str(inputs),
         str(jax_mesh)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = launch(_rank, str(inputs), data=2, model=2, device="cpu", timeout=400)
    local = jax_run(str(inputs), mesh=False)
    _, stderr = proc.communicate(timeout=400)
    assert proc.returncode == 0, stderr[-3000:]
    return np.load(inputs), local, dict(np.load(jax_mesh)), ranks


@pytest.fixture(scope="module")
def one_process(runs):
    """The port in one process: decode and the f32 gradients of GRAD_CASES."""
    npz = runs[0]
    gcfg = get_smoke("granite-8b")
    model = build(gcfg)
    params = params_from_numpy(unflatten(_group(npz, "p.")), device="cpu")
    cache = {k: torch.from_numpy(v).bfloat16() for k, v in _group(npz, "cache.").items()}
    with torch.no_grad():
        lg, nc = model.decode_step(params, cache, torch.from_numpy(npz["toks"]).long(), 3)
    out = {"logits": lg.float().numpy(), **{f"cache.{k}": v.float().numpy() for k, v in nc.items()}}
    out.update(_decode_sequence(model, params, npz, model.cache_specs(4, 16)))
    with torch.no_grad():
        plg, _ = model.prefill(params, {"tokens": torch.from_numpy(npz["tokens"]).long()})
    out["prefill_logits"] = plg.float().numpy()
    old = TL.COMPUTE_DTYPE
    TL.COMPUTE_DTYPE = torch.float32
    try:
        for i, (arch, over) in enumerate(GRAD_CASES):
            cfg = _config(arch, over)
            gmodel, gparams, gbatch = _grad_inputs(cfg, i)
            if cfg.family == "moe":  # the mesh's loss: the mean of its data shards' losses
                parts = [_grads(gmodel, gparams, {k: v[j * 2:(j + 1) * 2] for k, v in gbatch.items()})
                         for j in range(2)]
                loss = (parts[0][0] + parts[1][0]) / 2
                g = {k: (parts[0][1][k] + parts[1][1][k]) / 2 for k in parts[0][1]}
            else:
                loss, g = _grads(gmodel, gparams, gbatch)
            out[f"grad{i}.loss"] = float(loss)
            out.update({f"grad{i}.{k}": v.numpy() for k, v in g.items()})
    finally:
        TL.COMPUTE_DTYPE = old
    return out


# -- the checks --------------------------------------------------------------------
def _max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_moe_matches_the_local_and_mesh_paths(runs):
    _, local, jmesh, ranks = runs
    for r in ranks:
        assert _max_diff(r["moe_y"], local["moe_y"]) < MOE_TOL
        assert _max_diff(r["moe_y"], jmesh["moe_y"]) < MOE_TOL
        assert abs(float(r["moe_aux"]) - float(jmesh["moe_aux"])) < AUX_TOL


def test_decode_matches_the_local_and_mesh_paths(runs):
    """The first layer's cache (written from the embedding alone) within
    CACHE_TOL of the JAX package's (it is equal); the second's within
    ``CACHE_BF16_REL`` of its largest value, the bound
    ``tests/test_torch_families.py`` holds bf16 caches to: the port rounds
    attention's bf16 products differently from the JAX package, in one
    process as over the mesh (which equals the port's one process exactly,
    next test; one bf16 step, 0.0625, here)."""
    _, local, jmesh, ranks = runs
    for ref in (local, jmesh):
        for r in ranks:
            assert _max_diff(r["logits"], ref["logits"]) < LOGIT_TOL
            for name in ("k", "v"):
                got, want = r[f"cache.{name}"], ref[f"cache.{name}"]
                assert _max_diff(got[0], want[0]) <= CACHE_TOL, name
                assert _max_diff(got, want) <= CACHE_BF16_REL * np.abs(want).max(), name


def test_decode_matches_one_process_and_leaves_other_shards(runs, one_process):
    """Position 3 lies in the first model rank's shard: the ranks with model
    coordinate 1 (ranks 1 and 3) write nothing, and their shards see no key."""
    _, _, _, ranks = runs
    for r in ranks:
        assert _max_diff(r["logits"], one_process["logits"]) == 0.0
        for name in ("k", "v"):
            assert _max_diff(r[f"cache.{name}"], one_process[f"cache.{name}"]) == 0.0
    assert [r["shard_unchanged"] for r in ranks] == [False, True, False, True]


def test_decode_across_both_cache_shards_matches_one_process(runs, one_process):
    """Positions 0-11 from an empty cache: from position 8 the second model
    rank's shard holds keys too and the ranks' partial attentions combine by
    their lse (a combine that ignores the lse moves the logits by ~1).  The
    logits within LOGIT_TOL of the port in one process; the caches within
    SEQ_CACHE_REL (relative L2), their first layer equal."""
    _, _, _, ranks = runs
    for r in ranks:
        assert _max_diff(r["seq.logits"], one_process["seq.logits"]) < LOGIT_TOL
        for name in ("k", "v"):
            got, want = np.asarray(r[f"seq.{name}"]), np.asarray(one_process[f"seq.{name}"])
            assert _max_diff(got[0], want[0]) == 0.0, name
            assert np.linalg.norm(got - want) <= SEQ_CACHE_REL * np.linalg.norm(want), name


def test_prefill_runs_on_the_mesh(runs, one_process):
    """granite-smoke's prefill of 4 x 16 tokens under SERVE_RULES: every rank
    gives the last logits whole (within LOGIT_TOL of one process) and holds
    its shard of the 16-slot cache (``tests/test_torch_mesh_prefill.py``
    holds every family's cache)."""
    for r in runs[3]:
        assert _max_diff(r["prefill_logits"], one_process["prefill_logits"]) < LOGIT_TOL
        assert all(got == want for got, want in r["prefill_shapes"])
        assert [got[2] for got, _ in r["prefill_shapes"]] == [8, 8]


@pytest.mark.parametrize("sga", [False, True], ids=["accumulate", "shard_grad_accum"])
def test_train_step_matches_the_local_and_mesh_paths(runs, sga):
    npz, local, jmesh, ranks = runs
    i = int(sga)
    for ref in (local, jmesh):
        for r in ranks:
            assert abs(float(r[f"loss{i}"]) - float(ref[f"loss{i}"])) < LOSS_TOL
            for k in _group(npz, "p."):
                assert _max_diff(r[f"params{i}.{k}"], ref[f"params{i}.{k}"]) < PARAM_TOL, k
    assert float(ranks[0][f"grad_norm{i}"]) > 0


@pytest.mark.parametrize("case", range(len(GRAD_CASES)),
                         ids=[f"{a}-{'-'.join(f'{k}{v}' for k, v in o.items()) or 'smoke'}"
                              for a, o in GRAD_CASES])
def test_gradients_match_one_process_in_f32(runs, one_process, case):
    """Every leaf's gradient of the mean loss, unsharded, on every rank."""
    _, _, _, ranks = runs
    names = [k[len(f"grad{case}."):] for k in one_process if k.startswith(f"grad{case}.")
             and k != f"grad{case}.loss"]
    for r in ranks:
        assert abs(float(r[f"grad{case}.loss"]) - one_process[f"grad{case}.loss"]) < 1e-5
        for k in names:
            want = one_process[f"grad{case}.{k}"]
            assert _max_diff(r[f"grad{case}.{k}"], want) <= GRAD_RTOL * np.abs(want).max(), k


def test_global_norm_counts_replicated_leaves_once(runs):
    """Norm scales are whole on every rank, embed split over both axes, wk over
    data only: the norm of the shards equals the norm of the whole leaves."""
    model = build(get_smoke("granite-8b"))
    gen = torch.Generator().manual_seed(5)
    leaves = {k: torch.randn(s.shape, generator=gen) for k, s in model.param_specs().items()}
    want = float(topt.global_norm(leaves))
    for r in runs[3]:
        assert abs(float(r["norm"]) - want) <= 1e-5 * want

