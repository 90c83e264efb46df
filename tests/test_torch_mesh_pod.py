"""The ``pod`` axis on the port's live mesh, held against the JAX package on the CPU.

One 2 x 2 x 2 ``("pod", "data", "model")`` world of eight Gloo processes (a
module fixture) runs, each rank on its shards of weights made by the JAX
package's ``init_params``, the checks of ``tests/test_torch_mesh.py`` with
every rule table's ``batch`` (and TRAIN_RULES' FSDP ``embed`` and
``expert_embed``) over the product axis ``("pod", "data")``:

* the expert-parallel MoE: qwen3-moe-smoke, capacity factor 64, x (4, 8, d)
  bf16 under ``TRAIN_RULES`` (a row a ``(pod, data)`` rank; the aux loss the
  mean over all eight ranks);
* decode under ``DECODE_RULES``: granite-smoke, batch 4 over ``(pod,
  data)``, a seeded 16-slot cache split over ``model`` at position 3; and
  teacher-forced over positions 0-5 from an empty cache of 7 slots, which
  ``model`` does not divide, so that every rank holds it whole
  (``logical_to_spec``'s fallback; ``MeshCtx(...).for_cache(7)``);
* prefill under ``SERVE_RULES``: 4 x 16 tokens;
* a train step under ``TRAIN_RULES``: 8 x 16 tokens in 2 microbatches, with
  and without ``shard_grad_accum``;
* hymba-smoke (the SSM beside attention): decode in long mode under
  ``LONG_RULES`` (batch 1 on every rank, its 32-slot ring split over
  ``model``) at positions 3 and 40 from a seeded ring, and a train step;
* the collectives rank 0 counts for granite's prefill, decode step and
  train step, equal to ``launch/dryrun.py::estimate``'s trace of the same
  steps on a 2 x 2 x 2 ``TraceMesh``;
* ``ProcessMesh.axis(("pod", "data"))``, ``unshard`` and ``MeshCtx.pmean``
  over the product axis;
* a hymba-smoke train state checkpointed from the 2 x 2 x 2 world through
  rank 0's Shelby cluster, restored into a 2 x 2 ``("data", "model")``
  world (the cluster passed on pickled), trained a step there, saved, and
  restored back into a 2 x 2 x 2 world: each restore equal, bit for bit,
  to the state saved.

Yardsticks: the JAX package's local path and its own mesh path on a 2 x 2
x 2 ``jax.sharding.Mesh`` of 8 fake devices (auto axes; ``jax.make_mesh``'s
explicit axes do not lower these steps in this jax, ROADMAP Queue 3 item
4), both in one subprocess, and the port in one process.  Tolerances are
``tests/test_torch_mesh.py``'s: MoE y 0.05, aux 1e-5 against the JAX mesh
path; the decode over the split cache equal to the port's one process (its
logits and caches), the first layer's caches within 1e-6 of the JAX paths,
deeper layers within 2^-4 of their largest value; loss 0.02, parameters
after a step 1e-5.  Logits against the JAX paths hold ``tests/
test_torch_mesh_{prefill,families}.py``'s bound between the packages, 0.15
(at these inputs the port's one process is itself 0.085 from the JAX
package's decode: the packages round bf16 products at other places, ROADMAP
Queue 3 item 11), and 0.05 against the port's one process; caches within
2^-4 of their largest value.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import launch, make_local_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build
from repro_torch.sharding import (DECODE_RULES, LONG_RULES, SERVE_RULES, TRAIN_RULES, MeshCtx,
                                  cache_slots, flatten, params_from_numpy, unflatten, unshard)
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
POD, DATA, MODEL = 2, 2, 2
MOE_TOL, LOGIT_TOL, CACHE_TOL, LOSS_TOL, PARAM_TOL, AUX_TOL = 0.05, 0.05, 1e-6, 0.02, 1e-5, 1e-5
JAX_LOGIT_TOL, CACHE_BF16_REL = 0.15, 2**-4
BATCH, SLOTS, POS, SEQ, TRAIN_BATCH, MICROBATCHES = 4, 16, 3, 16, 8, 2
ODD_SLOTS, ODD_STEPS = 7, 6  # the whole-cache decode: 7 slots, positions 0-5
LONG_SLOTS, LONG_POSITIONS = 64, (3, 40)  # hymba-smoke's ring: 32 slots, 16 a model rank
TRACE_SHAPES = {"prefill": ShapeCell("prefill_32k", SEQ, BATCH, "prefill"),
                "decode": ShapeCell("decode_32k", SEQ, BATCH, "decode"),
                "train": ShapeCell("train_4k", SEQ, TRAIN_BATCH, "train")}


def _cfg(arch: str):
    cfg = get_smoke(arch)
    if cfg.moe is not None:  # nothing dropped: the local path and the mesh keep every token
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    return cfg


def _group(npz, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix)}


def _jit0(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's CPU optimisation level 0."""
    import jax

    exe = jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})
    return exe(*args)


def _inputs(path: pathlib.Path) -> None:
    """The checks' weights (the JAX package's ``init_params``), seeded caches and
    batches, written to ``path`` (an npz of flat dotted keys)."""
    import jax

    from repro.models import moe as jmoe
    from repro.models.model import build as jbuild
    from repro.sharding import init_params

    rng = np.random.default_rng(0)
    out = {}
    mcfg = _cfg("qwen3-moe-30b-a3b")
    moe = _jit0(lambda k: init_params(jmoe.moe_specs(mcfg, layers=1), k), jax.random.PRNGKey(1))
    out.update({f"moe.{k}": np.asarray(v)[0] for k, v in flatten(moe).items()})
    out["moe_x"] = (rng.normal(size=(BATCH, 8, mcfg.d_model)) * 0.3).astype(np.float32)
    for key, arch, seed in (("g", "granite-8b", 2), ("h", "hymba-1.5b", 3)):
        cfg = _cfg(arch)
        model = jbuild(cfg)
        params = _jit0(lambda k, m=model: init_params(m.param_specs(), k), jax.random.PRNGKey(seed))
        out.update({f"{key}.p.{k}": np.asarray(v) for k, v in flatten(params).items()})
        out[f"{key}.tokens"] = rng.integers(0, cfg.vocab, (TRAIN_BATCH, SEQ)).astype(np.int32)
        out[f"{key}.labels"] = rng.integers(0, cfg.vocab, (TRAIN_BATCH, SEQ)).astype(np.int32)
    gmodel = jbuild(_cfg("granite-8b"))
    for name, spec in flatten(gmodel.cache_specs(BATCH, SLOTS)).items():
        out[f"g.cache.{name}"] = rng.normal(size=spec.shape).astype(np.float32)
    out["g.toks"] = out["g.tokens"][:BATCH, :1]
    hmodel = jbuild(_cfg("hymba-1.5b"))
    for name, spec in flatten(hmodel.cache_specs(1, LONG_SLOTS, long_mode=True)).items():
        out[f"h.ring.{name}"] = rng.normal(size=spec.shape).astype(np.float32)
    out["h.long_toks"] = rng.integers(0, hmodel.cfg.vocab, (1, max(LONG_POSITIONS) + 1)).astype(
        np.int32)
    np.savez(path, **out)


def jax_run(path: str, mesh: bool) -> dict:
    """Every check through the JAX package, local (``mesh`` False) or on a 2 x 2
    x 2 ``jax.sharding.Mesh`` of the process's eight devices."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro.models.model import build as jbuild
    from repro.sharding import DECODE_RULES as JD
    from repro.sharding import LONG_RULES as JL
    from repro.sharding import SERVE_RULES as JS
    from repro.sharding import TRAIN_RULES as JT
    from repro.sharding import AxisCtx
    from repro.train.optimizer import init_state
    from repro.train.step import make_train_step as jstep

    npz = np.load(path)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(POD, DATA, MODEL),
                              ("pod", "data", "model")) if mesh else None

    def ctx(rules):
        return AxisCtx(dict(rules), jmesh) if mesh else AxisCtx()

    def cache_of(model, prefix, *args, **kw):
        specs = flatten(model.cache_specs(*args, **kw))
        return {k: jnp.asarray(v, specs[k].dtype) for k, v in _group(npz, prefix).items()}

    out = {}
    mcfg = _cfg("qwen3-moe-30b-a3b")
    lp = {k: jnp.asarray(v) for k, v in _group(npz, "moe.").items()}
    y, aux = _jit0(lambda p, x: jmoe.apply_moe(p, x, mcfg, ctx(JT)), lp,
                   jnp.asarray(npz["moe_x"], jnp.bfloat16))
    out["moe_y"], out["moe_aux"] = np.asarray(y, np.float32), np.float32(aux)
    for key, arch in (("g", "granite-8b"), ("h", "hymba-1.5b")):
        cfg = _cfg(arch)
        model = jbuild(cfg)
        params = jax.tree.map(jnp.asarray, unflatten(_group(npz, f"{key}.p.")))
        batch = {"tokens": npz[f"{key}.tokens"], "labels": npz[f"{key}.labels"]}
        for sga in ((False, True) if key == "g" else (False,)):
            st, met = _jit0(jstep(cfg, ctx(JT), num_microbatches=MICROBATCHES,
                                  shard_grad_accum=sga), init_state(params), batch)
            out[f"{key}.loss{int(sga)}"] = np.float32(met["loss"])
            out.update({f"{key}.params{int(sga)}.{k}": np.asarray(v)
                        for k, v in flatten(st["params"]).items()})
        if key == "g":
            lg, nc = _jit0(lambda p, c, t, m=model: m.decode_step(p, c, t, jnp.int32(POS),
                                                                  ctx(JD)),
                           params, cache_of(model, "g.cache.", BATCH, SLOTS),
                           jnp.asarray(npz["g.toks"]))
            out["g.logits"] = np.asarray(lg, np.float32)
            out.update({f"g.cache.{k}": np.asarray(v, np.float32) for k, v in nc.items()})
            cache = {k: jnp.zeros(s.shape, s.dtype)
                     for k, s in flatten(model.cache_specs(BATCH, ODD_SLOTS)).items()}
            step = jax.jit(lambda p, c, t, pos, m=model: m.decode_step(p, c, t, pos, ctx(JD)))
            logits = []
            for pos in range(ODD_STEPS):
                lg, cache = step(params, cache, jnp.asarray(npz["g.tokens"][:BATCH, pos:pos + 1]),
                                 jnp.int32(pos))
                logits.append(np.asarray(lg, np.float32))
            out["g.odd.logits"] = np.stack(logits)
            out.update({f"g.odd.{k}": np.asarray(v, np.float32) for k, v in cache.items()})
            lg, pc = _jit0(lambda p, b, m=model: m.prefill(p, b, ctx(JS)), params,
                           {"tokens": jnp.asarray(npz["g.tokens"][:BATCH])})
            out["g.prefill_logits"] = np.asarray(lg, np.float32)
            out.update({f"g.prefill.{k}": np.asarray(v, np.float32) for k, v in pc.items()})
        else:
            toks = npz["h.long_toks"]
            for pos in LONG_POSITIONS:
                lg, nc = _jit0(lambda p, c, t, pos=pos, m=model: m.decode_step(
                    p, c, t, jnp.int32(pos), ctx(JL), long_mode=True),
                    params, cache_of(model, "h.ring.", 1, LONG_SLOTS, long_mode=True),
                    jnp.asarray(toks[:, pos:pos + 1]))
                out[f"h.long{pos}.logits"] = np.asarray(lg, np.float32)
                out.update({f"h.long{pos}.{k}": np.asarray(v, np.float32) for k, v in nc.items()})
    return out


_JAX = textwrap.dedent("""
    import os, sys
    # 8 fake devices, each computing on one thread: the suite's other workers share the cores
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false")
    sys.path.insert(0, {tests!r})
    import numpy as np
    from test_torch_mesh_pod import jax_run
    np.savez(sys.argv[2], **jax_run(sys.argv[1], mesh=True))
    np.savez(sys.argv[3], **jax_run(sys.argv[1], mesh=False))
""")


# -- the port's ranks ---------------------------------------------------------------
def _params(npz, key: str) -> dict:
    return params_from_numpy(unflatten(_group(npz, f"{key}.p.")), device="cpu")


def _batch(npz, key: str) -> dict:
    return {k: torch.from_numpy(npz[f"{key}.{k}"]).long() for k in ("tokens", "labels")}


def _odd_sequence(model, params, npz, ctx=None, mesh=None) -> dict:
    """granite teacher-forced over positions 0 to ODD_STEPS - 1 from an empty
    ODD_SLOTS-slot cache: every step's logits and the last cache, whole."""
    specs = model.cache_specs(BATCH, ODD_SLOTS)
    cache = {k: torch.zeros(s.shape if ctx is None else ctx.local_shape(s), dtype=s.dtype)
             for k, s in specs.items()}
    toks = torch.from_numpy(npz["g.tokens"][:BATCH]).long()
    logits = []
    with torch.no_grad():
        for pos in range(ODD_STEPS):
            lg, cache = model.decode_step(params, cache, toks[:, pos:pos + 1], pos, ctx)
            logits.append(lg.float())
    if ctx is not None:
        cache = unshard(cache, specs, ctx.rules, mesh)
    return {"g.odd.logits": torch.stack(logits), **{f"g.odd.{k}": v for k, v in cache.items()}}


def _trace_steps(mesh, npz) -> dict:
    """granite's prefill, decode step and train step at TRACE_SHAPES: the
    collectives each makes on this rank."""
    cfg = _cfg("granite-8b")
    model = build(cfg)
    params = _params(npz, "g")
    toks = torch.from_numpy(npz["g.tokens"]).long()
    out = {}
    sctx = MeshCtx(SERVE_RULES, mesh, cfg)
    sparams = sctx.shard(params, model.param_specs())
    before = dict(dryrun.D.moved), dict(dryrun.D.calls)
    make_prefill_step(cfg, sctx)(sparams, {"tokens": toks[:BATCH]})
    out["prefill"] = dryrun.collectives(before)
    dctx = MeshCtx(DECODE_RULES, mesh, cfg).for_cache(SEQ)
    cache = {k: torch.zeros(dctx.local_shape(s), dtype=s.dtype)
             for k, s in model.cache_specs(BATCH, SEQ).items()}
    dparams = dctx.shard(params, model.param_specs())
    before = dict(dryrun.D.moved), dict(dryrun.D.calls)
    make_decode_step(cfg, dctx)(dparams, cache, toks[:BATCH, :1], SEQ - 1)
    out["decode"] = dryrun.collectives(before)
    tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
    state = topt.init_state(tctx.shard(params, model.param_specs()))
    before = dict(dryrun.D.moved), dict(dryrun.D.calls)
    make_train_step(cfg, tctx, num_microbatches=MICROBATCHES)(
        state, {"tokens": toks, "labels": toks.roll(-1, 1)})
    out["train"] = dryrun.collectives(before)
    return out


def _axes(mesh) -> dict:
    """The product axis as a rank sees it, and a mean over it."""
    ax = mesh.axis(("pod", "data"))
    ctx = MeshCtx(TRAIN_RULES, mesh, _cfg("granite-8b"))
    x = torch.tensor([float(mesh.rank)])
    return {"pd": [ax.size, ax.index, mesh.coords["pod"], mesh.coords["data"]],
            "pd_mean": float(ctx.pmean(x, ("pod", "data"))),
            "world_mean": float(ctx.pmean(x, tuple(mesh.shape))),
            "model_mean": float(ctx.pmean(x, ("model",)))}


def _checkpoint_world(mesh, seed: int, cluster: str, restore: bool, train: bool) -> dict:
    """hymba-smoke's train state on this world's mesh through rank 0's Shelby
    cluster, read from the file ``cluster`` (pickled by an earlier world)
    where ``restore``, else a new one: restore its latest checkpoint (every
    rank returns it whole); then, where ``train``, train a step and save
    (every rank returns the whole state saved; rank 0 pickles the cluster
    to ``cluster``)."""
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.storage.checkpoint import CheckpointManager

    cfg = _cfg("hymba-1.5b")
    root = mesh.rank == 0
    mgr = None
    if root:
        mgr = (pickle.loads(pathlib.Path(cluster).read_bytes()) if restore
               else CheckpointManager(build_cluster(device="cpu")[3], num_host_shards=2))
    ctx = MeshCtx(TRAIN_RULES, mesh, cfg)
    trainer = Trainer(cfg, ctx=ctx, ckpt=mgr, ckpt_every=1)
    out = {"restored": None}
    if restore:
        state, step = trainer.restore_latest(None)
        out["restored"] = {k: unshard(state[k], trainer.specs, TRAIN_RULES, mesh)
                           for k in ("params", "m", "v")}
        out["restored_step"] = step
    else:
        state, step = trainer.init_state(seed), 0
    out["shapes"] = [list(state["params"][k].shape) for k in sorted(trainer.specs)]
    if not train:
        return out
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1))
    state, _ = trainer.run(state, iter([(toks[:, :-1], toks[:, 1:])]), 1, start_step=step)
    out["saved"] = {k: unshard(state[k], trainer.specs, TRAIN_RULES, mesh)
                    for k in ("params", "m", "v")}
    out["saved_step"] = step + 1
    if root:  # a node's single-flight table is rebuilt for each read's event loop: the last
        for node in mgr.client.fleet.rpcs:  # read's, with its hedged losers, does not pickle
            node._sf = None
        pathlib.Path(cluster).write_bytes(pickle.dumps(mgr))
    return out


def _rank(mesh, path: str) -> dict:
    npz = np.load(path)
    out = {"axes": _axes(mesh)}
    # the expert-parallel MoE over the rank's (pod, data) row of x
    mcfg = _cfg("qwen3-moe-30b-a3b")
    ctx = MeshCtx(TRAIN_RULES, mesh, mcfg)
    full = {f"blocks.moe.{k}": torch.from_numpy(v)[None] for k, v in _group(npz, "moe.").items()}
    shards = ctx.shard(full, ctx.specs)
    lp = {k.rsplit(".", 1)[-1]: ctx.gather(k, v[0]) for k, v in shards.items()}
    x = ctx.local_batch(torch.from_numpy(npz["moe_x"]).bfloat16())
    out["moe_rows"] = x.shape[0]
    with torch.no_grad():
        y, aux = tmoe.apply_moe(lp, x, mcfg, ctx)
    out["moe_y"], out["moe_aux"] = ctx.whole_batch(y), aux
    # granite: decode over a seeded 16-slot cache split over model, then over a whole 7-slot one
    gcfg = _cfg("granite-8b")
    model = build(gcfg)
    params = _params(npz, "g")
    cache_specs = model.cache_specs(BATCH, SLOTS)
    dctx = MeshCtx(DECODE_RULES, mesh, gcfg).for_cache(SLOTS)
    cache = dctx.shard({k: torch.from_numpy(v).bfloat16() for k, v in _group(npz, "g.cache.").items()},
                       cache_specs)
    dparams = dctx.shard(params, model.param_specs())
    with torch.no_grad():
        lg, nc = model.decode_step(dparams, cache, torch.from_numpy(npz["g.toks"]).long(), POS,
                                   dctx)
    out["g.logits"] = lg
    out.update({f"g.cache.{k}": v for k, v in unshard(nc, cache_specs, DECODE_RULES, mesh).items()})
    out["g.cache_rows"] = nc["k"].shape[1]
    out.update(_odd_sequence(model, dparams, npz, dctx.for_cache(ODD_SLOTS), mesh))
    # prefill under SERVE_RULES
    sctx = MeshCtx(SERVE_RULES, mesh, gcfg)
    with torch.no_grad():
        plg, pcache = model.prefill(sctx.shard(params, model.param_specs()),
                                    {"tokens": torch.from_numpy(npz["g.tokens"][:BATCH]).long()},
                                    sctx)
    out["g.prefill_logits"] = plg
    out.update({f"g.prefill.{k}": v for k, v in
                unshard(pcache, model.cache_specs(BATCH, SEQ), SERVE_RULES, mesh).items()})
    # train steps: granite with and without shard_grad_accum, hymba
    for key, arch, sgas in (("g", "granite-8b", (False, True)), ("h", "hymba-1.5b", (False,))):
        cfg = _cfg(arch)
        tmodel = build(cfg)
        tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
        for sga in sgas:
            state = topt.init_state(tctx.shard(_params(npz, key), tmodel.param_specs()))
            step = make_train_step(cfg, tctx, num_microbatches=MICROBATCHES, shard_grad_accum=sga)
            new, met = step(state, _batch(npz, key))
            out[f"{key}.loss{int(sga)}"] = met["loss"]
            out.update({f"{key}.params{int(sga)}.{k}": v for k, v in
                        unshard(new["params"], tmodel.param_specs(), TRAIN_RULES, mesh).items()})
    # hymba in long mode: the ring over model, batch 1 on every rank
    hcfg = _cfg("hymba-1.5b")
    hmodel = build(hcfg)
    long_specs = hmodel.cache_specs(1, LONG_SLOTS, long_mode=True)
    lctx = MeshCtx(LONG_RULES, mesh, hcfg).for_cache(cache_slots(long_specs))
    lparams = lctx.shard(_params(npz, "h"), hmodel.param_specs())
    toks = torch.from_numpy(npz["h.long_toks"]).long()
    for pos in LONG_POSITIONS:
        ring = lctx.shard({k: torch.from_numpy(v).to(long_specs[k].dtype)
                           for k, v in _group(npz, "h.ring.").items()}, long_specs)
        with torch.no_grad():
            lg, nc = hmodel.decode_step(lparams, ring, toks[:, pos:pos + 1], pos, lctx,
                                        long_mode=True)
        out[f"h.long{pos}.logits"] = lg
        out.update({f"h.long{pos}.{k}": v
                    for k, v in unshard(nc, long_specs, LONG_RULES, mesh).items()})
    out["trace"] = _trace_steps(mesh, npz)
    out["ckpt"] = _checkpoint_world(mesh, 11, str(pathlib.Path(path).with_name("cluster.pkl")),
                                    False, True)
    return out


# -- fixtures ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX local, JAX mesh, the port's ranks, the inputs' path): the
    JAX subprocess and the port's world run side by side."""
    tmp = tmp_path_factory.mktemp("mesh_pod")
    inputs = tmp / "inputs.npz"
    jax_out = [tmp / f"jax_{name}.npz" for name in ("mesh", "local")]
    _inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX.format(tests=str(ROOT / "tests")), str(inputs),
         *map(str, jax_out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = launch(_rank, str(inputs), pod=POD, data=DATA, model=MODEL, device="cpu",
                   timeout=600)
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    jmesh, local = (dict(np.load(p)) for p in jax_out)
    return np.load(inputs), local, jmesh, ranks, inputs


@pytest.fixture(scope="module")
def one_process(runs):
    """The port in one process: the decodes and the prefill."""
    npz = runs[0]
    model = build(_cfg("granite-8b"))
    params = _params(npz, "g")
    cache = {k: torch.from_numpy(v).bfloat16() for k, v in _group(npz, "g.cache.").items()}
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            lg, nc = model.decode_step(params, cache, torch.from_numpy(npz["g.toks"]).long(), POS)
            out = {"g.logits": lg, **{f"g.cache.{k}": v for k, v in nc.items()}}
            out.update(_odd_sequence(model, params, npz))
            plg, pc = model.prefill(params, {"tokens": torch.from_numpy(npz["g.tokens"][:BATCH])
                                             .long()})
            out["g.prefill_logits"] = plg
            out.update({f"g.prefill.{k}": v for k, v in pc.items()})
            hmodel = build(_cfg("hymba-1.5b"))
            hparams = _params(npz, "h")
            specs = hmodel.cache_specs(1, LONG_SLOTS, long_mode=True)
            toks = torch.from_numpy(npz["h.long_toks"]).long()
            for pos in LONG_POSITIONS:
                ring = {k: torch.from_numpy(v).to(specs[k].dtype)
                        for k, v in _group(npz, "h.ring.").items()}
                lg, nc = hmodel.decode_step(hparams, ring, toks[:, pos:pos + 1], pos,
                                            long_mode=True)
                out[f"h.long{pos}.logits"] = lg
                out.update({f"h.long{pos}.{k}": v for k, v in nc.items()})
    finally:
        torch.set_num_threads(old)
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def checkpoint_worlds(runs):
    """The 2 x 2 x 2 world's checkpoint restored into a 2 x 2 world, which
    trains a step and saves; that restored back into a 2 x 2 x 2 world."""
    first = runs[3][0]["ckpt"]
    cluster = str(runs[4].with_name("cluster.pkl"))  # rank 0 of each world reads and writes it
    two = launch(_checkpoint_world, 12, cluster, True, True, data=DATA, model=MODEL,
                 device="cpu", timeout=600)
    back = launch(_checkpoint_world, 13, cluster, True, False, pod=POD, data=DATA, model=MODEL,
                  device="cpu", timeout=600)
    return first, two, back


# -- the checks --------------------------------------------------------------------
def _max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_the_product_axis_and_its_mean(runs):
    """``axis(("pod", "data"))``: the four ranks of a ``model`` coordinate,
    pod-major; ``pmean`` over it, over ``model`` and over the world."""
    ranks = runs[3]
    for rank, r in enumerate(ranks):
        size, index, pod, data = r["axes"]["pd"]
        model = rank % MODEL
        assert (size, index) == (POD * DATA, pod * DATA + data)
        assert rank == (pod * DATA + data) * MODEL + model
        same = [q for q in range(len(ranks)) if q % MODEL == model]
        assert float(r["axes"]["pd_mean"]) == pytest.approx(np.mean(same))
        assert float(r["axes"]["world_mean"]) == pytest.approx(np.mean(range(len(ranks))))
        assert float(r["axes"]["model_mean"]) == pytest.approx(rank - model + 0.5)


def test_moe_matches_the_local_and_mesh_paths(runs):
    _, local, jmesh, ranks, _ = runs
    for r in ranks:
        assert r["moe_rows"] == BATCH // (POD * DATA)
        assert _max_diff(r["moe_y"], local["moe_y"]) < MOE_TOL
        assert _max_diff(r["moe_y"], jmesh["moe_y"]) < MOE_TOL
        assert abs(float(r["moe_aux"]) - float(jmesh["moe_aux"])) < AUX_TOL


def test_decode_matches_the_local_and_mesh_paths_and_one_process(runs, one_process):
    _, local, jmesh, ranks, _ = runs
    for r in ranks:
        assert r["g.cache_rows"] == BATCH // (POD * DATA)
        assert _max_diff(r["g.logits"], one_process["g.logits"]) == 0.0
        for ref in (local, jmesh):
            assert _max_diff(r["g.logits"], ref["g.logits"]) < JAX_LOGIT_TOL
        for name in ("k", "v"):
            got = r[f"g.cache.{name}"]
            assert _max_diff(got, one_process[f"g.cache.{name}"]) == 0.0, name
            for ref in (local, jmesh):
                want = ref[f"g.cache.{name}"]
                assert _max_diff(got[0], want[0]) <= CACHE_TOL, name
                assert _max_diff(got, want) <= CACHE_BF16_REL * np.abs(want).max(), name


def test_decode_over_a_whole_seven_slot_cache(runs, one_process):
    """7 slots do not split over ``model``: every rank holds the whole cache
    (its row of the batch) and decodes without the combine."""
    _, local, jmesh, ranks, _ = runs
    for r in ranks:
        assert _max_diff(r["g.odd.logits"], one_process["g.odd.logits"]) < LOGIT_TOL
        for ref in (local, jmesh):
            assert _max_diff(r["g.odd.logits"], ref["g.odd.logits"]) < JAX_LOGIT_TOL
        for name in ("k", "v"):
            got = r[f"g.odd.{name}"]
            assert got.shape[2] == ODD_SLOTS
            for ref in (one_process, local, jmesh):
                want = ref[f"g.odd.{name}"]
                assert _max_diff(got, want) <= CACHE_BF16_REL * np.abs(want).max(), name


def test_prefill_matches_the_local_and_mesh_paths_and_one_process(runs, one_process):
    _, local, jmesh, ranks, _ = runs
    for r in ranks:
        assert _max_diff(r["g.prefill_logits"], one_process["g.prefill_logits"]) < LOGIT_TOL
        for ref in (local, jmesh):
            assert _max_diff(r["g.prefill_logits"], ref["g.prefill_logits"]) < JAX_LOGIT_TOL
        for name in ("k", "v"):
            for ref in (one_process, local, jmesh):
                want = ref[f"g.prefill.{name}"]
                got = r[f"g.prefill.{name}"]
                assert _max_diff(got, want) <= CACHE_BF16_REL * np.abs(want).max(), name


@pytest.mark.parametrize("case", ["g0", "g1", "h0"],
                         ids=["granite-accumulate", "granite-shard_grad_accum", "hymba"])
def test_train_step_matches_the_local_and_mesh_paths(runs, case):
    npz, local, jmesh, ranks, _ = runs
    key, i = case[0], case[1]
    names = [k[len(f"{key}.p."):] for k in npz.files if k.startswith(f"{key}.p.")]
    for ref in (local, jmesh):
        for r in ranks:
            assert abs(float(r[f"{key}.loss{i}"]) - float(ref[f"{key}.loss{i}"])) < LOSS_TOL
            for k in names:
                assert _max_diff(r[f"{key}.params{i}.{k}"], ref[f"{key}.params{i}.{k}"]) \
                    < PARAM_TOL, k


@pytest.mark.parametrize("pos", LONG_POSITIONS)
def test_hymba_long_mode_matches_the_local_and_mesh_paths(runs, one_process, pos):
    """The ring split over ``model`` beside the SSM's channels: at position 3
    the second model rank's slots are unwritten, at 40 the ring has wrapped."""
    _, local, jmesh, ranks, _ = runs
    for r in ranks:
        assert _max_diff(r[f"h.long{pos}.logits"], one_process[f"h.long{pos}.logits"]) < LOGIT_TOL
        for ref in (local, jmesh):
            assert _max_diff(r[f"h.long{pos}.logits"], ref[f"h.long{pos}.logits"]) < JAX_LOGIT_TOL
        for ref in (one_process, local, jmesh):
            for name in ("k", "v", "conv", "h_ssm"):
                want, got = ref[f"h.long{pos}.{name}"], r[f"h.long{pos}.{name}"]
                assert _max_diff(got, want) <= CACHE_BF16_REL * np.abs(want).max(), name


@pytest.mark.parametrize("kind", TRACE_SHAPES)
def test_trace_counts_equal_the_live_collectives(runs, kind):
    """``estimate`` on a 2 x 2 x 2 trace mesh counts, per kind, the bytes and
    calls every live rank made for the same step."""
    rec = dryrun.estimate(_cfg("granite-8b"), TRACE_SHAPES[kind],
                          make_local_mesh(DATA, MODEL, pod=POD),
                          microbatch_override=MICROBATCHES if kind == "train" else None)
    assert rec["collectives"]["all-reduce"]["count"] > 0
    for r in runs[3]:
        assert r["trace"][kind] == rec["collectives"], (kind, r["trace"][kind])


def _equal(a: dict, b: dict) -> bool:
    fa, fb = flatten(a), flatten(b)
    return list(fa) == list(fb) and all(np.array_equal(x, y) for x, y in zip(fa.values(),
                                                                           fb.values()))


def test_checkpoint_round_trip_between_2x2x2_and_2x2(checkpoint_worlds):
    first, two, back = checkpoint_worlds
    for r in two:
        assert r["restored_step"] == first["saved_step"] == 1
        assert _equal(r["restored"], first["saved"])
    for r in back:
        assert r["restored_step"] == two[0]["saved_step"] == 2
        assert _equal(r["restored"], two[0]["saved"])
    # the shards differ between the meshes: (pod, data) splits embed four ways, data two
    assert back[0]["shapes"] != two[0]["shapes"] and back[0]["shapes"] == first["shapes"]
