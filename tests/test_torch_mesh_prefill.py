"""Prefill on the port's mesh, for every family, held against the JAX package on the CPU.

One 2 x 2 ``("data", "model")`` world of four Gloo processes (a module
fixture) runs ``DecoderLM.prefill`` / ``EncDecLM.prefill`` under
``SERVE_RULES`` through a ``MeshCtx``, each rank on its shards of weights
made by the JAX package's ``init_params``: granite (its kv heads split over
model), yi with one kv head (kv heads whole), qwen3-moe (the
expert-parallel MoE, capacity factor 100: nothing dropped), deepseek (MLA,
its leading dense layer keeping no cache), falcon-mamba (no cache),
hymba (attention's K/V beside the SSM), phi-3-vision (embedding inputs) and
whisper (the encoder over each rank's frames, one BOS token), all at their
smoke widths, over a batch of 4 x 16 (whisper: 4 x its 32 frames).  Each
rank returns the logits of the last position whole and its shard of the
cache as ``logical_to_spec`` lays out ``cache_specs`` under SERVE_RULES
(batch over data, 8 of the 16 slots a model rank; whisper's one slot does
not split, so its kv heads take model), gathered here by ``unshard``.

Yardsticks: the port in one process, and the JAX package's prefill on its
local path and on its own 2 x 2 ``jax.sharding.Mesh`` (auto axes, ROADMAP
Queue 3 item 4) under SERVE_RULES, all three JAX runs (the local one also
in f32) in one subprocess with one thread per fake device.  Against the
port's one process, the mesh tests' bounds (``tests/
test_torch_mesh_families.py``): logits within 0.05; the caches that the
embedding alone writes (the first layer's k/v) within 1e-6, every cache
within 2^-4 of its largest value (deepseek's MoE-layer latents and
whisper's ``enc_out`` come out of bf16 products in every layer).  Against
the JAX paths, the bounds ``tests/test_torch_families.py`` and
``tests/test_torch_encdec.py`` hold the port's own prefill to: logits
within 0.15 plus the JAX package's own bf16 error on them (its bf16
against its f32 logits), caches within 2^-4 of their largest value plus
that error.  The port's one process is itself outside the mesh tests'
bounds from the JAX package here (ROADMAP Queue 3 item 14): granite's
first-layer k one bf16 step apart in 3 of 2,048 entries, whisper's logits
0.29 apart.

Also held: the mesh form of ``tests/test_models.py::test_decode_matches_prefill``
(greedy decode from an empty cache under DECODE_RULES against the mesh
prefill at every prefix of 6 tokens, the reference's bounds 0.25 and top-1
agreement of at least half; the prefixes of odd length keep their slots
whole, ``logical_to_spec``'s fallback; the decode cache holds 8 slots, 4 a
rank, since a decode cache with a count of slots a rank that model does
not divide would be either whole or a shard); the dry-run's meta trace
(``launch/dryrun.py::estimate`` on a 2 x 2 ``TraceMesh``) making exactly
the collectives, by kind, bytes and calls, that a live rank makes for
granite's prefill, decode and train step; and, on the meta device, a
prefill that holds its cache once.
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
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import CostAnalysis
from repro_torch.launch.mesh import launch, make_local_mesh
from repro_torch.launch.shapes import serve_param_specs
from repro_torch.models.layers import MaskSpec, apply_norm
from repro_torch.models.model import _logits, build
from repro_torch.sharding import (DECODE_RULES, SERVE_RULES, TRAIN_RULES, AxisCtx, MeshCtx,
                                  params_from_numpy, unflatten, unshard)
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = {"granite": ("granite-8b", {}), "yi": ("yi-9b", {"num_kv_heads": 1}),
         "moe": ("qwen3-moe-30b-a3b", {}), "mla": ("deepseek-v2-lite-16b", {}),
         "mamba": ("falcon-mamba-7b", {}), "hymba": ("hymba-1.5b", {}),
         "phi3": ("phi-3-vision-4.2b", {}), "whisper": ("whisper-tiny", {})}
DECODE_KEYS = ("granite", "yi", "moe", "mla", "mamba", "hymba")  # token inputs, decoder-only
BATCH, SEQ = 4, 16
PREFIXES, DECODE_SLOTS = 6, 8
JAX_LOGIT_TOL, LOGIT_TOL, CACHE_TOL, CACHE_BF16_REL = 0.15, 0.05, 1e-6, 2**-4
DECODE_TOL, TOP1 = 0.25, 0.5  # tests/test_models.py::test_decode_matches_prefill
TRACE_SHAPES = {"prefill": ShapeCell("prefill_32k", SEQ, BATCH, "prefill"),
                "decode": ShapeCell("decode_32k", SEQ, BATCH, "decode"),
                "train": ShapeCell("train_4k", SEQ, BATCH, "train")}
TRACE_MICROBATCHES = 2


def _config(key: str):
    arch, over = ARCHS[key]
    cfg = dataclasses.replace(get_smoke(arch), **over)
    if cfg.moe is not None:  # drop-free, as the reference's decode-vs-prefill test
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    return cfg


def _jit0(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's CPU optimisation level 0."""
    import jax

    exe = jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})
    return exe(*args)


def _group(npz, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: npz[k] for k in npz.files if k.startswith(prefix)}


def _batch(npz, key: str, cfg) -> dict:
    if cfg.is_encdec:
        return {"frames": npz[f"{key}.frames"]}
    if cfg.input_mode == "embeddings":
        return {"embeddings": npz[f"{key}.embeddings"]}
    return {"tokens": npz[f"{key}.tokens"]}


def _inputs(path: pathlib.Path) -> None:
    """Each family's weights (the JAX package's ``init_params``) and batch, to an npz."""
    import jax

    from repro.models.model import build as jbuild
    from repro.sharding import init_params

    from repro_torch.sharding import flatten

    rng = np.random.default_rng(0)
    out = {}
    for i, key in enumerate(ARCHS):
        cfg = _config(key)
        model = jbuild(cfg)
        params = _jit0(lambda k, m=model: init_params(m.param_specs(), k), jax.random.PRNGKey(20 + i))
        out.update({f"{key}.p.{k}": np.asarray(v) for k, v in flatten(params).items()})
        out[f"{key}.tokens"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        if cfg.is_encdec:
            out[f"{key}.frames"] = (rng.normal(size=(BATCH, cfg.enc_seq, cfg.d_model))
                                    * 0.5).astype(np.float32)
        elif cfg.input_mode == "embeddings":
            out[f"{key}.embeddings"] = (rng.normal(size=(BATCH, SEQ, cfg.d_model))
                                        * 0.5).astype(np.float32)
    np.savez(path, **out)


def jax_run(path: str, mesh: bool, f32: bool = False) -> dict:
    """Every family's prefill through the JAX package, local (``mesh`` False)
    or on a 2 x 2 ``jax.sharding.Mesh`` under SERVE_RULES; in f32 compute
    where ``f32``."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro.models.model import build as jbuild
    from repro.sharding import SERVE_RULES as JS
    from repro.sharding import AxisCtx

    if f32:
        JL.COMPUTE_DTYPE = jnp.float32

    npz = np.load(path)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model")) \
        if mesh else None
    ctx = AxisCtx(dict(JS), jmesh) if mesh else AxisCtx()
    out = {}
    for key in ARCHS:
        cfg = _config(key)
        model = jbuild(cfg)
        params = jax.tree.map(jnp.asarray, unflatten(_group(npz, f"{key}.p.")))
        batch = {k: jnp.asarray(v) for k, v in _batch(npz, key, cfg).items()}
        lg, cache = _jit0(lambda p, b, m=model: m.prefill(p, b, ctx), params, batch)
        out[f"{key}.logits"] = np.asarray(lg, np.float32)
        out.update({f"{key}.cache.{k}": np.asarray(v, np.float32) for k, v in cache.items()})
    return out


_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    sys.path.insert(0, {tests!r})
    import numpy as np
    from test_torch_mesh_prefill import jax_run
    np.savez(sys.argv[2], **jax_run(sys.argv[1], mesh=True))
    np.savez(sys.argv[3], **jax_run(sys.argv[1], mesh=False))
    np.savez(sys.argv[4], **jax_run(sys.argv[1], mesh=False, f32=True))
""")


# -- the port's ranks ---------------------------------------------------------------
def _port_batch(npz, key: str, cfg) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in _batch(npz, key, cfg).items()}


def _params(npz, key: str) -> dict:
    return params_from_numpy(unflatten(_group(npz, f"{key}.p.")), device="cpu")


def _cache_specs(model, cfg, rows: int, seq: int) -> dict:
    return model.cache_specs(rows, 1 if cfg.is_encdec else seq)


def _decode_vs_prefill(model, cfg, params, toks, sctx, mesh) -> dict:
    """Greedy decode from an empty DECODE_SLOTS-slot cache under DECODE_RULES,
    teacher-forced over ``toks``, and the mesh prefill of every prefix: the
    last position's logits of each."""
    dctx = MeshCtx(DECODE_RULES, mesh, cfg)
    dparams = dctx.shard(params, model.param_specs())
    sparams = sctx.shard(params, model.param_specs())
    cache = {k: torch.zeros(dctx.local_shape(s), dtype=s.dtype)
             for k, s in model.cache_specs(BATCH, DECODE_SLOTS).items()}
    dec, pre = [], []
    with torch.no_grad():
        for pos in range(PREFIXES):
            lg, cache = model.decode_step(dparams, cache, toks[:, pos:pos + 1], pos, dctx)
            dec.append(lg[:, 0].float())
            lg, _ = model.prefill(sparams, {"tokens": toks[:, :pos + 1]}, sctx)
            pre.append(lg[:, 0].float())
    return {"decode": torch.stack(dec), "prefill": torch.stack(pre)}


def _trace_steps(mesh, npz) -> dict:
    """granite's prefill, decode and train step on the mesh at TRACE_SHAPES:
    the collectives each makes on this rank (``dryrun.collectives``)."""
    cfg = _config("granite")
    model = build(cfg)
    params = _params(npz, "granite")
    toks = torch.from_numpy(npz["granite.tokens"]).long()
    out = {}
    sctx = MeshCtx(SERVE_RULES, mesh, cfg)
    sparams = sctx.shard(params, model.param_specs())
    before = dict(dryrun.D.moved), dict(dryrun.D.calls)
    make_prefill_step(cfg, sctx)(sparams, {"tokens": toks})
    out["prefill"] = dryrun.collectives(before)
    dctx = MeshCtx(DECODE_RULES, mesh, cfg)
    cache = {k: torch.zeros(dctx.local_shape(s), dtype=s.dtype)
             for k, s in model.cache_specs(BATCH, SEQ).items()}
    dparams = dctx.shard(params, model.param_specs())
    before = dict(dryrun.D.moved), dict(dryrun.D.calls)
    make_decode_step(cfg, dctx)(dparams, cache, toks[:, :1], SEQ - 1)
    out["decode"] = dryrun.collectives(before)
    tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
    state = topt.init_state(tctx.shard(params, model.param_specs()))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    before = dict(dryrun.D.moved), dict(dryrun.D.calls)
    make_train_step(cfg, tctx, num_microbatches=TRACE_MICROBATCHES)(state, batch)
    out["train"] = dryrun.collectives(before)
    return out


def _rank(mesh, path: str) -> dict:
    npz = np.load(path)
    out = {}
    for key in ARCHS:
        cfg = _config(key)
        model = build(cfg)
        params = _params(npz, key)
        sctx = MeshCtx(SERVE_RULES, mesh, cfg)
        sparams = sctx.shard(params, model.param_specs())
        with torch.no_grad():
            lg, cache = model.prefill(sparams, _port_batch(npz, key, cfg), sctx)
        specs = _cache_specs(model, cfg, BATCH, SEQ)
        out[f"{key}.logits"] = lg
        out[f"{key}.shapes"] = {k: [list(v.shape), list(sctx.local_shape(specs[k]))]
                                for k, v in cache.items()}
        out.update({f"{key}.cache.{k}": v
                    for k, v in unshard(cache, specs, SERVE_RULES, mesh).items()})
        if key in DECODE_KEYS:
            got = _decode_vs_prefill(model, cfg, params, torch.from_numpy(npz[f"{key}.tokens"])
                                     .long(), sctx, mesh)
            out.update({f"{key}.dvp.{k}": v for k, v in got.items()})
    out["trace"] = _trace_steps(mesh, npz)
    return out


# -- fixtures ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX local, JAX mesh, the port's ranks, JAX local in f32): the
    JAX subprocess and the port's world run side by side."""
    tmp = tmp_path_factory.mktemp("mesh_prefill")
    inputs = tmp / "inputs.npz"
    jax_out = [tmp / f"jax_{name}.npz" for name in ("mesh", "local", "local_f32")]
    _inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX.format(tests=str(ROOT / "tests")), str(inputs),
         *map(str, jax_out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = launch(_rank, str(inputs), data=2, model=2, device="cpu", timeout=600)
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    jmesh, local, local32 = (dict(np.load(p)) for p in jax_out)
    return np.load(inputs), local, jmesh, ranks, local32


@pytest.fixture(scope="module")
def one_process(runs):
    """The port's prefill in one process, every family."""
    npz = runs[0]
    out = {}
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for key in ARCHS:
            cfg = _config(key)
            with torch.no_grad():
                lg, cache = build(cfg).prefill(_params(npz, key), _port_batch(npz, key, cfg))
            out[f"{key}.logits"] = lg.float().numpy()
            out.update({f"{key}.cache.{k}": v.float().numpy() for k, v in cache.items()})
    finally:
        torch.set_num_threads(old)
    return out


# -- the checks --------------------------------------------------------------------
def _max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _cache_failures(got: dict, want: dict, key: str, own: dict | None = None) -> list[str]:
    """The caches of ``key`` outside the module docstring's bounds: against
    the port's one process, or (``own``: the JAX package's f32 prefill)
    against the JAX package, plus its own bf16 error."""
    bad = []
    names = [k for k in want if k.startswith(f"{key}.cache.")]
    for name in names:
        g, w = np.asarray(got[name], np.float32), np.asarray(want[name], np.float32)
        slack = 0.0 if own is None else _max_diff(w, own[name])
        # the first layer's k/v come from the embedding alone (deepseek's cache
        # starts past its dense layer; enc_out is the whole encoder's)
        first = own is None and name.endswith((".k", ".v")) and key != "mla"
        if first and _max_diff(g[0], w[0]) > CACHE_TOL:
            bad.append(f"{name}: first layer {_max_diff(g[0], w[0]):.3g}")
        if _max_diff(g, w) > CACHE_BF16_REL * np.abs(w).max() + slack:
            bad.append(f"{name}: {_max_diff(g, w):.3g} of {np.abs(w).max():.3g}")
    return bad


@pytest.mark.parametrize("key", ARCHS)
def test_prefill_matches_the_local_and_mesh_paths(runs, key):
    _, local, jmesh, ranks, local32 = runs
    own = _max_diff(local[f"{key}.logits"], local32[f"{key}.logits"])
    for ref in (local, jmesh):
        assert sorted(k for k in ref if k.startswith(f"{key}.cache.")) == sorted(
            k for k in ranks[0] if k.startswith(f"{key}.cache."))
        for r in ranks:
            assert _max_diff(r[f"{key}.logits"], ref[f"{key}.logits"]) < JAX_LOGIT_TOL + own
            assert not _cache_failures(r, ref, key, local32)


@pytest.mark.parametrize("key", ARCHS)
def test_prefill_matches_one_process(runs, one_process, key):
    for r in runs[3]:
        assert _max_diff(r[f"{key}.logits"], one_process[f"{key}.logits"]) < LOGIT_TOL
        assert not _cache_failures(r, one_process, key)


@pytest.mark.parametrize("key", ARCHS)
def test_cache_is_the_ranks_shard(runs, key):
    """Each rank's cache has the shape ``MeshCtx.local_shape`` gives its spec:
    8 of 16 slots a model rank, 2 of 4 rows a data rank (whisper: one slot
    whole, its kv heads split over model)."""
    cfg = _config(key)
    for r in runs[3]:
        shapes = r[f"{key}.shapes"]
        assert all(got == want for got, want in shapes.values()), shapes
        for name, (got, _) in shapes.items():
            if name in ("k", "v", "c_kv", "k_rope"):
                assert got[1:3] == [BATCH // 2, 1 if cfg.is_encdec else SEQ // 2], (name, got)
        if cfg.is_encdec:
            assert shapes["k"][0][3] == cfg.num_kv_heads // 2


@pytest.mark.parametrize("key", DECODE_KEYS)
def test_decode_matches_mesh_prefill_at_every_prefix(runs, key):
    for r in runs[3]:
        d, p = r[f"{key}.dvp.decode"], r[f"{key}.dvp.prefill"]
        for pos in range(PREFIXES):
            top = (d[pos].argmax(-1) == p[pos].argmax(-1)).mean()
            assert _max_diff(d[pos], p[pos]) < DECODE_TOL and top >= TOP1, (key, pos)


@pytest.mark.parametrize("kind", TRACE_SHAPES)
def test_trace_counts_equal_the_live_collectives(runs, kind):
    """granite-smoke: ``estimate`` on a 2 x 2 trace mesh counts, per kind, the
    bytes and calls every live rank made for the same step."""
    cfg = _config("granite")
    rec = dryrun.estimate(cfg, TRACE_SHAPES[kind], make_local_mesh(2, 2),
                          microbatch_override=TRACE_MICROBATCHES if kind == "train" else None)
    assert rec["collectives"]["all-reduce"]["count"] > 0
    for r in runs[3]:
        assert r["trace"][kind] == rec["collectives"], (kind, r["trace"][kind])


def _stack_without_cache(model, params, tokens):
    """The prefill's stack with no cache kept: the same layers (attention
    without a cache), the final norm and the last position's logits."""
    p = unflatten(params)
    h, _ = model._run_stack(p, model._inputs_to_h(p, {"tokens": tokens}, None),
                            MaskSpec(causal=True), None)
    return _logits(p, apply_norm(p["final_norm"], h, model.cfg.norm)[:, -1:], model.cfg)


def test_prefill_holds_its_cache_once():
    """On the meta device, granite-smoke at 32 layers over 2 x 512 tokens: the
    prefill's peak is at most its cache, plus the peak of the same stack
    with no cache kept, plus one layer's K and V (a stack of each layer's
    list would hold the cache twice at its end)."""
    cfg = dataclasses.replace(_config("granite"), num_layers=32)
    model = build(cfg)
    with torch.device("meta"):
        params = {k: torch.empty(s.shape, dtype=s.dtype)
                  for k, s in serve_param_specs(model).items()}
        tokens = torch.zeros((2, 512), dtype=torch.long)
        with torch.no_grad():
            with CostAnalysis() as cost:
                _, cache = model.prefill(params, {"tokens": tokens})
            cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
            del cache
            with CostAnalysis() as plain:
                _stack_without_cache(model, params, tokens)
    layer_kv = cache_bytes // cfg.num_layers
    assert cache_bytes > plain.peak_bytes + layer_kv  # the bound tells once from twice
    assert cost.peak_bytes <= cache_bytes + plain.peak_bytes + layer_kv


@pytest.mark.parametrize("builder", [make_prefill_step, make_decode_step])
def test_serving_steps_need_a_meshctx_on_a_mesh(builder):
    """A context with a mesh but without ``MeshCtx``'s collectives would run
    the rank's share and never combine the shares (as ``make_train_step``,
    ``tests/test_torch_train.py::test_unported_options_raise``)."""
    ctx = AxisCtx()
    ctx.mesh = object()
    with pytest.raises(TypeError, match="needs a sharding.MeshCtx"):
        builder(_config("granite"), ctx)
