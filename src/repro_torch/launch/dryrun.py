"""Dry-run: one device's memory and FLOPs for every (arch x shape x mesh) cell.

The counterpart of ``repro/launch/dryrun.py``.  The JAX package lowers and
compiles each cell's partitioned step for 256 or 512 fake XLA devices and
reads XLA's memory and cost analyses.  PyTorch has no GSPMD partitioner,
so the port cannot compile that program; instead, for each cell this:

  1. takes the production mesh (16x16 single-pod / 2x16x16 multi-pod) and
     the cell's rule table (``sharding.py``: TRAIN, SERVE, DECODE or LONG),
  2. sizes every input's per-device shard by ``logical_to_spec`` and
     ``local_shape``: ``memory.argument_bytes``, exact (the train state
     ``{params, m, v, step}``, or the bf16 serving weights, the batch, the
     decode cache and position),
  3. traces rank 0's share of the step (``train/step.py``'s train, prefill
     or decode step with a ``sharding.MeshCtx``, through the port's model
     code, the collectives' and the kernels' meta paths) on the meta
     device, where nothing is allocated, under ``launch/cost_analysis.py``:
     ``memory.temp_bytes`` is the trace's peak live bytes above its
     arguments, ``cost`` its FLOPs and boundary bytes, ``collectives`` the
     bytes and calls of each kind,
  4. writes a JSON record to ``--out`` (resumable cache keyed by cell id).

Usage (the CPU is enough: nothing runs on a device):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

What is traced: rank 0 of the cell's mesh running the port's own sharded
program (on a mesh of one device, the one-process program).
``sharding.MeshCtx`` on a ``launch.mesh.TraceMesh`` (the production mesh's
shape, rank 0's coordinates, axes with no process group) runs the step as
a rank of a live ``ProcessMesh`` runs it, on meta tensors:

* The inputs are rank 0's shards: the parameters (and ``m``, ``v``) and
  the decode cache as ``logical_to_spec`` lays them out; the batch goes in
  whole, as the live steps take it, and each microbatch's rows for the
  ``data`` axis (``("pod", "data")`` on the multi-pod mesh, one trace axis
  of 32) are a view of it.  ``memory.argument_bytes`` counts each input's
  per-device shard.
* The products follow ``sharding.product_plans`` (Megatron's "f" and "g"
  around column- and row-parallel products, the row-parallel partial sums
  in f32, the vocab-parallel embedding, logits and loss); FSDP shards are
  gathered in bf16 one layer at a time inside the recomputed body, their
  gradients reduce-scattered; under DECODE and LONG rules the weights are
  split on ``embed`` (the input cut to the rank's part, "g" after).  The
  query heads read the rank's own kv heads (``MeshCtx.kv_heads``); the
  decode cache is the rank's slots, attended with the row log-sum-exp and
  combined over ``model``; the prefill writes its cache into the rank's
  shard (``MeshCtx.cache_part``: kv heads gathered over ``model``, then
  its slots).  The MoE layers run the expert-parallel path (``models/
  moe.py::_moe_ep``, rank 0's E / model experts, the capacity of its
  tokens).
* ``collectives``: each collective the trace makes (``distributed.py``'s
  meta route) counts its payload and its call, per kind, exactly as a
  live rank counts them in ``distributed.moved`` and ``calls``, under the
  JAX package's kind names (``all-reduce``, ``all-gather``,
  ``reduce-scatter``).  The payload is what the rank hands over (an
  all-gather's own part), not the bytes on a wire.
* The attention kernels' FLOPs are what they perform: causal and window
  tiles that a block never sees are skipped (the JAX package's chunked
  attention computes every block), so the trace's FLOPs fall short of
  XLA's by about half of the causal attention products.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import traceback

import torch

from repro_torch import distributed as D
from repro_torch.configs import ALL_ARCHS, get
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, cell_applicable
from repro_torch.launch.cost_analysis import CostAnalysis
from repro_torch.launch.mesh import TraceMesh, make_production_mesh
from repro_torch.launch.shapes import batch_specs, decode_specs, num_microbatches, serve_param_specs
from repro_torch.models.model import build
from repro_torch.sharding import (DECODE_RULES, LONG_RULES, SERVE_RULES, TRAIN_RULES, AxisCtx,
                                  MeshCtx, cache_slots)
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

DEFAULT_OUT = "results/dryrun_h100"
# The card's memory, torch.cuda.get_device_properties(0).total_memory on an
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi --query-gpu=name,power.limit)
H100_BUDGET_BYTES = 85_017_493_504
# distributed.py's kinds that a step makes, under the JAX package's names
# (its launch/hlo_analysis.py); a broadcast only hands weights out
COLLECTIVE_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                    "reduce_scatter": "reduce-scatter"}


def _cell_id(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}__{shape}__{mesh_kind}"


def cell_rules(shape: ShapeCell) -> dict:
    """The JAX package's rule table for a cell."""
    if shape.kind == "train":
        return dict(TRAIN_RULES)
    if shape.name.startswith("long"):
        return dict(LONG_RULES)
    return dict(DECODE_RULES if shape.kind == "decode" else SERVE_RULES)


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= d
    return n


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _shards(specs: dict, ctx: AxisCtx, args: list) -> dict[str, torch.Tensor]:
    """Rank 0's shard of each leaf of ``specs`` on the meta device, each
    appended to ``args`` with its bytes."""
    out = {}
    for name, sp in specs.items():
        shape = ctx.local_shape(sp)
        out[name] = _meta(shape, sp.dtype)
        args.append((out[name], _nbytes(shape, sp.dtype)))
    return out


def _inputs(records: dict, mesh, args: list, whole: bool = True) -> dict:
    """A meta tensor per input (the global shape where ``whole``, as the
    steps take the batch; else rank 0's shard), each appended to ``args``
    with the bytes of its per-device shard."""
    tensors = {}
    for name, rec in records.items():
        tensors[name] = _meta(rec.shape if whole else rec.local(mesh), rec.dtype)
        args.append((tensors[name], rec.local_bytes(mesh)))
    return tensors


def collectives(before: tuple[dict, dict]) -> dict:
    """The bytes and calls of each kind of collective since ``before`` (copies
    of ``distributed.moved`` and ``calls``), under the JAX package's names."""
    moved, calls = before
    return {name: {"bytes": D.moved[k] - moved[k], "count": D.calls[k] - calls[k]}
            for k, name in COLLECTIVE_NAMES.items()}


def estimate(cfg: ArchConfig, shape: ShapeCell, mesh, *, rules_override=None,
             microbatch_override: int | None = None, tag: str = "") -> dict:
    """Rank 0's share of ``cfg``'s step at ``shape`` over ``mesh`` (a
    ``launch/mesh.py`` shape), traced through ``MeshCtx``: the record
    :func:`run_cell` writes (without arch, shape and mesh names).  Takes
    objects, so that a caller can pass a depth-cut config and a batch-cut
    shape."""
    rec: dict = {"tag": tag}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec
    rules = cell_rules(shape)
    if rules_override:
        rules.update(rules_override)
    model = build(cfg)
    long_mode = shape.name.startswith("long")
    # one device runs the one-process program (no collective, no f32 partial sums)
    ctx = MeshCtx(rules, TraceMesh.of(mesh), cfg) if mesh.size > 1 else AxisCtx(rules)
    n_mb = 1
    args: list = []  # (input tensor, bytes of its per-device shard)
    extra = 0  # bytes of inputs that are Python numbers here (decode's position)
    with torch.device("meta"):
        if shape.kind == "train":
            n_mb = microbatch_override or num_microbatches(cfg, shape, mesh)
            params = _shards(model.param_specs(), ctx, args)
            state = {"params": params, "step": _meta((), torch.int32)}
            for key in ("m", "v"):
                state[key] = {k: torch.empty_like(p, dtype=torch.float32)
                              for k, p in params.items()}
                args += [(t, _nbytes(t.shape, t.dtype)) for t in state[key].values()]
            args.append((state["step"], 4))
            batch = _inputs(batch_specs(cfg, shape, rules, mesh), mesh, args)
            step = make_train_step(cfg, ctx, num_microbatches=n_mb)
            run = lambda: step(state, batch)  # noqa: E731
        elif shape.kind == "prefill":
            params = _shards(serve_param_specs(model), ctx, args)
            batch = _inputs(batch_specs(cfg, shape, rules, mesh), mesh, args)
            step = make_prefill_step(cfg, ctx)
            run = lambda: step(params, batch)  # noqa: E731
        else:
            params = _shards(serve_param_specs(model), ctx, args)
            cache_rec, tok_rec, pos_rec = decode_specs(cfg, shape, rules, mesh,
                                                       long_mode=long_mode)
            cache = _inputs(cache_rec, mesh, args, whole=False)
            tokens = _inputs({"tokens": tok_rec}, mesh, args)["tokens"]
            extra = pos_rec.local_bytes(mesh)
            ctx = ctx.for_cache(cache_slots(model.cache_specs(shape.global_batch, shape.seq_len,
                                                              long_mode=long_mode)))
            step = make_decode_step(cfg, ctx, long_mode=long_mode)
            run = lambda: step(params, cache, tokens, shape.seq_len - 1)  # noqa: E731
        stores = [t.untyped_storage() for t, _ in args]  # held: their ids stay theirs
        before = dict(D.moved), dict(D.calls)
        with CostAnalysis() as cost:
            out = run()
        del out
    # the inputs the step reads (XLA drops an argument its program never reads:
    # whisper's encoder weights from its decode step)
    arg_bytes = extra + sum(n for (_, n), st in zip(args, stores) if id(st) in cost.read)
    temp = cost.peak_bytes
    rec.update({
        "status": "ok",
        "devices": mesh.size,
        "num_microbatches": n_mb,
        "memory": {"argument_bytes": arg_bytes, "temp_bytes": temp,
                   "peak_bytes": arg_bytes + temp, "budget_bytes": H100_BUDGET_BYTES},
        "cost": {"flops": cost.flops, "bytes": cost.bytes},
        "kernels": cost.kernels,
        "op_counts": dict(sorted(cost.op_counts.items())),
        "collectives": collectives(before),
    })
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, rules_override=None, tag: str = "",
             microbatch_override: int | None = None) -> dict:
    shape = next(s for s in SHAPES if s.name == shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    try:
        rec.update(estimate(get(arch), shape, make_production_mesh(multi_pod=mesh_kind == "multi"),
                            rules_override=rules_override, tag=tag,
                            microbatch_override=microbatch_override))
    except Exception as e:  # a failure here is a fault of the per-device trace
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ALL_ARCHS if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape else [args.shape]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                cid = _cell_id(arch, shape, mesh_kind)
                path = outdir / f"{cid}.json"
                if path.exists() and not args.force:
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[{cid}] cached: {prev['status']}")
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skipped"
                        continue
                print(f"[{cid}] running...", flush=True)
                rec = run_cell(arch, shape, mesh_kind)
                path.write_text(json.dumps(rec, indent=1) + "\n")
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_err += st == "error"
                extra = ""
                if st == "ok":
                    extra = (f" peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB, "
                             f"{rec['cost']['flops'] / 1e12:.1f} TFLOP")
                elif st == "error":
                    extra = f" ({rec['error']})"
                print(f"[{cid}] {st}{extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
