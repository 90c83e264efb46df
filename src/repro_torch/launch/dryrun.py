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
  3. traces one device's share of the step (``train/step.py``'s train,
     prefill or decode step, through the port's model code and the kernels'
     meta paths) on the meta device, where nothing is allocated, under
     ``launch/cost_analysis.py``: ``memory.temp_bytes`` is the trace's peak
     live bytes above its arguments, ``cost`` its FLOPs and boundary bytes,
  4. writes a JSON record to ``--out`` (resumable cache keyed by cell id).

Usage (the CPU is enough: nothing runs on a device):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

One device's share, and how it differs from GSPMD's program:

* The per-device batch is ``global_batch`` over the data-parallel degree
  (``batch`` -> ``("pod", "data")``; long_500k's batch of 1 stays whole),
  cut into the JAX package's microbatches (``shapes.num_microbatches``);
  every microbatch is traced.
* Widths are divided by the ``model`` degree where ``logical_to_spec``
  shards them under the trace's table: ``heads``, ``kv_heads``, ``mlp``,
  ``vocab``, ``ssm_inner`` and ``experts`` -> ``model``, every other
  dimension of a weight whole.  Under TRAIN and SERVE rules that is the
  cell's own split.  Under DECODE and LONG rules the weights are split on
  ``embed`` instead (row-parallel products with an all-reduce), which
  gives each device the same share of every product (one ``model``-th)
  but not the same activations: the trace's are split over heads where
  GSPMD's are partial sums over the whole width.  MLA's decode is the one
  place where the shares differ: the trace splits the absorbed ``w_uk`` /
  ``w_uv`` products over heads (GSPMD replicates them) and keeps ``w_dkv``
  whole (GSPMD splits it on ``embed``).  The decode cache is traced whole
  along ``cache_seq`` with its kv heads split as the query heads are: the
  same attention FLOPs as GSPMD's sequence-sharded cache, whose combine is
  a collective.
* A weight is held as its exact shard and gathered to its trace shape one
  layer at a time, inside the layer's recomputed body (``AxisCtx.gather``,
  overridden by :class:`DeviceShare`; the backward maps the gradient back
  to the shard, a reduce-scatter): so the trace's peak holds one layer's
  gathered weights and, in training, their gradient before the
  reduce-scatter.  Under DECODE rules the "gather" is a reshard that GSPMD
  does not make: it overstates the temporaries by one layer's share of
  weights.
* Where ``heads`` divides the model axis and ``kv_heads`` does not
  (qwen3-moe 32/4, granite 32/8, yi 32/4, command-r 96/8 on 16), GSPMD
  replicates the K and V projections and repeats K and V to the query
  heads; the trace computes K and V whole too (the same FLOPs) and then
  attends the first rank's query heads to the kv heads they read, a copy
  of one kv head (:meth:`DeviceShare.kv_heads`).  A prefill's
  cache is returned with those heads over the whole sequence, where GSPMD
  writes it out sequence-sharded.
* The MoE layers run the expert-parallel rank body (``models/moe.py::
  moe_rank``, rank 0): routing over all experts, dispatch to the rank's
  E / 16, capacity from the device's tokens.
* Collectives are not traced (no partitioned program yet: ROADMAP Queue 1
  item 4g), so ``collectives`` is null.
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

from repro_torch.configs import ALL_ARCHS, get
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, cell_applicable
from repro_torch.launch.cost_analysis import CostAnalysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import batch_specs, decode_specs, num_microbatches, serve_param_specs
from repro_torch.models.model import build
from repro_torch.sharding import (
    DECODE_RULES,
    LONG_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    AxisCtx,
    local_shape,
    logical_to_spec,
)
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

DEFAULT_OUT = "results/dryrun_h100"
# The card's memory, torch.cuda.get_device_properties(0).total_memory on an
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi --query-gpu=name,power.limit)
H100_BUDGET_BYTES = 85_017_493_504
TRACE_WIDTHS = ("heads", "kv_heads", "mlp", "vocab", "ssm_inner", "experts")
COLLECTIVES_REASON = ("not traced: the port has no partitioned program yet "
                      "(ROADMAP Queue 1 item 4g)")


def _cell_id(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}__{shape}__{mesh_kind}"


def cell_rules(shape: ShapeCell) -> dict:
    """The JAX package's rule table for a cell."""
    if shape.kind == "train":
        return dict(TRAIN_RULES)
    if shape.name.startswith("long"):
        return dict(LONG_RULES)
    return dict(DECODE_RULES if shape.kind == "decode" else SERVE_RULES)


def trace_rules(rules: dict) -> dict:
    """The table the trace's shapes follow: the cell's ``batch``, the widths
    over ``model``, everything else whole."""
    out = dict.fromkeys(rules)
    out.update({name: ("model",) for name in TRACE_WIDTHS})
    out["batch"] = rules.get("batch")
    return out


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= d
    return n


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class _Gather(torch.autograd.Function):
    """A weight's shard gathered to its trace shape (on the meta device: a
    new tensor of that shape); the gradient back to the shard's shape."""

    @staticmethod
    def forward(ctx, w, shape):
        ctx.shard = tuple(w.shape)
        return w.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        return g.new_empty(ctx.shard), None


class DeviceShare(AxisCtx):
    """The context of one device's share of a partitioned step, traced alone:
    :meth:`gather` gives each weight its trace shape, :meth:`kv_heads` the kv
    heads that the device's query heads read, and MoE layers take the rank
    body of ``expert_rank`` (rank 0 of the expert-parallel ranks)."""

    def __init__(self, rules: dict, trace_shapes: dict[str, tuple], experts: int, group: int):
        super().__init__(rules)
        self.trace_shapes = trace_shapes  # weight name (one layer's for stacks) -> shape
        self.expert_rank = (0, experts) if experts > 1 else None
        self.group = group  # query heads per kv head

    def gather(self, name: str, w: torch.Tensor) -> torch.Tensor:
        shape = self.trace_shapes.get(name)
        if shape is None or tuple(w.shape) == shape:
            return w
        if w.device.type != "meta":
            raise ValueError(f"DeviceShare traces meta tensors; {name} is on {w.device}")
        return _Gather.apply(w, shape)

    def kv_heads(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """All of ``k`` and ``v`` where the kv heads are split as the query
        heads are; where the query heads are one device's share and the kv
        heads whole (Hkv does not divide the model axis, so the JAX package
        replicates them), the kv heads ``h // group`` of the first rank's
        query heads h, copied out."""
        hq, hkv = q.shape[2], k.shape[2]
        if hkv * self.group == hq:
            return k, v
        need = -(-hq // self.group)
        if hq % need or need > hkv:
            raise ValueError(f"{hq} query heads of a group of {self.group} do not read "
                             f"{need} of {hkv} kv heads")
        return k[:, :, :need].contiguous(), v[:, :, :need].contiguous()


def _weights(specs: dict, rules: dict, t_rules: dict, mesh, args: list):
    """(shards on the meta device, trace shapes by weight name); each shard
    and its bytes appended to ``args``."""
    shards, trace_shapes = {}, {}
    for name, sp in specs.items():
        shard = local_shape(sp.shape, logical_to_spec(sp.axes, sp.shape, rules, mesh), mesh)
        trace = local_shape(sp.shape, logical_to_spec(sp.axes, sp.shape, t_rules, mesh), mesh)
        shards[name] = _meta(shard, sp.dtype)
        args.append((shards[name], _nbytes(shard, sp.dtype)))
        trace_shapes[name] = trace[1:] if sp.axes[:1] == ("layers",) else trace
    return shards, trace_shapes


def _inputs(records: dict, mesh, t_rules: dict, args: list) -> dict:
    """Meta tensors at the inputs' trace shapes; each tensor and the exact
    bytes of its per-device shard appended to ``args``."""
    tensors = {}
    for name, rec in records.items():
        trace = local_shape(rec.shape, logical_to_spec(rec.axes, rec.shape, t_rules, mesh), mesh)
        tensors[name] = _meta(trace, rec.dtype)
        args.append((tensors[name], rec.local_bytes(mesh)))
    return tensors


def estimate(cfg: ArchConfig, shape: ShapeCell, mesh, *, rules_override=None,
             microbatch_override: int | None = None, tag: str = "") -> dict:
    """One device's share of ``cfg``'s step at ``shape`` over ``mesh`` (a
    ``launch/mesh.py`` shape): the record :func:`run_cell` writes (without
    arch, shape and mesh names).  Takes objects, so that a caller can pass
    a depth-cut config and a batch-cut shape."""
    rec: dict = {"tag": tag}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec
    rules = cell_rules(shape)
    if rules_override:
        rules.update(rules_override)
    t_rules = trace_rules(rules)
    model = build(cfg)
    long_mode = shape.name.startswith("long")
    specs = model.param_specs()
    exp = cfg.moe.num_experts if cfg.moe else 0
    ep = 1
    if exp and logical_to_spec(("experts",), (exp,), t_rules, mesh):
        ep = mesh.shape["model"]
    group = cfg.num_heads // max(cfg.num_kv_heads, 1)
    n_mb = 1
    args: list = []  # (input tensor, bytes of its per-device shard)
    extra = 0  # bytes of inputs that are Python numbers here (decode's position)
    with torch.device("meta"):
        if shape.kind == "train":
            n_mb = microbatch_override or num_microbatches(cfg, shape, mesh)
            params, trace_shapes = _weights(specs, rules, t_rules, mesh, args)
            state = {"params": params, "step": _meta((), torch.int32)}
            for key in ("m", "v"):
                state[key] = {k: torch.empty_like(p, dtype=torch.float32)
                              for k, p in params.items()}
                args += [(t, _nbytes(t.shape, t.dtype)) for t in state[key].values()]
            args.append((state["step"], 4))
            batch = _inputs(batch_specs(cfg, shape, rules, mesh), mesh, t_rules, args)
            step = make_train_step(cfg, DeviceShare(rules, trace_shapes, ep, group),
                                   num_microbatches=n_mb)
            run = lambda: step(state, batch)  # noqa: E731
        elif shape.kind == "prefill":
            params, trace_shapes = _weights(serve_param_specs(model), rules, t_rules, mesh, args)
            batch = _inputs(batch_specs(cfg, shape, rules, mesh), mesh, t_rules, args)
            step = make_prefill_step(cfg, DeviceShare(rules, trace_shapes, ep, group))
            run = lambda: step(params, batch)  # noqa: E731
        else:
            params, trace_shapes = _weights(serve_param_specs(model), rules, t_rules, mesh, args)
            cache_rec, tok_rec, pos_rec = decode_specs(cfg, shape, rules, mesh,
                                                       long_mode=long_mode)
            cache = _inputs(cache_rec, mesh, t_rules, args)
            tokens = _inputs({"tokens": tok_rec}, mesh, t_rules, args)["tokens"]
            extra = pos_rec.local_bytes(mesh)
            step = make_decode_step(cfg, DeviceShare(rules, trace_shapes, ep, group),
                                    long_mode=long_mode)
            run = lambda: step(params, cache, tokens, shape.seq_len - 1)  # noqa: E731
        stores = [t.untyped_storage() for t, _ in args]  # held: their ids stay theirs
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
        "collectives": None,
        "collectives_reason": COLLECTIVES_REASON,
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
