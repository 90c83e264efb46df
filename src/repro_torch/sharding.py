"""Parameter declarations, parameter trees and the logical-axis sharding rules.

The JAX package keeps parameters as nested dicts (a pytree) with every
layer's weights stacked on a leading ``layers`` axis.  The port keeps the
same leaves, stacked the same way, in a flat ``dict[str, Tensor]`` keyed by
the dotted tree path (``"blocks.attn.wq"``), so that a checkpoint written
by either package has the same leaves in the same order (dict keys sorted,
as ``jax.tree_util.tree_leaves`` orders them).

The rule tables and ``logical_to_spec`` are the JAX package's (MaxText-style
rules with a divisibility fallback): every parameter or activation dimension
carries a logical name, a table maps names to mesh axes, and a mapping whose
mesh-axis product does not divide the dimension is dropped.  A partition is
a plain tuple with the entries of the JAX package's ``PartitionSpec``.  The
port has no partitioner: ``AxisCtx.constrain`` is the identity, and a
sharded program is the ranks' own (below).

Over a mesh of processes (``launch/mesh.py``) each rank holds its shard of
every leaf (:func:`shard_params`; :func:`unshard` is the inverse) and runs
the model with a :class:`MeshCtx`, whose hooks place the collectives
(``distributed.py``) that make the shards add up to the whole: the FSDP
gathers of a weight, "f" and "g" around a product split over ``model``
(:func:`product_plans`, one table for every rule table), the
vocab-parallel embedding and logits, the sequence-sharded decode cache and
the prefill's cache written into the rank's shard of it, the batch over
``data``, the gradient sums and the global norm.  Every hook is the
identity in :class:`AxisCtx`.  The dry-run (``launch/dryrun.py``) runs a
:class:`MeshCtx` on rank 0 of a ``launch.mesh.TraceMesh``, on meta tensors.
A leaf whose dim holds several parts side by side (Mamba's ``in_proj``:
the columns of x, then those of z) splits part-wise (``FUSED``): each rank
holds its share of every part, and the whole leaf keeps the JAX package's
layout.  World rank 0 hands out whole leaves (:func:`shards_from_root`)
and takes them back (:func:`root_from_shards`) one leaf at a time: how a
checkpoint of a sharded train state is restored and saved.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import distributed as D
from repro_torch.device import resolve_device

# -- default rule tables -------------------------------------------------------
# TRAIN: weights TP over 'model' + FSDP over ('pod','data') on the d_model
# axis (gathered per layer); activations batch over ('pod','data').
TRAIN_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": ("pod", "data"),  # FSDP shard of weights' d_model dim
    "expert_embed": ("pod", "data"),  # MoE expert weights' d_model dim
    "embed_act": None,  # activations' d_model dim stays replicated
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": None,
    "ssm_inner": ("model",),
    "ssm_state": None,
    "ssm_dt": None,
    "layers": None,
    "q_lora": None,
    "kv_lora": None,
    "conv": None,
    "frames": None,
    "cache_seq": None,
    "window": None,
}

# PREFILL (compute-bound): Megatron TP over 'model' (heads/mlp/vocab),
# weights replicated over 'data'; KV cache written out sequence-sharded.
SERVE_RULES = dict(TRAIN_RULES)
SERVE_RULES.update({
    "embed": None,
    "expert_embed": None,
    "batch": ("pod", "data"),
    "cache_seq": ("model",),
    "heads": ("model",),
})

# DECODE (memory-bound, tiny activations): weights row-parallel over 'model'
# only; the KV cache sequence-sharded over 'model'.
DECODE_RULES = dict(TRAIN_RULES)
DECODE_RULES.update({
    "embed": ("model",),
    "expert_embed": None,  # expert weights stay EP-sharded only (no re-gather)
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "vocab": ("model",),
    "batch": ("pod", "data"),
    "cache_seq": ("model",),
})

# long-context decode (global_batch=1): batch replicated, state TP-sharded
LONG_RULES = dict(DECODE_RULES)
LONG_RULES.update({"batch": None})


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical axes + init."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in length")


def _axis_size(mesh, names: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[n] for n in names)


def logical_to_spec(axes: tuple[str | None, ...], shape: tuple[int, ...],
                    rules: dict[str, tuple[str, ...] | None], mesh) -> tuple:
    """The partition of a ``shape`` with logical ``axes`` over ``mesh`` (any
    object with an ordered ``shape`` mapping of axis name to size): one entry
    per dimension, ``None`` (replicated), a mesh axis name, or a tuple of
    names; trailing ``None``s dropped.  A mapping is dropped where its
    mesh-axis product does not divide the dimension, or where an earlier
    dimension took one of its mesh axes."""
    used: set[str] = set()
    parts: list = []
    for dim, name in zip(shape, axes):
        entry = rules.get(name) if name else None
        if entry is None:
            parts.append(None)
            continue
        entry = tuple(a for a in entry if a in mesh.shape and a not in used)
        if not entry or dim % _axis_size(mesh, entry) != 0:
            parts.append(None)
            continue
        used.update(entry)
        parts.append(entry if len(entry) > 1 else entry[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def tree_pspecs(specs: dict[str, ParamSpec], rules, mesh) -> dict[str, tuple]:
    """Flat dict of ParamSpec -> flat dict of partitions."""
    return {k: logical_to_spec(s.axes, s.shape, rules, mesh) for k, s in specs.items()}


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple[int, ...]:
    """One device's shard of ``shape`` under the partition ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            out[i] //= _axis_size(mesh, (entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves of nested dicts, lists and tuples keyed by dotted path, in the
    order of ``jax.tree_util.tree_leaves`` (dict keys sorted; ``None`` holds
    no leaf)."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(flatten(tree[key], f"{prefix}{key}."))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out.update(flatten(sub, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def unflatten(flat: dict[str, Any]) -> dict[str, Any]:
    """Nested dicts from dotted paths (the inverse of :func:`flatten` on dicts)."""
    out: dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, last = path.split(".")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def init_params(specs: dict[str, ParamSpec], generator: torch.Generator, *, device=None,
                dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Materialize parameters from ``generator`` (on the generator's device),
    then place them on ``device`` (``None``: the card).  Same init rules as the
    JAX package; different random numbers."""
    dev = resolve_device(device)
    out = {}
    for name, spec in specs.items():
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            out[name] = torch.zeros(spec.shape, dtype=dt, device=dev)
        elif spec.init == "ones":
            out[name] = torch.ones(spec.shape, dtype=dt, device=dev)
        else:
            scale = spec.scale
            if spec.init == "scaled" and len(spec.shape) >= 2:
                scale = 1.0 / math.sqrt(spec.shape[-2])
            x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            out[name] = x.mul_(scale).to(device=dev, dtype=dt)
    return out


def params_from_numpy(tree, device=None) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree (leaves as numpy arrays) as the port's
    flat parameter dict on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return {path: torch.from_numpy(np.array(leaf)).to(dev) for path, leaf in flatten(tree).items()}


def state_from_numpy(state, device=None) -> dict:
    """The JAX package's train state (``params``, ``m``, ``v`` as parameter
    trees of numpy arrays, ``step`` a scalar) as the port's: flat dicts of
    tensors and a 0-d int32 ``step``, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    out = {key: params_from_numpy(state[key], device=dev) for key in ("params", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)
    return out


class Shard(NamedTuple):
    """A rank's part [start, stop) of a dim split over ``axis`` (a ``distributed.Axis``)."""

    start: int
    stop: int
    axis: Any


class AxisCtx:
    """Counterpart of the JAX package's sharding context, threaded through the
    model code.  Off a mesh every hook is the identity: :meth:`constrain`,
    :meth:`gather` and :meth:`kv_heads` (the layer's share of the work),
    :meth:`linear` (a product), :meth:`vocab_shard` and :meth:`seq_shard`
    (None: the vocab and the cache are whole), :meth:`cache_part` (a
    prefill's cache entry as computed), the batch and mean hooks, and the
    gradient and norm sums of the train step.  :class:`MeshCtx` overrides
    them all with a rank's share and its collectives."""

    def __init__(self, rules=None, mesh=None, remat_policy=None):
        self.rules = rules or TRAIN_RULES
        self.mesh = mesh
        self.remat_policy = remat_policy

    def constrain(self, x, *axes):
        return x

    def gather(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """The weight ``name`` (a dotted parameter path, one layer's slice for
        stacked weights) as the layer's products read it."""
        return w

    def kv_heads(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """The K and V heads (B, S, Hkv, hd) that the query heads ``q`` read."""
        return k, v

    def linear(self, name: str, x: torch.Tensor, w: torch.Tensor, product) -> torch.Tensor:
        """``product(x, w)``: the activation ``x`` times the weight ``name`` (its
        leaf name, ``"wq"``), already in the compute dtype."""
        return product(x, w)

    def vocab_shard(self, name: str) -> Shard | None:
        """This rank's ids of the vocab table ``name``, or None: the whole vocab
        (the dry-run's share: the first rank's ids, counted from 0)."""
        return None

    def seq_shard(self, slots: int) -> Shard | None:
        """This rank's slots of a decode cache holding ``slots`` of them here,
        or None: the whole cache."""
        return None

    def cache_part(self, t: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
        """One layer's entry ``t`` (batch, slots, ...) of the cache ``spec``
        (stacked on ``layers``) as a prefill computed it -> this rank's shard
        of it."""
        return t

    def local_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch ``x`` (its leading dim)."""
        return x

    def whole_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of which ``x`` holds this rank's rows."""
        return x

    def pmean(self, x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
        """The mean of ``x`` over the ranks of the mesh ``axes`` (``jax.lax.pmean``)."""
        return x

    def split_read(self, x: torch.Tensor, logical: str, n: int) -> torch.Tensor:
        """An activation ``x`` that every rank holds whole, read by this rank's
        share of a dim of ``n`` named ``logical`` (its heads, its SSM channels)."""
        return x

    def shard(self, tree: dict[str, torch.Tensor], specs: dict[str, ParamSpec]) -> dict:
        """This rank's shard of each whole leaf of ``tree``."""
        return tree

    def local_shape(self, spec: ParamSpec) -> tuple[int, ...]:
        """The shape of this rank's shard of a leaf of ``spec``."""
        return spec.shape

    def reduce_grads(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The step's gradients (one rank's sums) as the gradient of the
        global mean loss on this rank's shards."""
        return grads

    def sum_once(self, values: dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of one scalar per leaf (as ``values`` gives it on this rank's
        shard), each leaf's whole counted once."""
        return torch.stack(list(values.values())).sum()


# -- a mesh of processes ------------------------------------------------------------
FSDP_AXES = ("pod", "data")  # mesh axes a weight dim is gathered over before its products

# The layers' products with a weight, by the weight's leaf name: the weight
# dims the product contracts (the others are its outputs).  With the rule
# table's partitions of each weight and of the activations (a weight's
# "embed" dim is the activation's "embed_act"), they fix the collectives
# over "model" around each product (product_plans).  Under TRAIN_RULES:
# "f" into wq/wk/wv, gate/up and the logits (column-parallel), "g" after
# wo and down (row-parallel); under DECODE_RULES (weights' embed dim on
# model): the input cut to the rank's part and "g" after wq/wk/wv and
# gate/up, an all-gather after wo and down (their embed outputs).  Mamba
# (ssm_inner on model in every table): "f" into in_proj and dt_proj, "g"
# after x_proj and out_proj under TRAIN_RULES; under DECODE_RULES in_proj's
# embed dim takes model first, so its input is cut, its output summed whole
# ("g") and each rank keeps its channels of x and of z.  MLA: w_uk and w_uv
# contract kv_lora in the expanded path and head_dim in the absorbed
# decode, where the tables leave both whole (no collective).
CONTRACTED = {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1), "gate": (0,), "up": (0,),
              "down": (0,), "shared_gate": (0,), "shared_up": (0,), "shared_down": (0,),
              "lm_head": (1,), "embed": (1,), "in_proj": (0,), "x_proj": (0,),
              "dt_proj": (0,), "out_proj": (0,), "w_dkv": (0,), "w_uk": (0,), "w_uv": (0,)}
ACTIVATION_AXIS = {"embed": "embed_act"}
# Weights every rank holds whole that a layer applies to an activation whose
# dim (here: its heads) the rules may split over "model": where they do, each
# rank's gradient is its heads' part, so the weight passes "f" (MeshCtx.gather).
SPLIT_READERS = {"q_norm": "heads", "k_norm": "kv_heads"}
# Leaves whose dim named here holds that many equal parts side by side:
# Mamba's in_proj (d, 2 d_inner) is [x | z].  Split over a mesh axis, each
# rank holds its share of each part (rank 0: the first half of x's columns
# and of z's), so that its channels of x and of z are those of its SSM state.
FUSED = {"in_proj": ("ssm_inner", 2)}


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    """The collectives over ``model`` around one weight's product."""

    copy_f: bool  # "f" on the input: every rank holds it whole, the product is split
    cut_input: bool  # the input's last dim cut to this rank's part of the contracted dim
    reduce_g: bool  # "g" on the output: the ranks' partial sums (taken in f32)
    gather: bool  # the output's last dim gathered whole
    cut_output: bool = False  # the whole output's last dim cut to this rank's part
    parts: int = 1  # the output's last dim holds this many parts, each split (FUSED)


def _on(entry, axis: str) -> bool:
    return entry is not None and axis in ((entry,) if isinstance(entry, str) else entry)


def _padded(part: tuple, n: int) -> tuple:
    return tuple(part) + (None,) * (n - len(part))


def product_plans(specs: dict[str, ParamSpec], rules, mesh) -> dict[str, ProductPlan]:
    """The :class:`ProductPlan` of every weight of ``specs`` that a layer
    multiplies an activation by (``CONTRACTED``; the MoE's expert weights
    take the expert-parallel path instead), keyed by leaf name."""
    plans: dict[str, ProductPlan] = {}
    for path, spec in specs.items():
        name = path.rsplit(".", 1)[-1]
        if name not in CONTRACTED or "experts" in spec.axes:
            continue
        axes, shape = spec.axes, spec.shape
        if axes[:1] == ("layers",):
            axes, shape = axes[1:], shape[1:]
        w = _padded(logical_to_spec(axes, shape, rules, mesh), len(axes))
        act = _padded(logical_to_spec(tuple(ACTIVATION_AXIS.get(a, a) for a in axes), shape,
                                      rules, mesh), len(axes))
        cin = CONTRACTED[name]
        cout = tuple(i for i in range(len(axes)) if i not in cin)
        model_in = any(_on(w[i], "model") for i in cin)
        model_out = any(_on(w[i], "model") for i in cout)
        act_in = any(_on(act[i], "model") for i in cin)
        act_out = any(_on(act[i], "model") for i in cout)
        fused = FUSED.get(name)
        plan = ProductPlan(copy_f=(model_in or model_out) and not act_in,
                           cut_input=model_in and not act_in, reduce_g=model_in,
                           gather=model_out and not act_out,
                           cut_output=act_out and not model_out,
                           parts=fused[1] if fused and axes[cout[-1]] == fused[0] else 1)
        if plan.cut_input and len(cin) != 1:
            raise NotImplementedError(f"{path}: a whole input cut over {len(cin)} dims")
        if plans.setdefault(name, plan) != plan:
            raise ValueError(f"{path}: the weights named {name!r} need different collectives")
    return plans


def _shard_index(entry, mesh, coords) -> tuple[int, int]:
    """(index, count) of this rank's part of a dim split over ``entry``: the
    axes of a tuple entry major to minor, as ``jax.sharding`` orders them."""
    names = (entry,) if isinstance(entry, str) else entry
    idx = 0
    for name in names:
        idx = idx * mesh.shape[name] + coords[name]
    return idx, _axis_size(mesh, names)


def _parts(name: str, spec: ParamSpec, dim: int) -> int:
    """How many equal parts dim ``dim`` of the leaf ``name`` holds side by side (``FUSED``)."""
    fused = FUSED.get(name.rsplit(".", 1)[-1])
    return fused[1] if fused and spec.axes[dim] == fused[0] else 1


def _by_part(t: torch.Tensor, dim: int, parts: int, fn) -> torch.Tensor:
    """``fn(t, dim)`` applied within each of the ``parts`` equal parts of dim
    ``dim`` of ``t``, the parts then side by side again."""
    if parts == 1:
        return fn(t, dim)
    dim %= t.ndim
    return fn(t.unflatten(dim, (parts, t.shape[dim] // parts)), dim + 1).flatten(dim, dim + 1)


def shard_params(full: dict[str, torch.Tensor], specs: dict[str, ParamSpec], rules, mesh,
                 coords: dict[str, int]) -> dict[str, torch.Tensor]:
    """The shard of each whole leaf of ``full`` that the rank at ``coords``
    holds under ``rules`` (a copy of it): the counterpart of placing a tree by
    the JAX package's ``tree_shardings``; a ``FUSED`` dim splits part-wise."""
    out = {}
    for name, t in full.items():
        sp = specs[name]
        for dim, entry in enumerate(logical_to_spec(sp.axes, sp.shape, rules, mesh)):
            if entry is not None:
                idx, count = _shard_index(entry, mesh, coords)
                t = _by_part(t, dim, _parts(name, sp, dim),
                             lambda x, d: x.narrow(d, idx * (x.shape[d] // count),
                                                   x.shape[d] // count))
        out[name] = t.clone()
    return out


def unshard(shards: dict[str, torch.Tensor], specs: dict[str, ParamSpec], rules,
            mesh) -> dict[str, torch.Tensor]:
    """The whole leaves, on every rank, from each rank's ``shards`` (the
    inverse of :func:`shard_params`, by all-gathers): for checkpoints and tests."""
    out = {}
    for name, t in shards.items():
        sp = specs[name]
        for dim, entry in enumerate(logical_to_spec(sp.axes, sp.shape, rules, mesh)):
            if entry is None:
                continue
            if not isinstance(entry, str):
                raise NotImplementedError(f"{name}: a dim split over several axes {entry}")
            t = _by_part(t, dim, _parts(name, sp, dim),
                         lambda x, d: D.all_gather(x, mesh.axis(entry), d))
        out[name] = t
    return out


def require_mesh_ctx(ctx, what: str) -> None:
    """Raise unless ``ctx`` is a :class:`MeshCtx`, the one context whose hooks
    hold a mesh's collectives (another with a ``mesh`` set would run the
    rank's share of ``what`` and never combine the shares)."""
    if not isinstance(ctx, MeshCtx):
        raise TypeError(f"{what} over a mesh needs a sharding.MeshCtx (its collectives); "
                        f"got {type(ctx).__name__}")


def shards_from_root(full: dict[str, torch.Tensor] | None, specs: dict[str, ParamSpec],
                     rules_tables: list, mesh) -> list[dict[str, torch.Tensor]]:
    """Each rank's shards, under each table of ``rules_tables``, of the leaves
    that world rank 0 holds whole in ``full`` (None on the other ranks): rank
    0 broadcasts one leaf at a time and every rank keeps its slices of it
    (:func:`shard_params`), so a rank holds one whole leaf at most beside its
    shards.  How the rank that restored a checkpoint hands it out (the JAX
    package's checkpoint docstring: "the caller re-shards with the new mesh's
    shardings")."""
    out: list[dict[str, torch.Tensor]] = [{} for _ in rules_tables]
    for name, spec in specs.items():
        if full is not None:
            t = full[name].to(mesh.device).contiguous()
        else:
            t = torch.empty(spec.shape, dtype=spec.dtype, device=mesh.device)
        D.broadcast(t, mesh.world, 0)
        for shards, rules in zip(out, rules_tables):
            shards.update(shard_params({name: t}, specs, rules, mesh, mesh.coords))
        del t
    return out


def root_from_shards(shards: dict[str, torch.Tensor], specs: dict[str, ParamSpec], rules,
                     mesh) -> dict[str, torch.Tensor] | None:
    """The inverse of :func:`shards_from_root`: on world rank 0 the whole
    leaves of each rank's ``shards`` under ``rules``, as CPU tensors (None on
    the other ranks).  One leaf at a time is gathered (:func:`unshard`) and
    moved to the host, so a rank's device holds one whole leaf at most beside
    its shards: how a sharded train state reaches the rank that writes its
    checkpoint."""
    out = {} if mesh.rank == 0 else None
    for name, t in shards.items():
        whole = unshard({name: t}, specs, rules, mesh)[name]
        if out is not None:
            out[name] = whole.cpu()
        del whole
    return out


class MeshCtx(AxisCtx):
    """A rank's context on a :class:`launch.mesh.ProcessMesh` for the model
    ``cfg`` under ``rules``: every hook of :class:`AxisCtx` with this rank's
    share and the collectives of ``distributed.py``.  Parameters, optimizer
    state and the decode cache are the rank's shards (:meth:`shard`,
    :meth:`local_shape`); batches (tokens, embeddings, frames), logits and
    losses go in and come out whole, as the JAX package's jitted steps take
    and give them.  Every family of ``models/model.py``."""

    def __init__(self, rules, mesh, cfg):
        from repro_torch.models.model import build  # the models import this module

        super().__init__(dict(rules), mesh)
        self.cfg = cfg
        self.specs = build(cfg).param_specs()
        self.parts = tree_pspecs(self.specs, self.rules, mesh)
        self.plans = product_plans(self.specs, self.rules, mesh)
        self.group = cfg.num_heads // max(cfg.num_kv_heads, 1)
        heads = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}
        self.summed = {name for name, axis in SPLIT_READERS.items()
                       if getattr(self._split(axis, heads[axis]), "name", None) == "model"}

    def _axis(self, entry):
        """The axis of a partition entry: a mesh axis, or on a trace mesh one
        over several (a live mesh raises there)."""
        return self.mesh.axis(entry)

    def _split(self, logical: str, n: int):
        """The mesh axis a dim of ``n`` named ``logical`` is split over, or None."""
        entry = logical_to_spec((logical,), (n,), self.rules, self.mesh)
        return self._axis(entry[0]) if entry else None

    def gather(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """The weight with its FSDP dims gathered whole, in the compute dtype:
        every FSDP-split leaf is a product's weight, which the product casts
        to it anyway, so the gather moves half the bytes of the f32 shard."""
        from repro_torch.models.layers import cast  # the models import this module

        spec = self.specs[name]
        lead = 1 if spec.axes[:1] == ("layers",) else 0
        for dim, entry in enumerate(self.parts[name][lead:]):
            if entry is not None and any(_on(entry, a) for a in FSDP_AXES):
                w = _by_part(cast(w), dim, _parts(name, spec, dim + lead),
                             lambda t, d: D.fsdp_gather(t, self._axis(entry), d))
        if name.rsplit(".", 1)[-1] in self.summed:
            w = D.copy_f(w, self.mesh.axis("model"))
        return w

    def kv_heads(self, q, k, v):
        """The kv heads this rank's query heads read: all of ``k``/``v`` where
        they are split as the query heads are; where the query heads are this
        rank's share and the kv heads whole, the rank's own ones (through "f")."""
        hq, hkv = q.shape[2], k.shape[2]
        if hkv * self.group == hq:
            return k, v
        ax = self.mesh.axis("model")
        first = ax.index * hq // self.group
        last = ((ax.index + 1) * hq - 1) // self.group + 1
        per = hq // (last - first)  # query heads per kv head, as the kernels pair them
        if hq % (last - first) or any((ax.index * hq + j) // self.group - first != j // per
                                      for j in range(hq)):
            raise ValueError(f"{hq} query heads of rank {ax.index} read kv heads "
                             f"[{first}, {last}) of {hkv} unevenly")
        k, v = D.copy_f(k, ax), D.copy_f(v, ax)
        return k[:, :, first:last].contiguous(), v[:, :, first:last].contiguous()

    def linear(self, name, x, w, product):
        plan = self.plans.get(name)
        if plan is None:
            return product(x, w)
        ax = self.mesh.axis("model")
        if plan.copy_f:
            x = D.copy_f(x, ax)
        if plan.cut_input:
            n = x.shape[-1] // ax.size
            x = x[..., ax.index * n:(ax.index + 1) * n]
        if plan.reduce_g:
            y = D.reduce_g(product(x.float(), w.float()), ax).to(x.dtype)
        else:
            y = product(x, w)
        if plan.gather:
            return _by_part(y, -1, plan.parts, lambda t, d: D.gather_out(t, ax, d))
        if plan.cut_output:
            return _by_part(y, -1, plan.parts, lambda t, d: D.own_part(t, ax, d))
        return y

    def split_read(self, x, logical, n):
        """``x`` through "f" where the dim is split over ``model``: each rank's
        gradient of ``x`` is its share's part, summed over the axis."""
        ax = self._split(logical, n)
        return D.copy_f(x, ax) if ax is not None and ax.name == "model" else x

    def vocab_shard(self, name):
        part = self.parts[name]
        if not part or not _on(part[0], "model"):
            return None
        ax = self.mesh.axis("model")
        n = self.specs[name].shape[0] // ax.size
        return Shard(ax.index * n, (ax.index + 1) * n, ax)

    def seq_shard(self, slots):
        """This rank's slots of a decode cache holding ``slots`` of them here:
        under a split of ``cache_seq`` over model, a shard of ``slots * model``.
        Where ``slots`` does not divide by model, a whole cache (the fallback
        of ``logical_to_spec`` for a count model does not divide) holds as
        many, so decode refuses it rather than guess."""
        entry = self.rules.get("cache_seq") or ()
        if "model" not in entry or "model" not in self.mesh.shape:
            return None
        ax = self.mesh.axis("model")
        if slots % ax.size:
            raise ValueError(f"a decode cache of {slots} slots a rank is either whole or a "
                             f"shard of {slots * ax.size}; give it a multiple of "
                             f"{ax.size * ax.size} slots")
        return Shard(ax.index * slots, (ax.index + 1) * slots, ax)

    def cache_part(self, t, spec):
        """The rank's shard, as ``logical_to_spec`` lays out ``spec`` under the
        rules, of one layer's entry ``t`` that the prefill computed on this
        rank: its rows of the batch, and along every other dim the whole or
        (kv heads split as the products split them) the rank's share over
        ``model``.  A share that the layout holds whole is all-gathered over
        ``model``; then a whole dim that the layout splits (``cache_seq``) is
        cut to the rank's part."""
        axes, whole = spec.axes[1:], spec.shape[1:]
        part = logical_to_spec(axes, whole, self.rules, self.mesh)
        want = local_shape(whole, part, self.mesh)
        for dim, n in enumerate(whole):
            if t.shape[dim] != n and want[dim] == n:
                t = D.all_gather(t, self.mesh.axis("model"), dim)
        for dim, entry in enumerate(part):
            if entry is not None and t.shape[dim] == whole[dim] != want[dim]:
                idx, count = _shard_index(entry, self.mesh, self.mesh.coords)
                t = t.narrow(dim, idx * (whole[dim] // count), whole[dim] // count)
        if tuple(t.shape) != want:
            raise ValueError(f"a cache entry of {tuple(t.shape)} is not a shard {want} of "
                             f"{whole} under {part}")
        return t

    def _batch_axis(self, rows: int):
        ax = self._split("batch", rows)
        entry = [a for a in (self.rules.get("batch") or ()) if a in self.mesh.shape]
        if entry and ax is None:
            raise ValueError(f"a batch of {rows} rows does not split over the mesh's {entry}")
        return ax

    def local_batch(self, x):
        ax = self._batch_axis(x.shape[0])
        if ax is None:
            return x
        n = x.shape[0] // ax.size
        return x[ax.index * n:(ax.index + 1) * n]

    def whole_batch(self, x):
        split = [a for a in (self.rules.get("batch") or ()) if a in self.mesh.shape]
        ax = self._batch_axis(x.shape[0] * _axis_size(self.mesh, split))
        return x if ax is None else D.gather_out(x, ax, 0)

    def pmean(self, x, axes):
        present = tuple(a for a in axes if a in self.mesh.shape)
        if set(present) == set(self.mesh.shape):
            return D.pmean(x, self.mesh.world)
        if not present:
            return x
        return D.pmean(x, self._axis(present[0] if len(present) == 1 else present))

    def shard(self, tree, specs):
        return shard_params(tree, specs, self.rules, self.mesh, self.mesh.coords)

    def local_shape(self, spec):
        return local_shape(spec.shape, logical_to_spec(spec.axes, spec.shape, self.rules,
                                                       self.mesh), self.mesh)

    def reduce_grads(self, grads):
        """Each gradient summed over the data-parallel ranks (``FSDP_AXES``:
        FSDP leaves were reduce-scattered by their gathers' backward already,
        a replicated leaf is all-reduced here) and divided by their count: the
        gradient of the mean loss.  The ``model`` ranks hold theirs whole ("f"
        and "g")."""
        split = tuple(a for a in FSDP_AXES if a in self.mesh.shape)
        if not split:
            return grads
        ax = self._axis(split[0] if len(split) == 1 else split)
        out = {}
        for name, g in grads.items():
            if not any(_on(e, split[-1]) for e in self.parts[name]):
                g = D.all_reduce(g, ax)
            out[name] = g / ax.size
        return out

    def sum_once(self, values):
        """Each leaf's value counted on the first rank of every axis it is
        replicated over, summed over the world."""
        total = None
        for name, v in values.items():
            used = {a for e in self.parts[name] if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            if all(self.mesh.coords[a] == 0 for a in self.mesh.shape if a not in used):
                total = v if total is None else total + v
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=next(iter(values.values())).device)
        return D.all_reduce(total, self.mesh.world)
