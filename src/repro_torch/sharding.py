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
port has no partitioner: the dry-run (``launch/dryrun.py``) reads these
rules to size one device's share, and ``AxisCtx.constrain`` is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

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


class AxisCtx:
    """Counterpart of the JAX package's sharding context, threaded through the
    model code.  The port has no partitioner: :meth:`constrain` is the
    identity, and so are the hooks through which a layer takes its share of
    the work, :meth:`gather` and :meth:`kv_heads`, and ``expert_rank`` is
    None (every expert).  The dry-run's per-device trace
    (``launch/dryrun.py::DeviceShare``) overrides them with one device's share."""

    def __init__(self, rules=None, mesh=None, remat_policy=None):
        self.rules = rules or TRAIN_RULES
        self.mesh = mesh
        self.remat_policy = remat_policy
        self.expert_rank: tuple[int, int] | None = None  # (rank, ranks): models/moe.py::moe_rank

    def constrain(self, x, *axes):
        return x

    def gather(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """The weight ``name`` (a dotted parameter path, one layer's slice for
        stacked weights) as the layer's products read it."""
        return w

    def kv_heads(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """The K and V heads (B, S, Hkv, hd) that the query heads ``q`` read."""
        return k, v
