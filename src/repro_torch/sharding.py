"""Parameter declarations and parameter trees for the port, on one device.

The JAX package keeps parameters as nested dicts (a pytree) with every
layer's weights stacked on a leading ``layers`` axis.  The port keeps the
same leaves, stacked the same way, in a flat ``dict[str, Tensor]`` keyed by
the dotted tree path (``"blocks.attn.wq"``), so that a checkpoint written
by either package has the same leaves in the same order (dict keys sorted,
as ``jax.tree_util.tree_leaves`` orders them).

There is no mesh yet: ``AxisCtx.constrain`` is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


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
    """Counterpart of the JAX package's sharding context; one device, no mesh."""

    def constrain(self, x, *axes):
        return x
