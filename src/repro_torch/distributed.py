"""Collectives over the named axes of a mesh, and their autograd pairs.

The JAX package runs a model over a ``("data", "model")`` mesh from one
controller and leaves most of the communication to GSPMD.  The port runs
one process per mesh position (``launch/mesh.py``), so every collective is
explicit: the model code reaches these functions through the hooks of
``sharding.MeshCtx``, each over an :class:`Axis` of the rank's mesh.

* :func:`all_reduce` (sum or max), :func:`all_gather` and
  :func:`reduce_scatter` along a tensor dim, without gradient;
* the autograd pairs: :func:`fsdp_gather` (forward all-gather, backward
  reduce-scatter: a weight's FSDP shard), :func:`reduce_g` (Megatron's "g":
  forward all-reduce, backward identity: the partial sums of a product whose
  contracted dim is split), :func:`copy_f` (Megatron's "f": forward identity,
  backward all-reduce: an activation every rank holds whole, read by a
  product split over the axis), :func:`gather_out` (forward all-gather,
  backward the rank's own slice: an output split over the axis that every
  rank then reads whole), :func:`own_part` (its inverse: forward the
  rank's own slice of a tensor every rank holds whole, backward an
  all-gather) and :func:`pmean` (forward all-reduce mean, backward
  identity: a value averaged over ranks, as ``jax.lax.pmean``).

Gradients follow Megatron's convention: a value that the ranks of an axis
hold whole is the same on each of them, and so is its gradient; the "f" and
"g" pairs keep it so.  Gradients of the ``data`` replicas are summed by the
train step (``train/step.py``), as data parallelism does.

Routes (:data:`ROUTES`, keyed by the group's backend and the tensor's device,
fixed; no error is caught to pick one):

* Gloo on the CPU uses the native ops (``all_gather_into_tensor``,
  ``reduce_scatter_tensor``).
* Gloo on a card tensor: PyTorch documents only ``broadcast`` and
  ``all_reduce`` for it, so ``all_gather`` is a zero buffer with the rank's
  slot written, summed over a view of its bytes (uint8: each byte has one
  non-zero term, so the sum is exact for any dtype, signed zeros kept), and
  ``reduce_scatter`` a sum of which the rank keeps its slice.
* A meta tensor (the dry-run's trace, ``launch/dryrun.py``, over a
  ``launch.mesh.TraceMesh`` whose axes hold no process group): each
  collective returns a meta tensor of the shape the live one returns, and
  nothing is sent.  The route is the tensor's device, whatever the axis.

Sums of floating tensors narrower than f32 (bf16 activations) are taken in
f32 and cast back.  :data:`moved` counts the payload each rank hands to each
kind of collective, the same on every route: ``all_reduce`` its (f32)
buffer, ``all_gather`` its own part, ``reduce_scatter`` its whole (f32)
input, ``broadcast`` the tensor; :data:`calls` counts the calls.  So a meta
trace of a step counts what a live rank of the same step counts (the
dry-run's ``collectives``; the chip smoke test's report).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

ROUTES = {  # (backend, device type) -> how all_gather and reduce_scatter run
    ("gloo", "cpu"): "native",
    ("gloo", "cuda"): "all_reduce",  # NCCL refuses two ranks on one card: Gloo it is
}
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")
moved: dict[str, int] = dict.fromkeys(KINDS, 0)  # bytes handed to each kind, by this rank
calls: dict[str, int] = dict.fromkeys(KINDS, 0)


def reset_moved() -> None:
    """Set :data:`moved` and :data:`calls` to 0."""
    for kind in KINDS:
        moved[kind] = calls[kind] = 0


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a rank's mesh: its process group, size and this rank's index on it."""

    name: str
    group: Any  # torch.distributed ProcessGroup
    size: int
    index: int


def _route(x: torch.Tensor, axis: Axis) -> str:
    if x.device.type == "meta":
        return "meta"
    key = (dist.get_backend(axis.group), x.device.type)
    if key not in ROUTES:
        raise ValueError(f"no collective route for backend {key[0]!r} with {key[1]} tensors")
    return ROUTES[key]


def _count(kind: str, t: torch.Tensor) -> None:
    moved[kind] += t.numel() * t.element_size()
    calls[kind] += 1


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over the ranks of ``axis``, a new tensor."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op must be 'sum' or 'max', got {op!r}")
    wide = x.is_floating_point() and x.element_size() < 4
    # a new contiguous tensor: the ranks' buffers are summed in storage order
    out = x.to(torch.float32 if wide else x.dtype, memory_format=torch.contiguous_format,
               copy=True)
    _count("all_reduce", out)
    if out.device.type != "meta":
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=axis.group)
    return out.to(x.dtype) if wide else out


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    n = xt.shape[0]
    route = _route(x, axis)
    _count("all_gather", xt)
    if route != "all_reduce":
        out = xt.new_empty((axis.size * n,) + xt.shape[1:])
        if route == "native":
            _all_gather_tensor(out, xt, group=axis.group)
    else:  # a zero buffer with this rank's slot written, summed bit for bit
        out = xt.new_zeros((axis.size * n,) + xt.shape[1:])
        out[axis.index * n:(axis.index + 1) * n] = xt
        dist.all_reduce(out.view(torch.uint8), op=dist.ReduceOp.SUM, group=axis.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` (of ``size / axis.size``) of the sum of
    the ranks' ``x``."""
    wide = x.is_floating_point() and x.element_size() < 4
    xt = (x.float() if wide else x).movedim(dim, 0).contiguous()
    if xt.shape[0] % axis.size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis.size} ranks of {axis.name!r}")
    n = xt.shape[0] // axis.size
    route = _route(x, axis)
    _count("reduce_scatter", xt)
    if route != "all_reduce":
        out = xt.new_empty((n,) + xt.shape[1:])
        if route == "native":
            _reduce_scatter_tensor(out, xt, group=axis.group)
    else:  # the sum, of which this rank keeps its slice
        buf = xt.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
        out = buf[axis.index * n:(axis.index + 1) * n].clone()
    out = out.movedim(0, dim)
    return out.to(x.dtype) if wide else out


# torch 2.13 renames all_gather_into_tensor and reduce_scatter_tensor (and warns on the old names)
_all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def broadcast(x: torch.Tensor, axis: Axis, src_index: int = 0) -> torch.Tensor:
    """``x`` of the rank at ``src_index`` on ``axis``, in place on every rank.
    ``x`` must be contiguous: its storage is sent in memory order."""
    if not x.is_contiguous():
        raise ValueError(f"broadcast: a non-contiguous tensor of strides {x.stride()}")
    _count("broadcast", x)
    if x.device.type != "meta":
        dist.broadcast(x, group=axis.group, group_src=src_index)
    return x


def _own_slice(g: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = g.shape[dim] // axis.size
    return g.narrow(dim, axis.index * n, n).contiguous()


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _ReduceG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.axis, ctx.dim), None, None


class _OwnPart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _own_slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis) / axis.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def fsdp_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """A weight's shard gathered whole along ``dim``; its gradient reduce-scattered back."""
    return _FSDPGather.apply(x, axis, dim)


def reduce_g(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's "g": the sum of the ranks' partial ``x``; the gradient passes through."""
    return _ReduceG.apply(x, axis)


def copy_f(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's "f": ``x`` itself; the ranks' partial gradients summed."""
    return _CopyF.apply(x, axis)


def gather_out(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; each rank's gradient is its slice."""
    return _GatherOut.apply(x, axis, dim)


def own_part(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x``, which every rank holds whole;
    the ranks' gradients of their slices concatenated (the inverse of
    :func:`gather_out`)."""
    return _OwnPart.apply(x, axis, dim)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis`` (``jax.lax.pmean``); the
    gradient passes through."""
    return _PMean.apply(x, axis)
