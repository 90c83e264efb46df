"""Meshes: production mesh shapes without devices, a trace mesh, and a mesh over a process group.

The counterpart of ``repro/launch/mesh.py``.  A :class:`MeshShape` holds a
mesh's axis names and sizes: an ordered ``shape`` mapping of axis name to
size, as ``jax.sharding.Mesh.shape`` gives, and its ``size``.  The dry-run
(``launch/dryrun.py``) traces rank 0 of such a mesh on the meta device
through a :class:`TraceMesh`: the same shape, rank 0's coordinates, and
axes that hold no process group (``distributed.py``'s meta route).

A :class:`ProcessMesh` is the same mapping over a ``torch.distributed``
world of one process per mesh position (PyTorch's idiom for the JAX
package's one controller over many devices): a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
``("data", "model")``, or ``("pod", "data", "model")`` when ``pod > 1``,
the rank's coordinates, and a ``distributed.Axis`` (group, size, index)
per axis, for ``("pod", "data")`` (the ranks that share the ``model``
coordinate, pod-major) and for the whole world.
:func:`launch` starts such a world, one process per rank, and returns what
each rank's function returned:

    results = launch(fn, *args, data=2, model=2, device="cuda", backend="gloo")
    results = launch(fn, *args, pod=2, data=2, model=2, device="cpu")

The ranks meet through a ``FileStore`` in a temporary directory (no TCP
port, so concurrent worlds do not collide).  Each rank's tensors live on
``device`` ("cuda": every rank on card ``rank % device_count``, so one card
takes all four ranks of a 2 x 2 world; "cpu" when asked, with one CPU thread
per rank).  A rank that raises, dies or outlives ``timeout`` fails the run
with its traceback; every rank is stopped before :func:`launch` returns.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch

from repro_torch.distributed import Axis

MESH_AXES = ("data", "model")
POD_MESH_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axes: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axes} and sizes {self.sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")``."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1) -> MeshShape:
    """A ``("data", "model")`` mesh of ``data`` x ``model`` devices, or with
    ``pod > 1`` a ``("pod", "data", "model")`` one of ``pod`` x ``data`` x
    ``model``."""
    if pod > 1:
        return MeshShape(POD_MESH_AXES, (pod, data, model))
    return MeshShape(MESH_AXES, (data, model))


@dataclasses.dataclass(frozen=True)
class TraceMesh(MeshShape):
    """Rank 0 of a :class:`MeshShape` as ``sharding.MeshCtx`` reads a
    :class:`ProcessMesh`, for a trace on the meta device: ``coords`` all 0,
    ``axis(name)`` and ``world`` with no process group.  A dim split over
    several mesh axes (``("pod", "data")`` under every rule table on the
    multi-pod mesh) maps to one trace axis whose size is their product, as
    a live :class:`ProcessMesh` gives it with its group."""

    rank = 0
    device = torch.device("meta")

    @classmethod
    def of(cls, mesh: MeshShape) -> "TraceMesh":
        return cls(tuple(mesh.shape), tuple(mesh.shape.values()))

    @property
    def coords(self) -> dict[str, int]:
        return dict.fromkeys(self.axes, 0)

    @property
    def world(self) -> Axis:
        return Axis("world", None, self.size, 0)

    def axis(self, name) -> Axis:
        names = (name,) if isinstance(name, str) else tuple(name)
        return Axis("/".join(names), None, math.prod(self.shape[n] for n in names), 0)


class ProcessMesh:
    """This rank's view of a ``("data", "model")`` or ``("pod", "data",
    "model")`` mesh over the process group: ``shape`` and ``size`` as
    :class:`MeshShape`'s (so ``sharding.logical_to_spec`` and ``local_shape``
    take it), ``coords`` (axis name -> this rank's index), ``axis(name)``
    and ``world`` (``distributed.Axis``), ``device``.

    ``axis`` also takes ``("pod", "data")`` on a ``("pod", "data", "model")``
    mesh (a dim split over both, as the rule tables split the batch and FSDP
    shards): an ``Axis`` over the ranks that share this rank's ``model``
    coordinate, its index this rank's place among them pod-major
    (``sharding._shard_index``'s order, and the order of the ranks in the
    group: the world ranks are the mesh positions row-major, and a group
    orders its ranks ascending).  Each such group is made here, by every
    rank, in the same order: a collective never makes one."""

    def __init__(self, device_mesh, device: torch.device):
        import torch.distributed as dist

        self.device = device
        names = device_mesh.mesh_dim_names
        self.axes = tuple(names)
        self.sizes = tuple(device_mesh.mesh.shape)
        self.coords = {name: device_mesh.get_local_rank(name) for name in names}
        self._axes = {name: Axis(name, device_mesh.get_group(name), size, self.coords[name])
                      for name, size in zip(names, self.sizes)}
        self.rank = dist.get_rank()
        self.world = Axis("world", dist.group.WORLD, dist.get_world_size(), self.rank)
        if len(names) > 2:  # the axes but the last: one group per coordinate of the last
            lead = self.axes[:-1]
            ranks = device_mesh.mesh.reshape(-1, self.sizes[-1])
            groups = [dist.new_group(sorted(int(r) for r in ranks[:, c]))
                      for c in range(self.sizes[-1])]
            index = 0
            for name in lead:
                index = index * self.shape[name] + self.coords[name]
            self._axes[lead] = Axis("/".join(lead), groups[self.coords[self.axes[-1]]],
                                    math.prod(self.sizes[:-1]), index)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis(self, name) -> Axis:
        key = name if isinstance(name, str) else tuple(name)
        if key not in self._axes:
            raise ValueError(f"the mesh {self.axes} has no axis {name!r}")
        return self._axes[key]


def process_mesh(data: int, model: int, device: torch.device, pod: int = 1) -> ProcessMesh:
    """A ``data`` x ``model`` :class:`ProcessMesh`, or with ``pod > 1`` a
    ``pod`` x ``data`` x ``model`` one, over the world this process belongs
    to: every rank calls it, in the same order.  A world may hold several (a
    2 x 2 mesh and a 4 x 1 one over the same four ranks: how a checkpoint
    written by one restores into the other)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = make_local_mesh(data, model, pod)
    return ProcessMesh(init_device_mesh(device.type, shape.sizes, mesh_dim_names=shape.axes),
                       device)


def _host(tree):
    """A rank's result with its tensors as numpy arrays (bf16 widened to f32,
    exactly), so that it pickles by value."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _rank_main(rank: int, world: int, store: str, shape: tuple[int, int, int], device: str,
               backend: str, timeout: float, fn, args, results) -> None:
    import torch.distributed as dist

    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            torch.set_num_threads(1)  # ranks share the host's cores
            dev = torch.device(device)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(process_mesh(shape[0], shape[1], dev, pod=shape[2]), *args)
        results.put((rank, "ok", _host(out)))
    except BaseException:  # noqa: BLE001 -- the rank's traceback is the parent's error
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, *args, data: int = 2, model: int = 2, pod: int = 1, device: str = "cuda",
           backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on each rank of a ``data`` x ``model`` world (``pod``
    x ``data`` x ``model`` with ``pod > 1``), one process each (``fn`` and
    ``args`` picklable), and return the ranks' results in rank order, their
    tensors as numpy arrays.  Raises with the first failing rank's
    traceback, or when ``timeout`` seconds pass."""
    import torch.multiprocessing as mp

    if device not in ("cuda", "cpu"):
        raise ValueError(f"launch: device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch: no CUDA device is available; pass device='cpu'")
    world = pod * data * model
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, store, (data, model, pod), device, backend, timeout, fn,
                               args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {world} died with exit code "
                                       f"{procs[dead[0]].exitcode} and no traceback")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world}-rank world did not finish in "
                                       f"{timeout:.0f} s (ranks done: {sorted(got)})")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
