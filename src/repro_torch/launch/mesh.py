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
``("data", "model")``, the rank's coordinates, and an
``distributed.Axis`` (group, size, index) per axis and for the whole world.
:func:`launch` starts such a world, one process per rank, and returns what
each rank's function returned:

    results = launch(fn, *args, data=2, model=2, device="cuda", backend="gloo")

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


def make_local_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A ``("data", "model")`` mesh of ``data`` x ``model`` devices."""
    return MeshShape(("data", "model"), (data, model))


@dataclasses.dataclass(frozen=True)
class TraceMesh(MeshShape):
    """Rank 0 of a :class:`MeshShape` as ``sharding.MeshCtx`` reads a
    :class:`ProcessMesh`, for a trace on the meta device: ``coords`` all 0,
    ``axis(name)`` and ``world`` with no process group.  A dim split over
    several mesh axes (``("pod", "data")`` under TRAIN_RULES and SERVE_RULES
    on the multi-pod mesh) maps to one trace axis whose size is their
    product; a live :class:`ProcessMesh` has no such axis (ROADMAP Queue 1
    item 4l)."""

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
    """This rank's view of a ``("data", "model")`` mesh over the process group:
    ``shape`` and ``size`` as :class:`MeshShape`'s (so ``sharding.logical_to_spec``
    and ``local_shape`` take it), ``coords`` (axis name -> this rank's index),
    ``axis(name)`` and ``world`` (``distributed.Axis``), ``device``."""

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

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis(self, name: str) -> Axis:
        if not isinstance(name, str):
            raise NotImplementedError(f"a dim split over several mesh axes {name}: the live "
                                      "mesh is (data, model) (ROADMAP Queue 1 item 4l)")
        return self._axes[name]


def process_mesh(data: int, model: int, device: torch.device) -> ProcessMesh:
    """A ``data`` x ``model`` :class:`ProcessMesh` over the world this process
    belongs to: every rank calls it, in the same order.  A world may hold
    several (a 2 x 2 mesh and a 4 x 1 one over the same four ranks: how a
    checkpoint written by one restores into the other)."""
    from torch.distributed.device_mesh import init_device_mesh

    return ProcessMesh(init_device_mesh(device.type, (data, model), mesh_dim_names=MESH_AXES),
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


def _rank_main(rank: int, world: int, store: str, shape: tuple[int, int], device: str,
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
        out = fn(process_mesh(*shape, dev), *args)
        results.put((rank, "ok", _host(out)))
    except BaseException:  # noqa: BLE001 -- the rank's traceback is the parent's error
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, *args, data: int = 2, model: int = 2, device: str = "cuda",
           backend: str = "gloo", timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on each rank of a ``data`` x ``model`` world, one
    process each (``fn`` and ``args`` picklable), and return the ranks'
    results in rank order, their tensors as numpy arrays.  Raises with the
    first failing rank's traceback, or when ``timeout`` seconds pass."""
    import torch.multiprocessing as mp

    if device not in ("cuda", "cpu"):
        raise ValueError(f"launch: device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch: no CUDA device is available; pass device='cpu'")
    world = data * model
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, store, (data, model), device, backend, timeout, fn,
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
                    raise TimeoutError(f"the {data} x {model} world did not finish in "
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
