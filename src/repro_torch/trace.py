"""Spans, device marks and counters inside the port's hot path, on only
while a profiler records.

``span(name, on)`` is the one mechanism.  With no profiler recording in the
process it returns :data:`NOOP`, one shared context that does nothing (no
allocation, no launch, no library).  While one records it is a
``torch.profiler.record_function(name)`` range, so the span sits among the
trace's host events on the clock of its device events; its parent is the
span around it on the same thread.  The test is the profiler's
process-wide flag, not the per-thread one: the data pipeline's prefetch
thread starts before a profiler does and is not recorded by it, but its
decodes share the stream and have to be marked (below).

**Device marks.**  A span given a CUDA tensor or device as ``on`` launches
a one-thread kernel ``trace_mark_kernel<N>`` (``kernels/csrc/trace_mark.cu``)
on the current stream as it enters and again as it leaves: ``N`` is
``2 * i`` and ``2 * i + 1`` for the span ``MARKED[i]``.  A stream runs its
work in order, so every kernel, copy or memset between a span's two marks
belongs to that span, whichever thread launched it.  On the CPU a mark does
nothing.  ``kernels/_build.py`` builds the marks' library beside the first
kernel it builds, so a traced window never runs ``nvcc`` for it; it is
loaded at the first mark.

**Backward intervals.**  A marked model span that passes its differentiable
inputs through :meth:`Span.inputs` and its outputs through
:meth:`Span.outputs` also gets a device interval ``<name>.bwd`` in the
backward pass: an identity ``autograd.Function`` at the outputs marks its
begin when their gradient arrives, one at the inputs its end when theirs
leaves.  Gradients pass unchanged, so a marked step equals an unmarked one
bit for bit.  Recomputation (the models' per-layer checkpoints) runs the
forward spans again inside the backward pass; they mark again there and add
no backward interval.  A layer's recomputation starts at the first saved
tensor its backward unpacks, which may come after a ``.bwd`` begin mark, so
a ``.bwd`` interval can hold a whole recomputed ``model.block``: readers
that want a layer's own work take those blocks out.

**Counters.**  ``count(name, value)`` adds a host number or a device scalar
(added on the device: nothing synchronizes) while a profiler records, and
not while a backward pass recomputes a forward; :func:`counters` reads them
all with one synchronization.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

TRAIN = ("train.step", "train.forward", "train.backward", "train.accumulate", "train.optimizer")
MODEL = ("model.embed", "model.block", "attn.mla", "attn.kernel", "mlp", "moe.route",
         "moe.dispatch", "moe.experts", "moe.combine", "moe.shared", "model.head", "model.xent")
BACKWARD = tuple(f"{name}.bwd" for name in MODEL if name != "model.block")
DATA = ("rpc.decode",)
MARKED = TRAIN + MODEL + BACKWARD + DATA  # the table of marks: span i marks 2i and 2i + 1
NUMBER = {name: i for i, name in enumerate(MARKED)}


def mark_name(number: int) -> tuple[str, bool]:
    """(span, is_end) of mark ``number``."""
    return MARKED[number // 2], bool(number % 2)


def counting() -> bool:
    """Whether :func:`count` counts now: a profiler records in this process
    and no backward pass is recomputing a forward."""
    return _profiler._is_profiler_enabled and not _in_backward()


@functools.cache  # the one cache of the loaded library
def mark_library() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("trace_mark")
    lib.trace_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.trace_mark_launch.restype = ctypes.c_int
    lib.trace_mark_count.argtypes = []
    lib.trace_mark_count.restype = ctypes.c_int
    lib.trace_mark_error_string.argtypes = [ctypes.c_int]
    lib.trace_mark_error_string.restype = ctypes.c_char_p
    if lib.trace_mark_count() < 2 * len(MARKED):
        raise RuntimeError(f"trace_mark.cu holds {lib.trace_mark_count()} marks; the table "
                           f"needs {2 * len(MARKED)}")
    return lib


def _cuda_index(on) -> int | None:
    """The CUDA device index of ``on`` (a tensor or device), None off the card."""
    if on is None:
        return None
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type != "cuda":
        return None
    return torch.cuda.current_device() if dev.index is None else dev.index


def _launch_mark(number: int, index: int) -> None:
    lib = mark_library()
    with torch.cuda.device(index):
        err = lib.trace_mark_launch(number, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"trace mark {number}: {lib.trace_mark_error_string(err).decode()}")


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class _Noop:
    """What :func:`span` returns with no profiler recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, *tensors):
        return tensors[0] if len(tensors) == 1 else tensors

    outputs = inputs


NOOP = _Noop()


class _MarkInBackward(torch.autograd.Function):
    """Identity on a span's inputs or outputs; its backward launches a mark
    of ``<span>.bwd`` when their gradient passes."""

    @staticmethod
    def forward(ctx, number, index, *xs):
        ctx.number, ctx.index = number, index
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _launch_mark(ctx.number, ctx.index)
        return (None, None) + grads


class Span:
    """A span while a profiler records (see the module docstring)."""

    def __init__(self, name: str, index: int | None):
        self.name, self.index = name, index
        self._rf = record_function(name)
        self._bwd = None  # the mark number of ``<name>.bwd``'s begin, once inputs are wrapped

    def __enter__(self):
        self._rf.__enter__()
        if self.index is not None:
            _launch_mark(2 * NUMBER[self.name], self.index)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            _launch_mark(2 * NUMBER[self.name] + 1, self.index)
        self._rf.__exit__(*exc)
        return False

    def _wrap(self, number: int, tensors):
        live = [i for i, t in enumerate(tensors) if t.requires_grad]
        out = list(tensors)
        for i, t in zip(live, _MarkInBackward.apply(number, self.index,
                                                    *(tensors[i] for i in live))):
            out[i] = t
        return out[0] if len(out) == 1 else tuple(out)

    def inputs(self, *tensors):
        """``tensors`` unchanged in value; the end of ``<name>.bwd`` where they
        carry a gradient."""
        bwd = f"{self.name}.bwd"
        if (self.index is None or bwd not in NUMBER or not torch.is_grad_enabled()
                or _in_backward() or not any(t.requires_grad for t in tensors)):
            return NOOP.inputs(*tensors)
        self._bwd = 2 * NUMBER[bwd]
        return self._wrap(self._bwd + 1, tensors)

    def outputs(self, *tensors):
        """``tensors`` unchanged in value; the begin of ``<name>.bwd`` (only
        after :meth:`inputs` took its end)."""
        if self._bwd is None or not any(t.requires_grad for t in tensors):
            return NOOP.inputs(*tensors)
        return self._wrap(self._bwd, tensors)


def span(name: str, on=None):
    """A span ``name``, marked on the device of ``on`` (a tensor or device)
    where that is a CUDA device and ``name`` is in :data:`MARKED`."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    index = _cuda_index(on) if name in NUMBER else None
    return Span(name, index)


_lock = threading.Lock()
_host: dict[str, float] = {}
_device: dict[str, torch.Tensor] = {}


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a device scalar added on its device) to
    the counter ``name``, while a profiler records and outside a backward
    pass's recomputation."""
    if not counting():
        return
    with _lock:
        if isinstance(value, torch.Tensor):
            acc = _device.get(name)
            if acc is None:
                _device[name] = value.detach().clone()
            else:
                acc.add_(value)
        else:
            _host[name] = _host.get(name, 0.0) + float(value)


def counters() -> dict[str, float]:
    """Every counter's total so far: one synchronization for the device's."""
    with _lock:
        out = dict(_host)
        if _device:
            ref = next(iter(_device.values())).device
            values = torch.stack([v.to(ref, torch.float64) for v in _device.values()])
            out.update(zip(_device, values.tolist()))
    return out
