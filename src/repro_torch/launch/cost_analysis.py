"""What a step computes and holds, counted op by op on the meta device.

The counterpart of ``repro/launch/hlo_analysis.py``.  That module parses the
partitioned HLO text that XLA compiles, which PyTorch never produces; this
one is a ``TorchDispatchMode`` that sees every aten op a step dispatches
(the backward and the recomputation of checkpointed layers included) on
meta tensors, where nothing is allocated, and tallies:

* **FLOPs**: 2 * M * N * K for every product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``: what ``einsum``, ``matmul`` and ``linear`` decompose into),
  plus the operations each hand-written kernel declares for its launch on
  the meta device (``kernels/ops.py``: the kernels are not aten ops).
* **bytes at op boundaries**: every tensor an op reads plus every tensor it
  writes.  Views cost nothing; a gather or a copy costs twice its output (a
  read and a write of what it moves, as ``hlo_analysis.py`` counts slices,
  gathers and copies); an indexed write (``index_put_``, ``scatter_add_``)
  twice the values it writes plus its indices; a fill its output once.
* **peak live bytes**: a storage an op creates (one that none of its inputs
  holds) is counted when it appears and uncounted by a weakref finalizer
  when its last tensor dies; the peak is the most held at once.  Storages
  that existed before the analysis began (a step's arguments) are not
  counted.
* **per-op counts**, by aten op name, and per-kernel launches;
* the storages ops **read** (``read``: ids), so that a caller can tell the
  inputs a step never touches.

An op whose kernel on the card is a composite of other aten ops that holds
full-size temporaries (``logsumexp``, whose meta kernel allocates only its
output) is run as that composite under the analysis, so its temporaries
count as they do on the card.

What the two counts see differently.  XLA fuses chains of elementwise ops
into one kernel, so its boundary bytes count a fusion's inputs and outputs
once, while the eager count charges every intermediate of such a chain a
write and a read (norms, RoPE, softmax statistics, casts); XLA also keeps
values in registers that eager PyTorch writes out.  Conversely, eager
views (transposes, reshapes, slices of stacked layers) cost nothing where
XLA may copy to change a layout, and the port's hand-written attention
reads Q, K and V once where the JAX package's chunked attention writes and
reads its score blocks.  Both multiply loop bodies out: XLA by the trip
counts of its ``while`` loops, the eager trace by running each layer and
microbatch.  Only products count as FLOPs in both.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops

aten = torch.ops.aten

_PRODUCTS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}
_MOVES = {  # gathers and copies: read and write what they move
    aten.index.Tensor, aten.gather.default, aten.index_select.default, aten.embedding.default,
    aten.clone.default, aten._to_copy.default, aten.copy_.default, aten.copy.default,
    aten.repeat.default, aten.expand_copy.default,
}
_INDEXED_WRITES = {aten.index_put_.default, aten.index_put.default, aten.scatter_add_.default,
                   aten.scatter_add.default, aten.index_add_.default, aten.index_add.default}
_FILLS = {aten.zeros.default, aten.ones.default, aten.full.default, aten.fill_.Scalar,
          aten.zero_.default, aten.arange.default, aten.arange.start,
          aten.arange.start_step, aten.zeros_like.default, aten.ones_like.default,
          aten.full_like.default, aten.new_zeros.default, aten.new_ones.default,
          aten.new_full.default, aten.scalar_tensor.default}
_FREE = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
         aten.new_empty.default, aten.new_empty_strided.default, aten.detach.default,
         aten.alias.default, aten.lift_fresh.default}


def _logsumexp(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """ATen's ``logsumexp`` composite (``logsumexp_out_impl``), op for op:
    on the card it runs as these ops, one of them a full-size temporary
    that the meta kernel never allocates."""
    maxes = torch.amax(x, dims, True)
    squeezed = maxes if keepdim else maxes.squeeze(dims)
    squeezed.masked_fill_(squeezed.abs() == float("inf"), 0)
    out = torch.sum(torch.sub(x, maxes).exp_(), dims, keepdim)
    return out.log_().add_(squeezed)


# ops whose card kernel is a composite of other ops: run as those ops under the analysis
_CARD_COMPOSITES = {aten.logsumexp.default: _logsumexp}


def _tensors(tree) -> list[torch.Tensor]:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out.extend(_tensors(x))
    elif isinstance(tree, dict):
        for x in tree.values():
            out.extend(_tensors(x))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def product_flops(func, args) -> float:
    """2 * M * N * K of an aten product (its batch dimension included)."""
    if func in (aten.mm.default, aten.addmm.default):
        a, b = (args[0], args[1]) if func is aten.mm.default else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if func is aten.bmm.default else (args[1], args[2])
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


class CostAnalysis(TorchDispatchMode):
    """``with CostAnalysis() as cost: step(...)``: then ``cost.flops``,
    ``cost.bytes``, ``cost.peak_bytes``, ``cost.live_bytes`` (held at the
    end), ``cost.op_counts``, ``cost.kernels`` and ``cost.read``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.op_counts: collections.Counter = collections.Counter()
        self.kernels: dict[str, dict[str, float]] = {}
        self._live: dict[int, int] = {}  # id of a storage created here -> its bytes
        self.read: set[int] = set()  # ids of the storages ops took as inputs

    # -- kernels (told by kernels/ops.py) ------------------------------------------
    def kernel(self, name: str, flops: float, nbytes: int) -> None:
        row = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        ops.COST_LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.COST_LISTENERS.remove(self)
        return super().__exit__(*exc)

    # -- live storages ---------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, outs: list[torch.Tensor], ins: list[torch.Tensor]) -> None:
        held = {id(t.untyped_storage()) for t in ins}
        self.read |= held
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- every aten op -------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _CARD_COMPOSITES:
            with self:
                return _CARD_COMPOSITES[func](*args, **kwargs)
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        self.op_counts[func.overloadpacket.__name__] += 1
        if func in _PRODUCTS:
            self.flops += product_flops(func, args)
        if func in _FREE or func.is_view:
            pass
        elif func in _MOVES:
            self.bytes += 2 * sum(map(_nbytes, outs))
        elif func in _INDEXED_WRITES:
            values = args[2] if func in (aten.index_put_.default, aten.index_put.default) \
                else args[3]
            index = args[1] if func not in (aten.index_put_.default, aten.index_put.default) \
                else [i for i in args[1] if i is not None]
            self.bytes += 2 * _nbytes(values) + sum(map(_nbytes, _tensors(index)))
        elif func in _FILLS:
            self.bytes += sum(map(_nbytes, outs))
        else:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._track(outs, ins)
        return out
