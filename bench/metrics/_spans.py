"""The program's spans in a traced window, for the per-layer readers.

``repro_torch/trace.py`` launches a one-thread kernel ``trace_mark_kernel<N>``
on the stream where a marked span begins and where it ends; its table says
which span and which end ``N`` is.  A span's k-th begin mark pairs with its
k-th end mark, each counted in time order (no span nests in itself), and the
pair gives an interval on the device's own clock: from the end of the begin
mark to the start of the end mark.  The marks are not paired like brackets
across spans: on the H100 the trace's timestamps now and then put a run of
kernels, marks among them, before kernels that were launched earlier on the
same stream (by the launches' correlation ids), so that an end mark can
appear before the begin mark of its parent, or of itself where the span is
short.  Counted per span and per end, the order holds.  The stream runs in order, so the
device's work in an interval is the span's, but for what the data
pipeline's prefetch thread puts on the same stream meanwhile.  Its decodes
are marked (``rpc.decode``), but their marks also hold whatever the
training threads launched while the decode waited on the stream (a
traced window showed more of that than of the decode's own work), so the
phases leave out only the decode's own operations inside those marks: the
``gf_matmul`` kernels and the host-device copies, which no training phase
launches.  Work is every kernel, copy and memset but the marks themselves.

A program without the module, or a window without its marks, gives None;
so does a span with more begin than end marks or the reverse (a reader
never gives part of a number).  The one exception is the prefetch thread's
``rpc.decode`` at the window's edges: one begun before the window has an
end alone, left out; one that the window's end cut lasts to the window's
last device activity.
"""
from __future__ import annotations

import bisect
import re

import numpy as np

MARK = re.compile(r"trace_mark_kernel<(\d+)>")
DECODE = "rpc.decode"
DATA_PLANE = re.compile(r"gf_matmul|^Memcpy (HtoD|DtoH)")  # the decode's own operations


def program_trace():
    """The program's ``trace`` module, or None (a program without spans)."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace


class Union:
    """Disjoint intervals (the union of the given ones), measured over any
    stretch by binary search."""

    def __init__(self, intervals):
        merged: list[list[float]] = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        arr = np.array(merged, dtype=np.float64).reshape(-1, 2)
        self.start, self.end = arr[:, 0], arr[:, 1]
        self.cum = np.concatenate([[0.0], np.cumsum(self.end - self.start)])

    def _overlapping(self, a: float, b: float) -> tuple[int, int]:
        """The index range of the intervals that meet (a, b)."""
        return (int(np.searchsorted(self.end, a, side="right")),
                int(np.searchsorted(self.start, b, side="left")))

    def measure(self, a: float, b: float) -> float:
        """Seconds of the union inside [a, b]."""
        i, j = self._overlapping(a, b)
        if j <= i:
            return 0.0
        total = self.cum[j] - self.cum[i]
        total -= max(0.0, a - self.start[i]) + max(0.0, self.end[j - 1] - b)
        return max(0.0, float(total))

    def intervals(self, a: float = -np.inf, b: float = np.inf):
        """The intervals that meet (a, b), whole."""
        i, j = self._overlapping(a, b)
        return zip(self.start[i:j].tolist(), self.end[i:j].tolist())

    def holds(self, a: float, b: float) -> bool:
        """Whether one interval holds all of [a, b]."""
        i = int(np.searchsorted(self.start, a, side="right")) - 1
        return i >= 0 and b <= self.end[i]

    def outside(self, a: float, b: float) -> list[tuple[float, float]]:
        """The pieces of [a, b] that no interval covers."""
        pieces, t = [], a
        for s, e in self.intervals(a, b):
            if s > t:
                pieces.append((t, s))
            t = max(t, e)
        if t < b:
            pieces.append((t, b))
        return pieces


class Spans:
    """A window's marks, paired (see the module docstring)."""

    def __init__(self, trace, table):
        work, marks, own = [], [], []
        for cat, name, a, b in trace.device:
            found = MARK.search(name) if cat == "kernel" else None
            if found:
                marks.append((a, b, int(found.group(1))))
            else:
                work.append((a, b))
                if DATA_PLANE.search(name):
                    own.append((a, b))
        self.work = Union(work)
        self.activity = Union((a, b) for _, _, a, b in trace.device)
        last = float(self.activity.end[-1]) if len(self.activity.end) else 0.0
        self.spans: dict[str, list[tuple[float, float]]] = {}
        self.unpaired: set[str] = set()
        begins: dict[str, list[tuple[float, float]]] = {}
        ends: dict[str, list[tuple[float, float]]] = {}
        for a, b, number in marks:
            if number < 2 * len(table):
                (ends if number % 2 else begins).setdefault(table[number // 2], []).append((a, b))
        for name in begins.keys() | ends.keys():
            opened, closed = sorted(begins.get(name, [])), sorted(ends.get(name, []))
            if name == DECODE:
                if closed and (not opened or closed[0][0] < opened[0][1]):
                    closed.pop(0)  # a decode begun before the window
                if len(opened) == len(closed) + 1:
                    closed.append((last, last))  # one that the window's end cut
            if len(opened) != len(closed):
                self.unpaired.add(name)
            else:
                self.spans[name] = [(o[1], c[0]) for o, c in zip(opened, closed)]
        self.decode = Union(self.spans.get(DECODE, []))
        self.decode_own = Union((max(a, d0), min(b, d1)) for a, b in own
                                for d0, d1 in self.decode.intervals(a, b))
        self.steps = len(self.spans.get("train.step", []))

    def present(self, names) -> list[str]:
        """Those of ``names`` whose marks the window holds."""
        return [n for n in names if n in self.spans or n in self.unpaired]

    def get(self, *names) -> list[tuple[float, float]] | None:
        """Every interval of ``names``; None where one has none or does not pair."""
        if any(n in self.unpaired or n not in self.spans for n in names):
            return None
        return [iv for n in names for iv in self.spans[n]]

    def work_s(self, intervals) -> float:
        """Device work in the union of ``intervals``, less the decodes' own."""
        return sum(self.work.measure(a, b) - self.decode_own.measure(a, b)
                   for a, b in Union(intervals).intervals())

    def idle_s(self, intervals) -> float:
        """Seconds of ``intervals`` in which nothing ran on the device."""
        return sum((b - a) - self.activity.measure(a, b) for a, b in Union(intervals).intervals())

    def per_step_ms(self, seconds: float) -> float:
        return 1e3 * seconds / self.steps

    def work_ms(self, *names) -> float | None:
        """Device work a window step within ``names``' intervals."""
        intervals = self.get(*names)
        return None if intervals is None else self.per_step_ms(self.work_s(intervals))

    def own_work_ms(self, *names) -> float | None:
        """:meth:`work_ms` of model spans, less the recomputed layers that
        their ``.bwd`` intervals hold.  A layer's recomputation starts at the
        first saved tensor its backward unpacks, and that can come after a
        ``.bwd`` begin mark: the whole recomputed ``model.block`` (its
        attention, norms and all) then runs inside, say, ``moe.shared.bwd``.
        So each interval of ``names`` loses the recomputed blocks in it,
        but for one that lies inside such a block: that is the span's own
        recomputation, kept whole."""
        intervals = self.get(*names)
        if intervals is None:
            return None
        again = Union(self.inside(["model.block"], "train.backward") or [])
        own = [piece for a, b in intervals
               for piece in ([(a, b)] if again.holds(a, b) else again.outside(a, b))]
        return self.per_step_ms(self.work_s(own))

    def idle_ms(self, name: str) -> float | None:
        intervals = self.get(name)
        return None if intervals is None else self.per_step_ms(self.idle_s(intervals))

    def inside(self, names, outer: str) -> list[tuple[float, float]] | None:
        """The intervals of ``names`` that lie within one of ``outer``'s."""
        spans, bounds = self.get(*names), self.get(outer)
        if spans is None or bounds is None:
            return None
        bounds = sorted(bounds)
        starts = [o0 for o0, _ in bounds]

        def within(a, b):  # the last outer interval that starts by a holds it, if one does
            k = bisect.bisect_right(starts, a) - 1
            return k >= 0 and b <= bounds[k][1]

        return [(a, b) for a, b in spans if within(a, b)]


_CACHE: dict = {}


def spans(run) -> Spans | None:
    """The run's :class:`Spans`, or None where it has no steps' marks."""
    trace = program_trace()
    if run.trace is None or trace is None:
        return None
    key = id(run.trace)
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = (run.trace, Spans(run.trace, trace.MARKED))
    found = _CACHE[key][1]
    return found if found.steps and "train.step" not in found.unpaired else None


def counters(run) -> dict[str, float] | None:
    """The program's counters after a traced window, or None where it kept
    none (no such module, an untraced run, no step counted)."""
    trace = program_trace()
    if run.trace is None or trace is None:
        return None
    found = trace.counters()
    return found if found.get("train.steps") else None
