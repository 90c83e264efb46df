"""The traced window: ``torch.profiler`` over it, read into device intervals
and host spans.

Device activity (kernels, copies, memsets) and host operations come from
the profiler's own kineto events, with no trace file written.  The
benchmark marks its own calls into the program with ``record_function``
spans (``bench.data_wait``, ``bench.step``, ``bench.loss_read``), so that an
idle gap on the device can be named by what the host was doing then.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


@dataclasses.dataclass
class Trace:
    device: list[tuple[str, str, float, float]]  # (category, name, start_s, end_s)
    host: list[tuple[str, int, float, float]]  # (name, thread, start_s, end_s)
    main_thread: int

    @property
    def kernels(self) -> list[tuple[str, float]]:
        """(name, seconds) of every kernel."""
        return [(n, e - s) for c, n, s, e in self.device if c == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which some kernel, copy or memset ran: their union."""
        busy, end = 0.0, float("-inf")
        for _, _, a, b in sorted(self.device, key=lambda d: d[2]):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    def idle_gaps(self) -> list[tuple[float, float]]:
        """(start_s, end_s) of every stretch with nothing on the device,
        between its first and last activity."""
        gaps, end = [], None
        for _, _, a, b in sorted(self.device, key=lambda d: d[2]):
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        return gaps

    def host_doing(self, gaps: list[tuple[float, float]]) -> list[str]:
        """For each gap, the innermost host span of the main thread that
        covers its middle (of any thread where the main thread shows none)."""
        if not self.host:
            return ["(no host span)"] * len(gaps)
        names = [h[0] for h in self.host]
        tid = np.array([h[1] for h in self.host])
        start = np.array([h[2] for h in self.host])
        end = np.array([h[3] for h in self.host])
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            cover = (start <= mid) & (end >= mid)
            main = cover & (tid == self.main_thread)
            pick = main if main.any() else cover
            if not pick.any():
                out.append("(no host span)")
                continue
            idx = np.flatnonzero(pick)
            out.append(names[idx[np.argmin(end[idx] - start[idx])]])
        return out


class Tracer:
    """``with Tracer(on):`` profiles its body when ``on``; ``.trace`` is then
    the :class:`Trace` of it (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Trace | None = None
        self._prof = None

    def __enter__(self):
        if self.on:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = read_trace(self._prof)
        return False


def read_trace(prof) -> Trace:
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns() / 1e9, e.duration_ns() / 1e9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", bool)():
                continue
            cat = ("memcpy" if name.startswith("Memcpy")
                   else "memset" if name.startswith("Memset") else "kernel")
            device.append((cat, name, s, s + d))
        elif e.device_type() == DeviceType.CPU:
            host.append((name, e.start_thread_id(), s, s + d))
    return Trace(device, host, threading.get_native_id())


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void`` and its argument list, cut to ``width``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


LABELLED_GAPS = 400  # the longest idle gaps, each named by the host span over it


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps' seconds
    by what the host was doing, ``top`` of each, as [name, seconds]."""
    ops: dict[str, float] = {}
    for cat, name, a, b in trace.device:
        key = short_name(name) if cat == "kernel" else name
        ops[key] = ops.get(key, 0.0) + (b - a)
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])
    named, rest = gaps[:LABELLED_GAPS], gaps[LABELLED_GAPS:]
    idle: dict[str, float] = {}
    for (a, b), what in zip(named, trace.host_doing(named)):
        idle[what] = idle.get(what, 0.0) + (b - a)
    if rest:
        idle[f"(the {len(rest)} gaps shorter than the {LABELLED_GAPS} longest)"] = \
            sum(b - a for a, b in rest)

    def rank(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}

