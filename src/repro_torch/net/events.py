"""Deterministic shared discrete-event engine for the whole data plane.

Before this module existed, every ``HedgedScheduler.fetch`` ran a *private*
event heap to completion before the next request started: hedge timers and
failure recoveries of concurrent requests could never interleave, and only
trunk reservations coupled requests.  The :class:`EventLoop` here is the
single global event queue the entire read path now runs on — concurrent
requests' issue/deadline/recovery events genuinely interleave, SPs queue,
NICs serialize — while staying exactly reproducible: events are ordered by
``(time, insertion seq)`` with a monotone sequence counter, so two runs of
the same workload pop the same events in the same order.  The queue itself
is a :class:`CalendarQueue` by default (O(1) expected per op at serving
event rates); ``engine="heap"`` keeps the original binary heap, and both
disciplines pop the identical total order, so swapping them never moves a
digest (asserted by ``tests/test_engine_equivalence.py``).

Tasks are plain Python generators that yield *effects*:

* ``Sleep(ms)``                 — resume after ``ms`` simulated milliseconds;
* ``Transfer(src, dst, nbytes)`` — move bytes across the loop's attached
  :class:`~repro_torch.net.backbone.Backbone` (NIC + trunk serialization and
  propagation accounted); resumes at the arrival time;
* ``Acquire(resource, capacity)`` / ``Release(resource)`` — counting
  semaphore with a FIFO wait queue (SP disk slots, any shared resource).
  Acquires carry a *priority class* (0 = foreground) and an optional
  per-class slot cap: waiters wake in (priority, FIFO) order, and a class
  at its cap queues even while slots are free — this is how background
  traffic (audits, repair) shares an SP's disks with paid serving without
  ever starving it;
* ``Join(handle)``              — wait for a task spawned with
  :meth:`EventLoop.spawn`; resumes with its return value, or re-raises
  its exception;
* ``Recv(channel)``             — wait for a message on a
  :class:`Channel` (how a hedged fetch hears from its in-flight legs
  *and* its deadline timer through one ordered stream).

:class:`SingleFlight` is the cache-stampede primitive built on ``Join``:
concurrent callers asking for the same key share ONE spawned task (the
first caller leads, the rest coalesce), so N simultaneous misses on a hot
object cost one fetch instead of N.

Sync callers keep working: wrap a task in a fresh loop and
``run_until`` it (see ``RPCNode.read_items_detailed``).  Concurrent
drivers (``repro_torch.net.workloads.replay_open_loop`` /
``replay_closed_loop``) spawn one task per request on a shared loop and
``run()`` everything to completion.

The runtime sanitizer (``sanitize=True`` / ``SHELBY_SIMSAN``) is not part
of this package yet: asking for it raises :class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
import sys
import time
from collections import deque
from typing import Any, Callable, Generator

#: queue discipline new loops use when ``engine`` is not given explicitly.
#: "calendar" is the production default; "heap" keeps the original binary
#: heap alive so the engine-equivalence tests can diff the two pop orders.
DEFAULT_ENGINE = "calendar"

#: process-wide engine telemetry, accumulated across EVERY loop drained in
#: this process — benchmark sections that drive many private loops (e.g. the
#: sync serve grid) report a delta of this instead of one loop's counters.
ENGINE_COUNTERS = {"events": 0, "wall_s": 0.0}


def engine_counters() -> tuple[int, float]:
    """Snapshot of (events processed, wall seconds) across all loops."""
    return ENGINE_COUNTERS["events"], ENGINE_COUNTERS["wall_s"]


# -- effects (what a task may yield) ----------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sleep:
    """Resume this task after ``ms`` simulated milliseconds."""

    ms: float


@dataclasses.dataclass(frozen=True)
class Transfer:
    """Move ``nbytes`` src -> dst over the loop's attached network."""

    src: str
    dst: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class Acquire:
    """Take one slot of a shared resource; queues FIFO when saturated.

    ``capacity`` sizes the resource the first time its key is seen;
    later acquires of the same key ignore it.

    ``priority`` is the scheduling class (0 = foreground; larger numbers
    are more deferrable) and ``limit`` caps how many slots THIS class may
    hold concurrently — a background acquire at its class cap queues even
    while free slots exist, so paid serving always finds headroom.  Waiters
    wake in (priority, arrival) order: a queued foreground request is never
    overtaken by background work.
    """

    resource: Any  # hashable key, e.g. ("sp", 3)
    capacity: int = 1
    priority: int = 0
    limit: int | None = None  # max concurrent slots for this priority class


@dataclasses.dataclass(frozen=True)
class Release:
    """Give back one slot; wakes the best eligible waiter at the current
    time.  ``priority`` must match the class of the paired ``Acquire`` so
    per-class accounting stays balanced."""

    resource: Any
    priority: int = 0


def safe_release(effect: "Release") -> Generator:
    """``yield from`` this inside a ``finally:`` block to give a slot back
    on every *live* exit path — normal completion and thrown exceptions —
    of a task's critical section::

        yield Acquire(("sp", 3), slots)
        try:
            yield Sleep(service_ms)
        finally:
            yield from safe_release(Release(("sp", 3)))

    During task *teardown* (``GeneratorExit`` — the generator of a
    ``run_until`` straggler being garbage-collected, or an explicit
    ``gen.close()``) it yields nothing: a closing generator may not yield
    (``RuntimeError: generator ignored GeneratorExit``), and slot reclaim
    for cancelled tasks is the engine's job (``TaskHandle.cancel``), so
    yielding here would be both illegal and double-counted."""
    if isinstance(sys.exc_info()[1], GeneratorExit):
        return
    yield effect


@dataclasses.dataclass(frozen=True)
class Join:
    """Wait for another task; resumes with its result or raises its error."""

    handle: "TaskHandle"


@dataclasses.dataclass(frozen=True)
class Recv:
    """Wait for (or immediately take) the next message on a channel."""

    channel: "Channel"


class TaskHandle:
    """One spawned task: its generator, lifecycle state, and joiners."""

    __slots__ = (
        "gen", "label", "done", "result", "error", "error_delivered",
        "cancelled", "started_ms", "finished_ms", "_joiners",
        "held", "_loop",
    )

    def __init__(self, gen: Generator, label: str, started_ms: float):
        self.gen = gen
        self.label = label
        self.done = False
        self.result: Any = None
        self.error: BaseException | None = None
        self.error_delivered = False
        self.cancelled = False
        self.started_ms = started_ms
        self.finished_ms = float("nan")
        self._joiners: list["TaskHandle"] = []
        # resource slots this task currently holds, as (key, priority,
        # t_acquired) — lets cancel() give slots back
        self.held: list[tuple[Any, int, float]] = []
        self._loop: "EventLoop | None" = None

    def cancel(self) -> None:
        """Drop the task: pending wakeups for it are skipped when popped,
        and any resource slots it still holds are released back to the
        loop at the current sim time.  (The generator is abandoned, not
        closed, so a `finally: yield Release` inside it can never run —
        the engine must reclaim the slots itself or they leak.)"""
        self.cancelled = True
        if self._loop is not None and not self.done and self.held:
            self._loop._reclaim(self)

    def __repr__(self) -> str:  # debugging aid only
        state = "done" if self.done else ("cancelled" if self.cancelled else "live")
        return f"<Task {self.label} {state}>"


class Resource:
    """Counting semaphore with a priority wait queue and queueing telemetry.

    Waiters are ordered by (priority class, arrival seq) — FIFO within a
    class, foreground (class 0) ahead of background.  A class with a slot
    cap (``Acquire.limit``) is skipped while at its cap, letting slots sit
    free for foreground work instead of being soaked up by background.
    """

    __slots__ = ("key", "capacity", "in_use", "waiters", "acquired",
                 "wait_ms_total", "max_queue", "in_use_by_class",
                 "wait_ms_by_class", "acquired_by_class")

    def __init__(self, key: Any, capacity: int):
        if capacity < 1:
            raise ValueError(f"resource {key!r} needs capacity >= 1")
        self.key = key
        self.capacity = capacity
        self.in_use = 0
        # priority class -> FIFO of (handle, enqueue_ms, class_limit); wake
        # order is class-ascending then FIFO, so a release is O(#classes),
        # not O(queue depth) — the foreground-only saturation path keeps
        # its old one-deque cost
        self.waiters: dict[int, deque[tuple[TaskHandle, float, int | None]]] = {}
        self.acquired = 0
        self.wait_ms_total = 0.0
        self.max_queue = 0
        self.in_use_by_class: dict[int, int] = {}
        self.wait_ms_by_class: dict[int, float] = {}
        self.acquired_by_class: dict[int, int] = {}

    def can_grant(self, priority: int, limit: int | None) -> bool:
        if self.in_use >= self.capacity:
            return False
        if limit is not None and self.in_use_by_class.get(priority, 0) >= limit:
            return False
        return True

    def grant(self, priority: int, waited_ms: float = 0.0) -> None:
        self.in_use += 1
        self.acquired += 1
        self.in_use_by_class[priority] = self.in_use_by_class.get(priority, 0) + 1
        self.acquired_by_class[priority] = self.acquired_by_class.get(priority, 0) + 1
        if waited_ms:
            self.wait_ms_total += waited_ms
            self.wait_ms_by_class[priority] = (
                self.wait_ms_by_class.get(priority, 0.0) + waited_ms
            )

    def enqueue(self, priority: int, handle: TaskHandle, t_ms: float,
                limit: int | None) -> None:
        self.waiters.setdefault(priority, deque()).append((handle, t_ms, limit))
        self.max_queue = max(
            self.max_queue, sum(len(q) for q in self.waiters.values())
        )

    def pop_eligible(self) -> tuple[int, TaskHandle, float] | None:
        """Remove and return the first live waiter in (priority class,
        FIFO) order whose class is under its cap; purge dead entries on
        the way.  A capped class head blocks its whole class (strict FIFO
        within a class), never other classes."""
        for prio in sorted(self.waiters):
            q = self.waiters[prio]
            while q:
                h, t0, limit = q[0]
                if h.cancelled or h.done:
                    q.popleft()
                    continue
                if (limit is not None
                        and self.in_use_by_class.get(prio, 0) >= limit):
                    break  # class at its cap: try the next class
                q.popleft()
                return prio, h, t0
        return None


class Channel:
    """Unbounded FIFO message queue; one waiter resumed per send."""

    def __init__(self, loop: "EventLoop"):
        self._loop = loop
        self._queue: deque[Any] = deque()
        self._waiters: deque[TaskHandle] = deque()

    def send(self, value: Any) -> None:
        """Deliver a message at the loop's current time (callable from any
        task's step — the oldest live waiter is scheduled, FIFO)."""
        while self._waiters:
            h = self._waiters.popleft()
            if h.cancelled or h.done:
                continue
            self._loop._push(self._loop.now, h, ("resume", value))
            return
        self._queue.append(value)


class SingleFlight:
    """Per-key in-flight task dedup (the classic cache-stampede collapse).

    The first caller of :meth:`flight` for a key becomes the *leader*: its
    factory generator is spawned on the loop and registered under the key.
    Every later caller while that task is live is a *follower*: it gets the
    leader's :class:`TaskHandle` back and simply ``Join``\\ s it — one fetch
    serves all concurrent waiters, and the key is released the moment the
    task finishes (success or error), so a later miss starts a fresh
    flight.  Errors propagate to every joiner, exactly like ``Join``.

    One instance is bound to one :class:`EventLoop`; holders that outlive a
    loop (e.g. an ``RPCNode`` called through many private loops) should key
    their instance by the loop (see ``RPCNode._single_flight_for``).
    """

    def __init__(self, loop: "EventLoop"):
        self.loop = loop
        self._inflight: dict[Any, TaskHandle] = {}
        self.launched = 0  # flights that actually spawned a task
        self.coalesced = 0  # callers that piggybacked on a live flight

    def live(self, key: Any) -> bool:
        """True iff a flight for ``key`` is currently in the air (a call
        to :meth:`flight` now would coalesce instead of spawning)."""
        h = self._inflight.get(key)
        return h is not None and not h.done and not h.cancelled

    def flight(self, key: Any, factory: Callable[[], Generator],
               label: str | None = None) -> tuple["TaskHandle", bool]:
        """Return ``(handle, leader)`` — ``leader`` is True iff this call
        spawned the task (the caller should Join the handle either way)."""
        live = self._inflight.get(key)
        if live is not None and not live.done and not live.cancelled:
            self.coalesced += 1
            return live, False

        def flown():
            try:
                result = yield from factory()
            finally:
                # release on the same event step the task finishes, so a
                # miss arriving any later starts a fresh flight
                if self._inflight.get(key) is h:
                    del self._inflight[key]
            return result

        h = self.loop.spawn(flown(), label=label or f"flight{key}")
        self._inflight[key] = h
        self.launched += 1
        return h, True


class _BinaryHeap:
    """The original single binary heap, kept behind the ``engine="heap"``
    knob as the reference pop order for the calendar queue."""

    __slots__ = ("_h",)

    def __init__(self):
        self._h: list[tuple[float, int, TaskHandle, tuple[str, Any]]] = []

    def __len__(self) -> int:
        return len(self._h)

    def push(self, item) -> None:
        heapq.heappush(self._h, item)

    def pop(self):
        return heapq.heappop(self._h)


class CalendarQueue:
    """Calendar queue over simulated time: events bucket into fixed-width
    *days* keyed by ``floor(t / width)``.

    Keying days in a dict (instead of the classic modulo ring) makes
    far-future timestamps safe — there is no year wrap to corrupt ordering,
    a day materializes only when an event lands in it, and it is freed the
    moment it drains.  Each day's bucket is heap-ordered by the full
    ``(t_ms, seq, …)`` tuple and a small heap of day indices finds the next
    nonempty day, so ``pop`` always returns the *global* ``(time, seq)``
    minimum: the pop order is bit-identical to the single binary heap's,
    which is what keeps every existing determinism digest unchanged.

    Cost: O(1) expected per op while buckets stay small (they do when
    ``width_ms`` is on the order of the mean event gap — sub-ms to a few ms
    for this data plane); degrades gracefully toward plain heap behaviour
    when everything lands in one day (zero-delay wake storms) or every
    event gets its own day (sparse timers), never worse than O(log n).
    """

    __slots__ = ("width", "_days", "_day_heap", "_len")

    def __init__(self, width_ms: float = 1.0):
        if width_ms <= 0:
            raise ValueError("calendar day width must be positive")
        self.width = width_ms
        # invariant: _day_heap holds exactly the keys of _days (no stale ids)
        self._days: dict[int, list] = {}
        self._day_heap: list[int] = []
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, item) -> None:
        day = int(item[0] // self.width)
        bucket = self._days.get(day)
        if bucket is None:
            self._days[day] = bucket = []
            heapq.heappush(self._day_heap, day)
        heapq.heappush(bucket, item)
        self._len += 1

    def pop(self):
        day = self._day_heap[0]  # IndexError on empty, like heappop
        bucket = self._days[day]
        item = heapq.heappop(bucket)
        self._len -= 1
        if not bucket:
            del self._days[day]
            heapq.heappop(self._day_heap)
        return item


class EventLoop:
    """The shared event queue.  ``network`` (a Backbone) interprets
    ``Transfer``; ``engine`` picks the queue discipline ("calendar", the
    default, or the reference "heap") — both pop the exact same
    ``(time, seq)`` order, so the choice never changes a digest."""

    def __init__(self, network=None, *, trace: bool = False,
                 engine: str | None = None, sanitize: bool | None = None):
        self.now = 0.0
        self.network = network
        self.engine = engine or DEFAULT_ENGINE
        if self.engine == "calendar":
            self._q: CalendarQueue | _BinaryHeap = CalendarQueue()
        elif self.engine == "heap":
            self._q = _BinaryHeap()
        else:
            raise ValueError(f"engine must be calendar|heap, got {self.engine!r}")
        # simsan (the opt-in runtime sanitizer; SHELBY_SIMSAN=1 arms it for
        # every loop) is not part of this package yet: refuse, never ignore
        if sanitize is None:
            sanitize = bool(os.environ.get("SHELBY_SIMSAN"))
        self.sanitize = sanitize
        if sanitize:
            raise NotImplementedError(
                "the event-loop sanitizer (simsan) is not ported yet; unset "
                "SHELBY_SIMSAN / pass sanitize=False"
            )
        self._seq = itertools.count()
        self._resources: dict[Any, Resource] = {}
        self._tasks: list[TaskHandle] = []
        self._failures: list[TaskHandle] = []
        # engine telemetry: events popped + wall-clock spent draining, the
        # basis of ReplayResult.engine_events_per_sec
        self.events_processed = 0
        self.wall_s = 0.0
        # optional (t_ms, task label, step kind) record — the audit trail the
        # interleaving tests assert on
        self.trace: list[tuple[float, str, str]] | None = [] if trace else None

    @property
    def events_per_sec(self) -> float:
        """Engine throughput of this loop's drains (0 before any run)."""
        return self.events_processed / self.wall_s if self.wall_s > 0 else 0.0

    # -- resources -----------------------------------------------------------------
    def resource(self, key: Any, capacity: int = 1) -> Resource:
        res = self._resources.get(key)
        if res is None:
            res = Resource(key, capacity)
            self._resources[key] = res
        return res

    def _reclaim(self, h: TaskHandle) -> None:
        """Release every slot a cancelled task still holds (at ``now``)."""
        while h.held:
            key, priority, _t_acq = h.held[0]
            self._do_release(key, priority, holder=h)

    def _do_release(self, key: Any, priority: int, *,
                    holder: TaskHandle | None = None) -> None:
        """Give one slot of ``key`` back and wake the best eligible waiter
        at the current time — the shared path under a task's ``Release``
        effect and ``TaskHandle.cancel``'s slot reclaim."""
        res = self.resource(key)
        if holder is not None:
            for i, (k, p, _t) in enumerate(holder.held):
                if k == key and p == priority:
                    del holder.held[i]
                    break
        res.in_use -= 1
        held = res.in_use_by_class.get(priority, 0)
        res.in_use_by_class[priority] = max(0, held - 1)
        woken = res.pop_eligible()
        if woken is not None:
            prio, w, t0 = woken
            res.grant(prio, waited_ms=self.now - t0)
            w.held.append((res.key, prio, self.now))
            self._push(self.now, w, ("resume", None))

    # -- task lifecycle ------------------------------------------------------------
    def spawn(self, gen: Generator, at_ms: float | None = None,
              label: str | None = None) -> TaskHandle:
        """Schedule a generator task; it first steps at ``at_ms`` (default:
        the current time).  Returns a handle usable with ``Join``."""
        t = self.now if at_ms is None else at_ms
        h = TaskHandle(gen, label or f"task{len(self._tasks)}", t)
        h._loop = self
        self._tasks.append(h)
        self._push(t, h, ("resume", None))
        return h

    def _push(self, t_ms: float, handle: TaskHandle, action: tuple[str, Any]) -> None:
        self._q.push((t_ms, next(self._seq), handle, action))

    def _finish(self, h: TaskHandle, *, result: Any = None,
                error: BaseException | None = None) -> None:
        h.done = True
        h.result = result
        h.error = error
        h.finished_ms = self.now
        for j in h._joiners:
            if error is not None:
                h.error_delivered = True
                self._push(self.now, j, ("throw", error))
            else:
                self._push(self.now, j, ("resume", result))
        h._joiners.clear()
        if error is not None and not h.error_delivered:
            self._failures.append(h)

    def _step(self) -> None:
        t, seq, h, (kind, value) = self._q.pop()
        self.events_processed += 1
        self.now = t
        if h.cancelled or h.done:
            return
        if self.trace is not None:
            self.trace.append((t, h.label, kind))
        try:
            effect = h.gen.throw(value) if kind == "throw" else h.gen.send(value)
        except StopIteration as stop:
            self._finish(h, result=stop.value)
            return
        except (GeneratorExit, KeyboardInterrupt):
            # control-flow signals are never a task *result*: recording them
            # as task errors would hand teardown/interrupt to a Join'er
            # instead of the driver.  (BaseException subclasses would skip
            # the Exception clause below anyway — this clause states the
            # intent and keeps it true if the hierarchy ever shifts.)
            raise
        except Exception as err:
            self._finish(h, error=err)
            return
        self._dispatch(h, effect)

    def _dispatch(self, h: TaskHandle, effect: Any) -> None:
        if isinstance(effect, Sleep):
            self._push(self.now + max(0.0, effect.ms), h, ("resume", None))
        elif isinstance(effect, Transfer):
            if self.network is None:
                self._finish(h, error=RuntimeError(
                    f"task {h.label} yielded Transfer but the loop has no network"))
                return
            arrival = self.network.transfer(effect.src, effect.dst,
                                            effect.nbytes, self.now)
            self._push(arrival, h, ("resume", arrival))
        elif isinstance(effect, Acquire):
            res = self.resource(effect.resource, effect.capacity)
            if res.can_grant(effect.priority, effect.limit):
                res.grant(effect.priority)
                h.held.append((res.key, effect.priority, self.now))
                self._push(self.now, h, ("resume", None))
            else:
                res.enqueue(effect.priority, h, self.now, effect.limit)
        elif isinstance(effect, Release):
            self._do_release(effect.resource, effect.priority, holder=h)
            self._push(self.now, h, ("resume", None))
        elif isinstance(effect, Join):
            child = effect.handle
            if child.done:
                if child.error is not None:
                    child.error_delivered = True
                    self._push(self.now, h, ("throw", child.error))
                else:
                    self._push(self.now, h, ("resume", child.result))
            else:
                child._joiners.append(h)
        elif isinstance(effect, Recv):
            ch = effect.channel
            if ch._queue:
                self._push(self.now, h, ("resume", ch._queue.popleft()))
            else:
                ch._waiters.append(h)
        else:
            self._finish(h, error=TypeError(
                f"task {h.label} yielded unknown effect {effect!r}"))

    # -- drivers -------------------------------------------------------------------
    def run(self) -> float:
        """Drain every event; returns the final simulated time.

        Raises the first exception of any task whose error was never
        delivered to a joiner, and flags deadlocks (tasks left suspended on
        a Join/Recv/Acquire that can never fire)."""
        # wall-clock here is engine telemetry (events/sec); it never feeds
        # back into simulated behaviour
        events0, t0 = self.events_processed, time.perf_counter()  # simlint: ok SIM001 engine wall telemetry only
        try:
            while self._q:
                self._step()
        finally:
            dt = time.perf_counter() - t0  # simlint: ok SIM001 engine wall telemetry only
            self.wall_s += dt
            ENGINE_COUNTERS["wall_s"] += dt
            ENGINE_COUNTERS["events"] += self.events_processed - events0
        for h in self._failures:
            if not h.error_delivered:
                raise h.error
        stuck = [h for h in self._tasks if not h.done and not h.cancelled]
        if stuck:
            names = ", ".join(s.label for s in stuck[:8])
            raise RuntimeError(
                f"event loop drained with {len(stuck)} task(s) still "
                f"suspended (deadlock?): {names}")
        return self.now

    def run_until(self, handle: TaskHandle) -> Any:
        """Process events until ``handle`` completes; returns its result (or
        raises its error).  Later events — e.g. straggler responses the
        caller stopped caring about — stay unprocessed, exactly like a real
        client abandoning in-flight RPCs."""
        events0, t0 = self.events_processed, time.perf_counter()  # simlint: ok SIM001 engine wall telemetry only
        try:
            while not handle.done and self._q:
                self._step()
        finally:
            dt = time.perf_counter() - t0  # simlint: ok SIM001 engine wall telemetry only
            self.wall_s += dt
            ENGINE_COUNTERS["wall_s"] += dt
            ENGINE_COUNTERS["events"] += self.events_processed - events0
        if not handle.done:
            raise RuntimeError(
                f"task {handle.label} never completed: event heap drained "
                f"while it was still suspended")
        if handle.error is not None:
            handle.error_delivered = True
            raise handle.error
        return handle.result
