"""Deadline-based hedged chunk scheduler (§3.5 request hedging).

Replaces the fixed ``k + hedge`` loop that used to live in
``storage/rpc.py`` with an event-driven scheduler on the simulated clock:

1. issue the k cheapest requests (by estimated latency) at t = 0;
2. arm a *hedge deadline* — a multiple of the slowest primary's estimate;
3. on a transport failure or a verification failure, immediately re-issue
   to the next-best candidate (failure recovery, not hedging);
4. if the deadline fires before k valid responses landed, launch up to
   ``hedge`` extra requests and re-arm (straggler mitigation — the paper's
   "ignore stragglers" behaviour, with the waste made measurable).

The scheduler is a *task* on a shared :class:`~repro_torch.net.events.EventLoop`:
every in-flight leg is its own spawned task, and the deadline is a timer
task feeding the same :class:`~repro_torch.net.events.Channel`, so the hedge
decisions of concurrent fetches genuinely interleave on one global heap —
a hot SP another request is queueing on delays THIS fetch's leg, which can
blow THIS fetch's deadline.  ``fetch()`` keeps the old synchronous shape by
running ``fetch_task`` on a private loop; it never peeks at a completion
time before the simulated clock reaches it, and everything is
deterministic.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

from repro_torch.net.events import Channel, EventLoop, Recv, Sleep

_HEDGE = object()  # sentinel message the deadline timer posts


@dataclasses.dataclass(slots=True)
class FetchResult:
    """Outcome of one k-of-n hedged fetch on the simulated clock.

    ``slots=True``: a big-world replay materializes one of these per
    chunkset fetch, so the per-object footprint is kept to the fields."""

    shards: dict[int, object]  # candidate key -> payload (first k valid)
    latency_ms: float  # sim time at which the k-th valid shard landed
    issued: int = 0
    used: int = 0
    bad: int = 0  # responses failing verification (corruption, §2.3)
    failed: int = 0  # transport-level failures (crashed SP, missing chunk)
    hedges: int = 0  # requests launched by the hedge deadline timer
    hedges_suppressed: int = 0  # deadline fired but the hedge_gate said no

    @property
    def wasted(self) -> int:
        """Paid requests that did not contribute a used shard."""
        return self.issued - self.used


class HedgedScheduler:
    """Issues requests through transport-shaped task factories.

    ``fetch_task`` drives ``issue_task(key, sp_id)`` — a generator yielding
    event-loop effects (``Transfer``/``Acquire``/``Sleep``) and returning
    the payload, or ``None`` for a transport failure — plus an optional
    ``verify(key, payload) -> bool`` commitment check.
    """

    def __init__(
        self,
        hedge: int = 2,
        *,
        deadline_factor: float = 3.0,
        min_deadline_ms: float = 5.0,
    ):
        self.hedge = hedge
        self.deadline_factor = deadline_factor
        self.min_deadline_ms = min_deadline_ms

    def fetch_task(
        self,
        loop: EventLoop,
        k: int,
        candidates: list[tuple[int, int, float]],  # (key, sp_id, est_ms)
        issue_task: Callable,  # (key, sp_id) -> generator returning payload|None
        verify: Callable[[int, object], bool] | None = None,
        label: str = "fetch",
        hedge_gate: Callable[[], bool] | None = None,
    ):
        """Generator task; spawn it on the shared loop (its legs and hedge
        timer live on the same heap as every other request's).

        ``hedge_gate`` is the overload hook: consulted when the deadline
        fires, and hedges are launched only while it returns True.  Hedges
        multiply offered load exactly when the system can least afford it,
        so an overloaded node sheds its *hedges* first (counted in
        ``FetchResult.hedges_suppressed``) before shedding whole requests.
        Failure recovery is never gated — a failed primary must be
        replaced or the fetch cannot reach k shards at all.
        """
        if len(candidates) < k:
            raise ValueError(f"need >= {k} candidates, got {len(candidates)}")
        order = sorted(candidates, key=lambda c: (c[2], c[0]))
        queue = deque(order)
        res = FetchResult(shards={}, latency_ms=0.0)
        start_ms = loop.now
        chan = Channel(loop)
        outstanding = 0

        def leg(key, sp_id):
            payload = yield from issue_task(key, sp_id)
            chan.send((key, payload))

        def launch():
            nonlocal outstanding
            key, sp_id, _est = queue.popleft()
            res.issued += 1
            outstanding += 1
            loop.spawn(leg(key, sp_id), label=f"{label}/leg{key}")

        def timer(delay_ms):
            yield Sleep(delay_ms)
            chan.send((_HEDGE, None))

        primaries = order[:k]
        for _ in range(k):
            launch()
        deadline = max(
            self.min_deadline_ms, self.deadline_factor * primaries[-1][2]
        )
        timer_h = loop.spawn(timer(deadline), label=f"{label}/deadline")

        while len(res.shards) < k:
            if outstanding == 0:
                if not queue:
                    break  # exhausted: partial result, caller decides
                launch()  # defensive recovery; normally unreachable
                continue
            key, data = yield Recv(chan)
            if key is _HEDGE:
                # stragglers outstanding past the deadline: hedge + re-arm
                # (unless the overload gate says the node cannot afford it)
                launched = 0
                while launched < self.hedge and queue:
                    if hedge_gate is not None and not hedge_gate():
                        res.hedges_suppressed += 1
                        break
                    launch()
                    launched += 1
                res.hedges += launched
                # re-arm whenever candidates remain — INCLUDING when the
                # overload gate suppressed the launch: a brownout window
                # must delay hedging, not permanently disable it for this
                # fetch (the gate is consulted afresh at the next deadline)
                if queue:
                    timer_h = loop.spawn(timer(deadline), label=f"{label}/deadline")
                continue
            outstanding -= 1
            if data is None:
                res.failed += 1
                if queue:
                    launch()  # instant failure recovery
                continue
            if verify is not None and not verify(key, data):
                res.bad += 1
                if queue:
                    launch()
                continue
            res.shards[key] = data
            res.used += 1
        if timer_h is not None and not timer_h.done:
            timer_h.cancel()
        res.latency_ms = loop.now - start_ms
        return res

    def fetch(
        self,
        k: int,
        candidates: list[tuple[int, int, float]],  # (key, sp_id, est_ms)
        issue: Callable[[int, int, float], tuple[object, float]],
        verify: Callable[[int, object], bool] | None = None,
        start_ms: float = 0.0,
    ) -> FetchResult:
        """Synchronous wrapper: run ``fetch_task`` on a private loop.

        ``issue(key, sp_id, t_ms) -> (payload | None, done_ms)`` answers
        with the payload and the simulated completion time (the legacy
        transport shape); ``start_ms`` anchors the fetch on the caller's
        simulated clock.
        """
        loop = EventLoop()

        def issue_task(key, sp_id):
            payload, done_ms = issue(key, sp_id, loop.now)
            if done_ms > loop.now:
                yield Sleep(done_ms - loop.now)
            return payload

        h = loop.spawn(
            self.fetch_task(loop, k, candidates, issue_task, verify),
            at_ms=start_ms, label="fetch",
        )
        return loop.run_until(h)
