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
blow THIS fetch's deadline.  It never peeks at a completion time before the
simulated clock reaches it, and everything is deterministic.
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
    ):
        """Generator task; spawn it on the shared loop (its legs and hedge
        timer live on the same heap as every other request's)."""
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
                launched = 0
                while launched < self.hedge and queue:
                    launch()
                    launched += 1
                res.hedges += launched
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
