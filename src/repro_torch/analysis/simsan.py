"""simsan — runtime sanitizer for the deterministic event loop.

Static rules (``simlint``) catch *constructs*; this module catches
*behaviour* the rules can't see, TSan-style, by instrumenting the engine
when a loop is built with ``EventLoop(sanitize=True)`` (or globally via
``SHELBY_SIMSAN=1``):

* **pop-order audit** — every pop must be ``(time, seq)``-monotone:
  non-decreasing time, strictly ascending seq within a timestamp, finite
  times only, and pushes must never target the past.  Any violation
  means the queue discipline fell back to an unstable ordering — exactly
  the bug class the calendar/heap equivalence guarantee forbids.
* **resource-slot accounting** — a ``Release`` that would drive a
  resource's ``in_use`` negative (or a class's count negative) raises at
  the releasing step; at full drain (``run()``), any resource with slots
  still held raises, naming the holder tasks and their acquire times.
  ``run_until`` deliberately abandons stragglers, so the drain check
  only runs on ``run()``.
* **off-loop mutation** — sanitized loops build ``GuardedResource``s
  whose scalar accounting fields reject writes outside an engine
  operation (naming the mutating task and sim-time); dict-valued fields
  are shadow-snapshotted and re-checked at every engine touch and at
  drain, naming the window in which the out-of-band write happened.
* **payment conservation** — :func:`check_payment_conservation` replays
  the SDK's settlement invariant (per-node receipts vs. channel debits)
  mid-run, so ``repro_torch.core.simulation.run_sim`` can assert it per epoch
  instead of only at ``close()``.

Violations raise :class:`SanitizerError` — an ``AssertionError``
subclass, so a sanitized CI smoke fails loudly — with the task label,
sim-time, and resource key in the message.  Zero overhead when off: the
engine's hooks are all behind ``if self._san is not None``.
"""
from __future__ import annotations

import math
import sys
from typing import TYPE_CHECKING, Any

from repro_torch.net.events import Resource

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.net.events import EventLoop, TaskHandle


class SanitizerError(AssertionError):
    """A simulation-safety invariant was violated (simsan)."""


class GuardedResource(Resource):
    """A :class:`Resource` whose scalar accounting fields only accept
    writes while the engine has an operation open — any other write is an
    off-loop mutation and raises immediately, naming the task whose step
    is executing."""

    __slots__ = ("_san",)

    #: scalar fields the engine owns; dict fields (``in_use_by_class`` …)
    #: can't be guarded by ``__setattr__`` and are shadow-checked instead.
    _PROTECTED = frozenset({
        "in_use", "capacity", "acquired", "wait_ms_total", "max_queue",
    })

    def __init__(self, key: Any, capacity: int, san: "Sanitizer"):
        object.__setattr__(self, "_san", None)  # disarm during base init
        super().__init__(key, capacity)
        object.__setattr__(self, "_san", san)

    def __setattr__(self, name: str, value: Any) -> None:
        san = getattr(self, "_san", None)
        if san is not None and name in self._PROTECTED and not san.in_engine_op:
            san.off_loop_scalar_write(self, name)
        object.__setattr__(self, name, value)


class _EngineOp:
    """Context manager flipping the sanitizer's engine-op flag (so
    GuardedResource accepts the engine's own accounting writes)."""

    __slots__ = ("san",)

    def __init__(self, san: "Sanitizer"):
        self.san = san

    def __enter__(self):
        self.san.in_engine_op = True
        return self

    def __exit__(self, *exc):
        self.san.in_engine_op = False
        return False


class Sanitizer:
    """Per-loop runtime checker; the engine calls the ``on_*`` hooks."""

    def __init__(self, loop: "EventLoop"):
        self.loop = loop
        self.in_engine_op = False
        self._last_t = -math.inf
        self._last_seq = -1
        # resource key -> (in_use_by_class copy, last engine-op t, label)
        self._shadow: dict[Any, tuple[dict[int, int], float, str]] = {}
        self.pops_audited = 0

    # -- plumbing --------------------------------------------------------------
    def violation(self, msg: str) -> None:
        raise SanitizerError(f"simsan: {msg}")

    def engine_op(self) -> _EngineOp:
        return _EngineOp(self)

    @staticmethod
    def _task_name(handle: "TaskHandle | None") -> str:
        return handle.label if handle is not None else "<off-task>"

    # -- pop-order / causality audit -------------------------------------------
    def on_push(self, t_ms: float, handle: "TaskHandle") -> None:
        if not math.isfinite(t_ms):
            self.violation(
                f"task {handle.label!r} scheduled at non-finite time "
                f"{t_ms!r} (now={self.loop.now})")
        if t_ms < self.loop.now:
            self.violation(
                f"causality: task {handle.label!r} scheduled at t={t_ms} "
                f"which is before now={self.loop.now}")

    def on_pop(self, t_ms: float, seq: int) -> None:
        self.pops_audited += 1
        if t_ms < self._last_t:
            self.violation(
                f"pop order went backwards in time: t={t_ms} after "
                f"t={self._last_t} (engine={self.loop.engine!r})")
        if t_ms == self._last_t and seq <= self._last_seq:
            self.violation(
                f"ambiguous same-timestamp pop order at t={t_ms}: seq {seq} "
                f"popped after seq {self._last_seq} — the (time, seq) total "
                "order broke (unstable tie-break in the queue discipline)")
        self._last_t, self._last_seq = t_ms, seq

    # -- resource accounting ---------------------------------------------------
    def on_release(self, res: Resource, priority: int,
                   handle: "TaskHandle | None") -> None:
        """Validate a release *before* the engine decrements."""
        if res.in_use <= 0:
            self.violation(
                f"release without acquire: task {self._task_name(handle)!r} "
                f"released resource {res.key!r} at t={self.loop.now} with "
                f"in_use={res.in_use}")
        if res.in_use_by_class.get(priority, 0) <= 0:
            self.violation(
                f"class-mismatched release: task {self._task_name(handle)!r} "
                f"released resource {res.key!r} class {priority} at "
                f"t={self.loop.now}, but that class holds no slots "
                f"(in_use_by_class={dict(res.in_use_by_class)})")

    def on_touch(self, res: Resource, handle: "TaskHandle | None") -> None:
        """Engine is about to operate on ``res``: verify its dict-valued
        accounting still matches the shadow from the last engine op."""
        snap = self._shadow.get(res.key)
        if snap is not None and snap[0] != res.in_use_by_class:
            self.violation(
                f"off-loop mutation of resource {res.key!r}: "
                f"in_use_by_class changed from {snap[0]} to "
                f"{dict(res.in_use_by_class)} outside the engine, between "
                f"t={snap[1]} (last engine op, task {snap[2]!r}) and "
                f"t={self.loop.now} (task {self._task_name(handle)!r})")

    def record(self, res: Resource, handle: "TaskHandle | None") -> None:
        """Engine finished operating on ``res``: refresh its shadow."""
        self._shadow[res.key] = (
            dict(res.in_use_by_class), self.loop.now, self._task_name(handle))

    def off_loop_scalar_write(self, res: Resource, field: str) -> None:
        cur = getattr(self.loop, "_current", None)
        self.violation(
            f"off-loop mutation: Resource({res.key!r}).{field} written "
            f"directly at t={self.loop.now} by task "
            f"{self._task_name(cur)!r} — resource accounting may only "
            "change through Acquire/Release effects")

    # -- drain-time checks -----------------------------------------------------
    def on_drain(self) -> None:
        """After ``run()`` fully drains: no slot may still be held."""
        for key in sorted(self._shadow, key=repr):
            res = self.loop._resources.get(key)
            if res is not None:
                self.on_touch(res, None)
        leaks = []
        for key in sorted(self.loop._resources, key=repr):
            res = self.loop._resources[key]
            if res.in_use != 0:
                holders = [
                    f"{h.label!r} (acquired t={t_acq}, class {prio})"
                    for h in self.loop._tasks
                    for k, prio, t_acq in h.held
                    if k == key
                ]
                leaks.append(
                    f"resource {key!r}: in_use={res.in_use} "
                    f"(by class {dict(res.in_use_by_class)}) at drain "
                    f"t={self.loop.now}; held by "
                    f"{', '.join(holders) or '<no live holder recorded>'}")
        if leaks:
            self.violation(
                "resource slot leak(s) at loop drain — every Acquire must "
                "be matched by a Release (try/finally), even on the error "
                "path:\n  " + "\n  ".join(leaks))


# -- payment conservation (per-epoch settlement invariant) -----------------------
def check_payment_conservation(session: Any, *, where: str = "") -> None:
    """Assert, mid-session, that every channel debit is backed by receipts.

    This is the same invariant ``ShelbySession.close()`` enforces at
    settlement — per serving node, the sum of receipt payments (read
    receipts, DAS sample receipts, and batched background receipts) must
    equal the channel's ``paid`` within float tolerance — hoisted out so
    ``run_sim`` can assert it at every epoch boundary under simsan.  A
    mismatch means value was created or destroyed between a read and its
    receipt: the exact bug class the paper's payment protocol (§ payments)
    exists to rule out."""
    expected: dict[Any, float] = {}
    for r in getattr(session, "receipts", []):
        for rpc_id, amount in getattr(r, "payments", {}).items():
            expected[rpc_id] = expected.get(rpc_id, 0.0) + amount
    for rb in getattr(session, "receipt_batches", []):
        for rpc_id, amount in getattr(rb, "paid_by_node", {}).items():
            expected[rpc_id] = expected.get(rpc_id, 0.0) + amount

    channels = getattr(session, "channels", {})
    label = f" ({where})" if where else ""
    for rpc_id in sorted(set(expected) | set(channels)):
        ch = channels.get(rpc_id)
        if ch is None:
            raise SanitizerError(
                f"simsan: payment conservation{label}: receipts pay node "
                f"{rpc_id!r} {expected[rpc_id]:.6g} but the session has no "
                "channel to it")
        want = expected.get(rpc_id, 0.0)
        # same tolerance shape as ShelbySession.close(): absolute floor for
        # tiny flows, relative to the deposit for large ones
        tol = max(1e-9, 128 * sys.float_info.epsilon * ch.deposit)
        if abs(ch.paid - want) > tol:
            raise SanitizerError(
                f"simsan: payment conservation{label}: node {rpc_id!r} "
                f"channel debited {ch.paid:.9g} but receipts account for "
                f"{want:.9g} (|diff|={abs(ch.paid - want):.3g} > tol "
                f"{tol:.3g}) — a payment bypassed the receipt path")
