"""RPC node (§2.3): the gateway between clients and the SP layer.

Write path: verify the client's encoded chunks against the on-chain
commitments, disperse them to the contract-assigned SPs, then mark the blob
READY.

Read path ("designed to serve"): fetch any k of n chunks per chunkset with
**deadline-based request hedging** (§3.5 — issue the k best-estimated
requests, hedge extras when stragglers blow the deadline, ignore the rest),
verify every chunk against its on-chain Merkle root (altered data is
detected, §2.3), Clay-decode, and assemble.  Chunk requests travel through
a pluggable :class:`Transport` — direct in-process calls, or the simulated
dedicated backbone of ``repro_torch.net.backbone`` with per-link latency,
per-node NIC and bandwidth accounting on a simulated clock.  The whole
read path runs as generator *tasks* on a shared
:class:`~repro_torch.net.events.EventLoop`: every chunk request is its own task
(request transfer -> SP disk-slot queue -> service -> response transfer),
so concurrent requests' hedge timers, failure recoveries and SP queues
interleave on one global heap; clients reach it through the fleet
(``RPCFleet.serve_ranges``), and the synchronous entry points
(``read_items_detailed``, ``read_range``, ``read_blob`` …) spin up a
private loop per call for sequential callers.  Reads spanning several
chunksets — even of *different blobs* — take the **batched decode path**:
chunksets with the same erasure pattern are Clay-decoded in one wide GF
call (``ClayCode.decode_batch``: the CUDA ``gf_matmul`` kernel when the
layout's device is the card).  Fetched shards are numpy on the host (SPs
stand for remote machines); they are stacked and copied to the device once
per decode, the decoded chunksets stay there (hot cache included), and
bytes leave the device only when a range is extracted for the client.

Payments are **on delivery** (§2.2/§3.2): a chunk is paid through the
RPC->SP micropayment channel only once it arrived AND verified against its
commitment — crashed, missing, or corrupt responses earn the SP nothing.
Channel settlement (`settle_sp_channels`) broadcasts the freshest refunds
and realizes each SP's serving income; client sessions paying this node
credit `serving_income` when *their* channel settles.  A small hot-cache of
decoded chunksets fronts popular content (§5.3).

Overload safety: concurrent cache misses on the same chunkset collapse
onto ONE fetch through a per-node :class:`~repro_torch.net.events.SingleFlight`
table (cache-stampede dedup), and an optional :class:`AdmissionSpec` sheds
requests with a typed :class:`Overloaded` NACK — by queue depth, in-flight
fetch budget, or a brownout latency SLO — so saturation produces a rising
shed rate with bounded tails instead of unbounded queue growth.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import commitments as cm
from repro_torch.core import extend2d
from repro_torch.core.contract import BlobState, ShelbyContract
from repro_torch.core.payments import PaymentLedger
from repro_torch.net.events import (
    Acquire,
    EventLoop,
    Join,
    Release,
    safe_release,
    SingleFlight,
    Sleep,
    Transfer,
)
from repro_torch.net.scheduler import FetchResult, HedgedScheduler
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.sp import StorageProvider


# modeled RPC wire envelope: one chunk request / one failure NACK.  The
# single source of truth — the repair and audit planes import these so
# foreground and background traffic price the same envelope.
REQUEST_BYTES = 256
NACK_BYTES = 64


class ReadError(Exception):
    pass


class Overloaded(ReadError):
    """Typed load-shed outcome: the node refused this request at admission.

    Subclasses :class:`ReadError` so existing drop paths keep working, but
    carries enough structure (`rpc_id`, `reason`) for the fleet to retry on
    a sibling and for replay drivers to account a *shed rate* separately
    from hard failures.  ``reason`` is one of ``"queue"`` (admitted-request
    cap), ``"fetches"`` (in-flight SP fetch cap), ``"deadline"`` (EWMA
    fetch latency above the brownout SLO).
    """

    def __init__(self, rpc_id: str, reason: str):
        self.rpc_id = rpc_id
        self.reason = reason
        super().__init__(f"rpc {rpc_id} overloaded ({reason})")


@dataclasses.dataclass(frozen=True)
class AdmissionSpec:
    """Overload-control knobs for one RPC node.

    "Designed to serve" means degrading *gracefully* at saturation: past
    these limits a request is shed with :class:`Overloaded` (a cheap, fast
    NACK) instead of joining an unbounded queue and dragging every other
    request's tail latency with it.

    * ``max_queued_requests`` — concurrently *admitted* read requests on
      this node (a read counts from admission until its last chunkset is
      decoded); ``None`` = unlimited.
    * ``max_inflight_fetches`` — live chunkset fetch tasks this node may
      have outstanding toward SPs.  Coalesced (single-flight) waiters do
      not count: they add no SP load.  ``None`` = unlimited.
    * ``deadline_ms`` — brownout SLO: while the node's EWMA of recent
      fetch latency exceeds this AND fetches are in flight, new requests
      are shed before doing any work (observed latency is the honest
      congestion signal — it already includes SP disk queues and NIC
      serialization).  An idle node is always admitted as a probe, so the
      estimate re-measures and the brownout lifts when load drops instead
      of latching on a stale EWMA.  ``None`` = off.
    * ``ewma_alpha`` — smoothing for that latency estimate.
    """

    max_queued_requests: int | None = None
    max_inflight_fetches: int | None = None
    deadline_ms: float | None = None
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class ReadStats:
    chunks_requested: int = 0
    chunks_used: int = 0
    chunks_bad: int = 0
    bytes_paid_for: int = 0  # bytes of chunks actually paid (delivered + verified)
    payments: float = 0.0  # RPC->SP micropayments (pay-on-delivery)
    cache_hits: int = 0
    hedged_wasted: int = 0  # requests that contributed no shard (incl. failures) — unpaid
    hedges_launched: int = 0  # deadline-triggered hedge requests only
    hedges_suppressed: int = 0  # hedge deadlines the overload gate refused
    chunkset_fetches: int = 0
    fetch_ms_total: float = 0.0  # simulated clock, not wall time
    coalesced: int = 0  # misses that piggybacked on an in-flight fetch
    shed_requests: int = 0  # reads refused at admission (Overloaded)
    # DAS sampling plane (tiny proof-carrying reads, core/extend2d.py)
    samples_served: int = 0  # shares delivered + verified (paid)
    samples_withheld: int = 0  # SP went silent — the detection signal
    samples_bad: int = 0  # share failed proof verification (unpaid)
    das_cache_hits: int = 0  # samples answered from the hot cache
    sample_proof_bytes: int = 0  # proof bandwidth moved for samples


@dataclasses.dataclass(frozen=True)
class SampledShare:
    """One verified DAS sample: the share plus what moving it cost.

    ``proof_bytes`` is 0 on a cache hit (no proof crossed the wire), but
    the share is still client-payable — the node did serve it.
    """

    blob_id: int
    row: int
    col: int
    data: np.ndarray
    share_bytes: int
    proof_bytes: int
    latency_ms: float
    cache_hit: bool = False
    rpc_id: str = ""

    @property
    def nbytes(self) -> int:
        return self.share_bytes + self.proof_bytes


@dataclasses.dataclass(frozen=True, slots=True)
class ItemStats:
    """Per-(blob, chunkset) outcome of one `read_items_detailed` call."""

    cache_hit: bool
    latency_ms: float  # simulated fetch time (0 for cache hits)
    hedges: int = 0
    wasted: int = 0
    coalesced: bool = False  # joined another request's in-flight fetch


# -- transports: how chunk requests reach SPs -------------------------------------
class DirectTransport:
    """In-process calls; completion time is the SP's queued service time.

    ``request_task`` is the event-engine path: acquire one of the SP's
    disk slots (FIFO queue when the SP is hot), hold it for the service
    time, return the chunk.  No network stages.
    """

    backbone = None  # no simulated network attached

    def __init__(self, sps: dict[int, StorageProvider]):
        self.sps = sps

    def estimate_ms(self, sp_id: int, nbytes: int) -> float:
        return self.sps[sp_id].service_ms()

    def request_task(self, sp_id: int, blob_id: int, chunkset: int, chunk: int):
        sp = self.sps[sp_id]
        resp = sp.serve_chunk(blob_id, chunkset, chunk)
        if resp is None:
            # crashed / missing: a failed probe costs one service interval
            # but never occupies a disk slot
            yield Sleep(sp.service_ms())
            return None
        data, service_ms = resp
        yield Acquire(("sp", sp_id), sp.service.slots)
        try:
            yield Sleep(service_ms)
        finally:
            yield from safe_release(Release(("sp", sp_id)))
        return data

    def das_request_task(self, sp_id: int, blob_id: int, row: int, col: int):
        """One DAS share + proof off the SP's disk (no network stages)."""
        sp = self.sps[sp_id]
        resp = sp.serve_share(blob_id, row, col)
        if resp is None:
            yield Sleep(sp.service_ms())
            return None
        share, proof, service_ms = resp
        yield Acquire(("sp", sp_id), sp.service.slots)
        try:
            yield Sleep(service_ms)
        finally:
            yield from safe_release(Release(("sp", sp_id)))
        return share, proof


class BackboneTransport:
    """Chunk requests over the simulated dedicated backbone (§2.3).

    request transfer -> SP disk-slot queue -> service -> response transfer;
    failures (crashed SP / missing chunk) surface as a fast NACK after one
    round trip.  All times are simulated milliseconds, with FIFO
    serialization accounted per trunk *and* per node NIC by the Backbone,
    and per-SP concurrency accounted by the shared event loop's disk-slot
    resources.
    """

    def __init__(self, sps, backbone, rpc_node: str,
                 sp_node: dict[int, str] | None = None):
        self.sps = sps
        self.backbone = backbone
        self.rpc_node = rpc_node
        self.sp_node = sp_node or {i: f"sp{i}" for i in sps}

    def estimate_ms(self, sp_id: int, nbytes: int) -> float:
        bb, sp = self.backbone, self.sp_node[sp_id]
        return (
            bb.estimate_ms(self.rpc_node, sp, REQUEST_BYTES)
            + self.sps[sp_id].service_ms()
            + bb.estimate_ms(sp, self.rpc_node, nbytes)
        )

    def admit_sp(self, sp_id: int, node: str | None = None) -> None:
        """A new SP joined mid-run: route its requests to `node`."""
        self.sp_node[sp_id] = node or f"sp{sp_id}"

    def request_task(self, sp_id: int, blob_id: int, chunkset: int, chunk: int):
        node = self.sp_node[sp_id]
        yield Transfer(self.rpc_node, node, REQUEST_BYTES)
        sp = self.sps[sp_id]
        resp = sp.serve_chunk(blob_id, chunkset, chunk)
        if resp is None:
            yield Transfer(node, self.rpc_node, NACK_BYTES)
            return None
        data, service_ms = resp
        yield Acquire(("sp", sp_id), sp.service.slots)
        try:
            yield Sleep(service_ms)
        finally:
            yield from safe_release(Release(("sp", sp_id)))
        yield Transfer(node, self.rpc_node, data.nbytes)
        return data

    def das_request_task(self, sp_id: int, blob_id: int, row: int, col: int):
        """One DAS share + proof over the backbone: request out, share AND
        proof bytes back — proof bandwidth rides the same NICs and trunks
        as any paid payload, so the sampling storm's overhead is real."""
        node = self.sp_node[sp_id]
        yield Transfer(self.rpc_node, node, REQUEST_BYTES)
        sp = self.sps[sp_id]
        resp = sp.serve_share(blob_id, row, col)
        if resp is None:
            yield Transfer(node, self.rpc_node, NACK_BYTES)
            return None
        share, proof, service_ms = resp
        yield Acquire(("sp", sp_id), sp.service.slots)
        try:
            yield Sleep(service_ms)
        finally:
            yield from safe_release(Release(("sp", sp_id)))
        yield Transfer(node, self.rpc_node, share.nbytes + proof.nbytes)
        return share, proof


class RPCNode:
    def __init__(
        self,
        rpc_id: str,
        contract: ShelbyContract,
        sps: dict[int, StorageProvider],
        layout: BlobLayout,
        price_per_chunk: float = 1e-6,
        hedge: int = 2,
        cache_chunksets: int = 8,
        sp_deposit: float = 10.0,
        transport=None,
        scheduler: HedgedScheduler | None = None,
        batch_decode: bool = True,
        cache_ttl_ms: float | None = None,
        cache_admit_bytes: int | None = None,
        admission: AdmissionSpec | None = None,
        single_flight: bool = True,
    ):
        self.rpc_id = rpc_id
        self.contract = contract
        self.sps = sps
        self.layout = layout
        self.price_per_chunk = price_per_chunk
        self.hedge = hedge
        self.transport = transport or DirectTransport(sps)
        self.scheduler = scheduler or HedgedScheduler(hedge=hedge)
        self.batch_decode = batch_decode
        self.ledger = PaymentLedger()
        self._sp_deposit = sp_deposit
        for sp_id in sps:
            self.ledger.open(str(sp_id), sp_deposit)  # channels at join time (§2.3)
        self.serving_income = 0.0  # realized when client sessions settle (§3.2)
        # hot-cache: key -> (decoded chunkset as a device tensor, or a DAS
        # share as a host array under ("das", blob, index); expiry on the
        # sim clock or None; contract placement version at decode time — a
        # remapped chunkset invalidates on its next lookup)
        self._cache: OrderedDict[
            tuple, tuple[torch.Tensor | np.ndarray, float | None, int]
        ] = OrderedDict()
        self._cache_size = cache_chunksets
        self.cache_ttl_ms = cache_ttl_ms
        self.cache_admit_bytes = cache_admit_bytes
        self.admission = admission
        self.single_flight = single_flight
        self._sf: SingleFlight | None = None  # bound to one loop at a time
        self._admitted = 0  # reads between admission and final decode
        self._inflight_fetches = 0  # live chunkset fetch tasks toward SPs
        self._ewma_fetch_ms: float | None = None  # congestion signal
        # fast-path instrumentation: when a dict is assigned here, every
        # _cache_put records the FIRST sim time each key became servable
        # from cache — the cohort classifier's hit/coalesce boundary
        self.cache_put_log: dict[tuple, float] | None = None
        self.stats = ReadStats()
        contract.register_rpc(rpc_id)

    # -- write path (§2.3) -------------------------------------------------------
    def write_blob(self, meta, encoded_chunksets: list[np.ndarray]) -> None:
        """encoded_chunksets[cs]: (n, alpha, w) — verify commitments, disperse."""
        lay = self.layout
        for cs, coded in enumerate(encoded_chunksets):
            assert coded.shape[0] == lay.n
            for ck in range(lay.n):
                root_expected = meta.chunk_roots[(cs, ck)]
                commit, _ = cm.commit_chunk(coded[ck])
                if commit.root != root_expected:
                    raise ValueError(f"commitment mismatch for chunk ({cs},{ck})")
                sp_id = meta.placement[(cs, ck)]
                if not self.sps[sp_id].store_chunk(meta.blob_id, cs, ck, coded[ck]):
                    raise IOError(f"SP {sp_id} refused chunk ({cs},{ck})")
        self.contract.mark_ready(meta.blob_id, self.rpc_id)

    # -- read path (§2.3 + §3.5 hedging) ------------------------------------------
    def _pay(self, sp_id: int) -> float:
        """Pay ONE delivered+verified chunk over the RPC->SP channel."""
        self.ledger.pay(str(sp_id), self.price_per_chunk)
        self.sps[sp_id].receive_payment(self.price_per_chunk)
        self.stats.payments += self.price_per_chunk
        self.stats.bytes_paid_for += self.layout.chunk_bytes
        return self.price_per_chunk

    def _pay_sample(self, sp_id: int, nbytes: int) -> float:
        """Pay one delivered+verified DAS sample, pro-rated by wire bytes
        (share + proof) against the per-chunk price."""
        amount = self.price_per_chunk * nbytes / self.layout.chunk_bytes
        self.ledger.pay(str(sp_id), amount)
        self.sps[sp_id].receive_payment(amount)
        self.stats.payments += amount
        self.stats.bytes_paid_for += nbytes
        return amount

    def settle_sp_channels(self) -> dict[int, float]:
        """Broadcast the freshest refund of every paid RPC->SP channel.

        Each SP's `settled_income` is credited with exactly what the channel
        paid out (deposit - freshest refund); fresh channels reopen with the
        original deposit so serving continues.  Returns sp_id -> income.
        """
        income: dict[int, float] = {}
        for sp_id in list(self.sps):
            ch = self.ledger.channels[str(sp_id)]
            if ch.paid <= 0.0:
                continue
            _, server_gets = ch.settle(ch.latest_refund)
            self.sps[sp_id].credit_settlement(server_gets)
            income[sp_id] = server_gets  # one channel per SP
            self.ledger.open(str(sp_id), self._sp_deposit)  # fresh channel
        return income

    def admit_sp(self, sp_id: int, sp: StorageProvider,
                 node: str | None = None) -> None:
        """A new SP joined the contract mid-run (membership plane): make it
        servable from this node — shared SP table entry, a fresh RPC->SP
        payment channel (channels open at join time, §2.3), and a transport
        route when the transport keeps one."""
        self.sps[sp_id] = sp
        if str(sp_id) not in self.ledger.channels:
            self.ledger.open(str(sp_id), self._sp_deposit)
        admit = getattr(self.transport, "admit_sp", None)
        if admit is not None:
            admit(sp_id, node)

    def _fetch_chunkset_task(
        self, loop: EventLoop, blob_id: int, chunkset: int, label: str = "fetch"
    ):
        """Hedged k-of-n shard fetch as a task on the shared loop; no decode."""
        meta = self.contract.blobs[blob_id]
        if meta.state is not BlobState.READY:
            raise ReadError(f"blob {blob_id} not ready")
        lay = self.layout
        candidates = [
            (
                ck,
                meta.placement[(chunkset, ck)],
                self.transport.estimate_ms(meta.placement[(chunkset, ck)], lay.chunk_bytes),
            )
            for ck in range(lay.n)
        ]

        def issue_task(ck: int, sp_id: int):
            self.stats.chunks_requested += 1
            data = yield from self.transport.request_task(sp_id, blob_id, chunkset, ck)
            return data

        def verify(ck: int, data) -> bool:
            commit, _ = cm.commit_chunk(data)
            if commit.root != meta.chunk_roots[(chunkset, ck)]:
                self.stats.chunks_bad += 1  # §2.3: tampering detected
                return False
            self._pay(meta.placement[(chunkset, ck)])  # pay on delivery
            return True

        result = yield from self.scheduler.fetch_task(
            loop, lay.k, candidates, issue_task, verify, label=label,
            hedge_gate=self._allow_hedge if self.admission is not None else None,
        )
        if len(result.shards) < lay.k:
            raise ReadError(
                f"chunkset ({blob_id},{chunkset}): only {len(result.shards)}/{lay.k} valid chunks"
            )
        self.stats.chunks_used += result.used
        self.stats.hedged_wasted += result.wasted
        self.stats.hedges_launched += result.hedges
        self.stats.hedges_suppressed += result.hedges_suppressed
        self.stats.chunkset_fetches += 1
        self.stats.fetch_ms_total += result.latency_ms
        alpha = self.admission.ewma_alpha if self.admission is not None else 0.2
        if self._ewma_fetch_ms is None:
            self._ewma_fetch_ms = result.latency_ms
        else:
            self._ewma_fetch_ms = (
                (1 - alpha) * self._ewma_fetch_ms + alpha * result.latency_ms
            )
        return result

    def _counted_fetch(self, loop: EventLoop, key: tuple[int, int], label: str):
        """One chunkset fetch held against the node's in-flight budget.

        The CALLER increments ``_inflight_fetches`` at spawn time — before
        this generator first steps — so simultaneously-arriving requests
        see each other's flights at admission; only the decrement lives
        here (the flight knows when it lands)."""
        try:
            result = yield from self._fetch_chunkset_task(
                loop, key[0], key[1], label=label
            )
        finally:
            self._inflight_fetches -= 1
        return result

    # -- overload control (admission + single-flight) ------------------------------
    def _allow_hedge(self) -> bool:
        """Hedges are shed first: they multiply SP load exactly when the
        node is at its budget or already missing its latency SLO."""
        spec = self.admission
        if spec is None:
            return True
        if (spec.max_inflight_fetches is not None
                and self._inflight_fetches >= spec.max_inflight_fetches):
            return False
        if (spec.deadline_ms is not None and self._ewma_fetch_ms is not None
                and self._ewma_fetch_ms > spec.deadline_ms):
            return False
        return True

    def _single_flight_for(self, loop: EventLoop) -> SingleFlight | None:
        """The node's in-flight fetch table, bound to the loop it runs on.

        Sequential sync entry points each spin a private loop; a table of
        handles from a dead loop is useless, so rebind lazily.  Concurrent
        misses only ever share one loop, which is the case dedup targets.
        """
        if not self.single_flight:
            return None
        if self._sf is None or self._sf.loop is not loop:
            self._sf = SingleFlight(loop)
        return self._sf

    def _shed(self, reason: str) -> Overloaded:
        self.stats.shed_requests += 1
        return Overloaded(self.rpc_id, reason)

    def _check_admission(self, new_flights: int | None = None) -> None:
        """Raise :class:`Overloaded` if this request must be shed.

        Called twice per read: at entry (queue depth + brownout SLO — both
        known before any work) and again with ``new_flights`` once the
        cache/coalesce pass has established how many *new* fetch tasks the
        request would add."""
        spec = self.admission
        if spec is None:
            return
        if new_flights is None:
            if (spec.max_queued_requests is not None
                    and self._admitted >= spec.max_queued_requests):
                raise self._shed("queue")
            # brownout sheds only while work is in flight: an idle node is
            # always admitted as a probe — its fetch re-measures the EWMA,
            # so a node that browned out under a burst recovers once the
            # queue drains instead of shedding forever on a stale estimate
            if (spec.deadline_ms is not None and self._ewma_fetch_ms is not None
                    and self._ewma_fetch_ms > spec.deadline_ms
                    and self._inflight_fetches > 0):
                raise self._shed("deadline")
        elif (spec.max_inflight_fetches is not None and new_flights > 0
                and self._inflight_fetches + new_flights > spec.max_inflight_fetches):
            raise self._shed("fetches")

    def _cache_get(self, key: tuple, now_ms: float) -> torch.Tensor | np.ndarray | None:
        entry = self._cache.get(key)
        if entry is None:
            return None
        decoded, expires, version = entry
        if expires is not None and now_ms >= expires:
            del self._cache[key]  # TTL lapsed on the sim clock
            return None
        if version != self.contract.placement_version.get(key, 0):
            # the contract remapped this chunkset since the decode (epoch
            # reconfiguration / repair placement): the entry may front data
            # whose holders departed — drop it and re-fetch from the
            # CURRENT placement so no read is served off a stale member set
            del self._cache[key]
            return None
        self._cache.move_to_end(key)
        return decoded

    def _cache_put(self, key: tuple, decoded: torch.Tensor | np.ndarray,
                   now_ms: float = 0.0) -> None:
        if self._cache_size <= 0:
            return
        # uint8 either way: a tensor's numel() is the ndarray's nbytes
        size = decoded.numel() if isinstance(decoded, torch.Tensor) else decoded.nbytes
        if self.cache_admit_bytes is not None and size > self.cache_admit_bytes:
            return  # admission: oversized objects would evict the whole hot set
        expires = None if self.cache_ttl_ms is None else now_ms + self.cache_ttl_ms
        version = self.contract.placement_version.get(key, 0)
        if self.cache_put_log is not None and key not in self.cache_put_log:
            self.cache_put_log[key] = now_ms
        self._cache[key] = (decoded, expires, version)
        self._cache.move_to_end(key)
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)

    def read_chunkset_timed(
        self, blob_id: int, chunkset: int, start_ms: float = 0.0
    ) -> tuple[torch.Tensor, float]:
        """Decoded (k, alpha, w) data of one chunkset (on the layout's
        device) + simulated fetch ms."""
        parts, latency = self.read_chunksets_timed(blob_id, [chunkset], start_ms)
        return parts[0], latency

    def read_chunkset(self, blob_id: int, chunkset: int) -> torch.Tensor:
        return self.read_chunkset_timed(blob_id, chunkset)[0]

    def read_items_task(
        self, loop: EventLoop, items: list[tuple[int, int]], label: str = "read"
    ):
        """Task: read many (blob_id, chunkset) items — possibly spanning
        blobs — on the shared event loop.

        Cache misses are *spawned* as independent fetch tasks (hedged
        fetches overlap -> each item's latency is its own slowest leg, and
        concurrent requests' fetches contend for the same SP disk slots and
        NICs), then decoded through the batched Clay path when more than
        one misses: chunksets of *different blobs* with the same erasure
        pattern still stack into one wide GF matmul (``gf_matmul`` on the
        card), so a `get_many` spanning requests amortizes kernel dispatch
        across all of them; with ``batch_decode=False`` each chunkset is
        decoded alone.

        Overload safety: misses go through the node's *single-flight*
        table — a miss on a chunkset another in-flight request is already
        fetching Joins that fetch instead of duplicating it (cache-stampede
        collapse; the waiter's ItemStats is marked ``coalesced``).  With an
        :class:`AdmissionSpec` attached, the request is shed with
        :class:`Overloaded` when the node is past its queue/fetch budget or
        its brownout SLO — *before* it adds load.
        """
        self._check_admission()  # queue depth + brownout SLO (may raise)
        self._admitted += 1
        try:
            result = yield from self._read_items_admitted(loop, items, label)
        finally:
            self._admitted -= 1
        return result

    def _read_items_admitted(
        self, loop: EventLoop, items: list[tuple[int, int]], label: str
    ):
        out: dict[tuple[int, int], torch.Tensor] = {}
        stats: dict[tuple[int, int], ItemStats] = {}
        fetched: dict[tuple[int, int], FetchResult] = {}
        pending: list[tuple[tuple[int, int], object, bool]] = []
        misses: list[tuple[int, int]] = []
        seen: set[tuple[int, int]] = set()
        sf = self._single_flight_for(loop)
        for key in items:
            if key in seen:
                continue
            seen.add(key)
            cached = self._cache_get(key, loop.now)
            if cached is not None:
                self.stats.cache_hits += 1
                out[key] = cached
                stats[key] = ItemStats(cache_hit=True, latency_ms=0.0)
            else:
                misses.append(key)
        # fetch-budget admission: only *new* flights add SP load — misses
        # that will coalesce onto an in-flight fetch ride along for free
        new_flights = (
            len(misses) if sf is None
            else sum(1 for key in misses if not sf.live(key))
        )
        self._check_admission(new_flights)  # may raise Overloaded
        t0 = loop.now
        for key in misses:
            if sf is None:
                h = loop.spawn(
                    self._counted_fetch(loop, key, f"{label}/cs{key}"),
                    label=f"{label}/cs{key}",
                )
                leader = True
            else:
                h, leader = sf.flight(
                    key,
                    lambda key=key: self._counted_fetch(loop, key, f"{label}/cs{key}"),
                    label=f"{label}/cs{key}",
                )
            if leader:
                # count the flight NOW (its task has not stepped yet), so
                # another request admitted later in this same event step
                # already sees it against the fetch budget
                self._inflight_fetches += 1
            else:
                self.stats.coalesced += 1
            pending.append((key, h, leader))
        first_err: Exception | None = None
        for key, h, leader in pending:
            try:
                res = yield Join(h)
            except (GeneratorExit, KeyboardInterrupt):
                # task teardown / user interrupt must never be harvested as
                # a child failure — propagate immediately
                raise
            except Exception as e:  # harvest every child before propagating
                if first_err is None:
                    first_err = e
                continue
            fetched[key] = res
            stats[key] = ItemStats(
                cache_hit=False,
                # a coalesced waiter only waited for the residual of a fetch
                # someone else started; its hedges/waste belong to the leader
                latency_ms=res.latency_ms if leader
                else max(0.0, h.finished_ms - t0),
                hedges=res.hedges if leader else 0,
                wasted=res.wasted if leader else 0,
                coalesced=not leader,
            )
        if first_err is not None:
            raise first_err
        if fetched:
            order = sorted(fetched)
            if self.batch_decode and len(order) > 1:
                decoded = self.layout.code.reconstruct_data_batch(
                    [fetched[key].shards for key in order]
                )
            else:
                decoded = [
                    self.layout.code.reconstruct_data(fetched[key].shards)
                    for key in order
                ]
            for key, dec in zip(order, decoded):
                out[key] = dec
                self._cache_put(key, dec, loop.now)
        return out, stats

    # -- DAS sampling path (tiny proof-carrying reads, core/extend2d.py) ----------
    def sample_share_task(
        self, loop: EventLoop, blob_id: int, row: int, col: int, *,
        cache_bypass: bool = True, label: str = "das",
    ):
        """Task: fetch + verify ONE DAS share through this node.

        Shares have exactly one contract-assigned holder, so there is no
        hedging and no k-of-n recovery — a silent SP *is* the signal the
        sampler exists to detect, surfaced as :class:`ReadError` (unpaid).
        Samples pass the same admission gate as reads (the storm must not
        bypass overload control), but default to ``cache_bypass=True``:
        single-use random coordinates would churn the entry-bounded hot
        cache out from under streaming readers (see the `das` bench).
        """
        self._check_admission()  # may raise Overloaded
        self._admitted += 1
        try:
            result = yield from self._sample_admitted(
                loop, blob_id, row, col, cache_bypass
            )
        finally:
            self._admitted -= 1
        return result

    def _sample_admitted(
        self, loop: EventLoop, blob_id: int, row: int, col: int, cache_bypass: bool
    ):
        rec = self.contract.das.get(blob_id)
        if rec is None:
            raise ReadError(f"blob {blob_id} has no DAS extension")
        key = ("das", blob_id, row * rec.side + col)
        cached = self._cache_get(key, loop.now)
        if cached is not None:
            self.stats.das_cache_hits += 1
            self.stats.samples_served += 1
            return SampledShare(
                blob_id=blob_id, row=row, col=col, data=cached,
                share_bytes=rec.share_bytes, proof_bytes=0, latency_ms=0.0,
                cache_hit=True, rpc_id=self.rpc_id,
            )
        sp_id = rec.placement[(row, col)]
        t0 = loop.now
        resp = yield from self.transport.das_request_task(sp_id, blob_id, row, col)
        latency_ms = loop.now - t0
        if resp is None:
            self.stats.samples_withheld += 1
            raise ReadError(f"share ({blob_id},{row},{col}) withheld by SP {sp_id}")
        share, proof = resp
        if not extend2d.verify_share(rec.das_root, rec.side, share.tobytes(), proof):
            self.stats.samples_bad += 1  # tampering detected — unpaid
            raise ReadError(f"share ({blob_id},{row},{col}) failed verification")
        self._pay_sample(sp_id, share.nbytes + proof.nbytes)  # pay on delivery
        self.stats.samples_served += 1
        self.stats.sample_proof_bytes += proof.nbytes
        if not cache_bypass:
            self._cache_put(key, share, loop.now)
        return SampledShare(
            blob_id=blob_id, row=row, col=col, data=share,
            share_bytes=share.nbytes, proof_bytes=proof.nbytes,
            latency_ms=latency_ms, rpc_id=self.rpc_id,
        )

    def read_items_detailed(
        self, items: list[tuple[int, int]], start_ms: float = 0.0
    ) -> tuple[dict[tuple[int, int], torch.Tensor], dict[tuple[int, int], ItemStats]]:
        """Synchronous wrapper over :meth:`read_items_task` — runs the read
        on a private event loop anchored at ``start_ms``.  Trunk/NIC
        reservations persist in the shared Backbone, so sequential callers
        still queue against earlier traffic."""
        loop = EventLoop(network=getattr(self.transport, "backbone", None))
        h = loop.spawn(
            self.read_items_task(loop, items), at_ms=start_ms, label="read_items"
        )
        return loop.run_until(h)

    def read_chunksets_timed(
        self, blob_id: int, chunksets: list[int], start_ms: float = 0.0
    ) -> tuple[list[torch.Tensor], float]:
        """Single-blob convenience over `read_items_detailed`; the returned
        latency is the slowest item's leg (hedged fetches overlap)."""
        out, stats = self.read_items_detailed(
            [(blob_id, cs) for cs in chunksets], start_ms
        )
        latency = max((s.latency_ms for s in stats.values()), default=0.0)
        return [out[(blob_id, cs)] for cs in chunksets], latency

    def read_range_timed(
        self, blob_id: int, offset: int, length: int, start_ms: float = 0.0
    ) -> tuple[bytes, float]:
        meta = self.contract.blobs[blob_id]
        lay = self.layout
        first, last = lay.byte_range_to_chunksets(offset, length)
        parts, latency = self.read_chunksets_timed(
            blob_id, list(range(first, last + 1)), start_ms
        )
        return lay.extract_range(parts, first, offset, length, meta.size_bytes), latency

    def read_range(self, blob_id: int, offset: int, length: int) -> bytes:
        return self.read_range_timed(blob_id, offset, length)[0]

    def read_blob(self, blob_id: int) -> bytes:
        meta = self.contract.blobs[blob_id]
        return self.read_range(blob_id, 0, meta.size_bytes)
