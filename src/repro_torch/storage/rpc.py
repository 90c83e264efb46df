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
(``RPCFleet.serve_ranges``).  Reads spanning several chunksets — even of
*different blobs* — take the **batched decode path**: chunksets with the same erasure pattern are
Clay-decoded in one wide GF call (``ClayCode.decode_batch``: the CUDA
``gf_matmul`` kernel when the layout's device is the card).  Fetched shards
are numpy on the host (SPs stand for remote machines); they are stacked and
copied to the device once per decode, the decoded chunksets stay there
(hot cache included), and bytes leave the device only when a range is
extracted for the client.

Payments are **on delivery** (§2.2/§3.2): a chunk is paid through the
RPC->SP micropayment channel only once it arrived AND verified against its
commitment — crashed, missing, or corrupt responses earn the SP nothing.
Channel settlement (`settle_sp_channels`) broadcasts the freshest refunds
and realizes each SP's serving income; client sessions paying this node
credit `serving_income` when *their* channel settles.  A small hot-cache of
decoded chunksets fronts popular content (§5.3).

Concurrent cache misses on the same chunkset collapse onto ONE fetch
through a per-node :class:`~repro_torch.net.events.SingleFlight` table
(cache-stampede dedup).

Not here yet: the JAX package's overload control (admission limits and load
shedding, cache TTL and admit-bytes); :class:`Overloaded` exists so the
replay drivers import, but nothing raises it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import commitments as cm
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
    from hard failures.  Nothing in this package raises it yet: admission
    control is not ported (the replay drivers already handle it).
    """

    def __init__(self, rpc_id: str, reason: str):
        self.rpc_id = rpc_id
        self.reason = reason
        super().__init__(f"rpc {rpc_id} overloaded ({reason})")


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
    chunkset_fetches: int = 0
    fetch_ms_total: float = 0.0  # simulated clock, not wall time
    coalesced: int = 0  # misses that piggybacked on an in-flight fetch


@dataclasses.dataclass(frozen=True, slots=True)
class ItemStats:
    """Per-(blob, chunkset) outcome of one `read_items_task` call."""

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
    ):
        self.rpc_id = rpc_id
        self.contract = contract
        self.sps = sps
        self.layout = layout
        self.price_per_chunk = price_per_chunk
        self.hedge = hedge
        self.transport = transport or DirectTransport(sps)
        self.scheduler = scheduler or HedgedScheduler(hedge=hedge)
        self.ledger = PaymentLedger()
        self._sp_deposit = sp_deposit
        for sp_id in sps:
            self.ledger.open(str(sp_id), sp_deposit)  # channels at join time (§2.3)
        self.serving_income = 0.0  # realized when client sessions settle (§3.2)
        # hot-cache: key -> (decoded chunkset as a device tensor, contract
        # placement version at decode time — a remapped chunkset invalidates
        # on its next lookup)
        self._cache: OrderedDict[tuple[int, int], tuple[torch.Tensor, int]] = OrderedDict()
        self._cache_size = cache_chunksets
        self._sf: SingleFlight | None = None  # bound to one loop at a time
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
        )
        if len(result.shards) < lay.k:
            raise ReadError(
                f"chunkset ({blob_id},{chunkset}): only {len(result.shards)}/{lay.k} valid chunks"
            )
        self.stats.chunks_used += result.used
        self.stats.hedged_wasted += result.wasted
        self.stats.hedges_launched += result.hedges
        self.stats.chunkset_fetches += 1
        self.stats.fetch_ms_total += result.latency_ms
        return result

    # -- single-flight (cache-stampede dedup) ---------------------------------------
    def _single_flight_for(self, loop: EventLoop) -> SingleFlight:
        """The node's in-flight fetch table, bound to the loop it runs on.

        Sequential sync entry points each spin a private loop; a table of
        handles from a dead loop is useless, so rebind lazily.  Concurrent
        misses only ever share one loop, which is the case dedup targets.
        """
        if self._sf is None or self._sf.loop is not loop:
            self._sf = SingleFlight(loop)
        return self._sf

    def _cache_get(self, key: tuple[int, int]) -> torch.Tensor | None:
        entry = self._cache.get(key)
        if entry is None:
            return None
        decoded, version = entry
        if version != self.contract.placement_version.get(key, 0):
            # the contract remapped this chunkset since the decode (epoch
            # reconfiguration / repair placement): the entry may front data
            # whose holders departed — drop it and re-fetch from the
            # CURRENT placement so no read is served off a stale member set
            del self._cache[key]
            return None
        self._cache.move_to_end(key)
        return decoded

    def _cache_put(self, key: tuple[int, int], decoded: torch.Tensor) -> None:
        if self._cache_size <= 0:
            return
        self._cache[key] = (decoded, self.contract.placement_version.get(key, 0))
        self._cache.move_to_end(key)
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)

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
        pattern still stack into one wide GF matmul, so a `get_many`
        spanning requests amortizes kernel dispatch across all of them.

        Misses go through the node's *single-flight* table — a miss on a
        chunkset another in-flight request is already fetching Joins that
        fetch instead of duplicating it (cache-stampede collapse; the
        waiter's ItemStats is marked ``coalesced``).
        """
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
            cached = self._cache_get(key)
            if cached is not None:
                self.stats.cache_hits += 1
                out[key] = cached
                stats[key] = ItemStats(cache_hit=True, latency_ms=0.0)
            else:
                misses.append(key)
        t0 = loop.now
        for key in misses:
            lbl = f"{label}/cs{key}"
            h, leader = sf.flight(
                key,
                lambda key=key, lbl=lbl: self._fetch_chunkset_task(loop, *key, label=lbl),
                label=lbl,
            )
            if not leader:
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
            decoded = self.layout.code.reconstruct_data_batch(
                [fetched[key].shards for key in order]
            )
            for key, dec in zip(order, decoded):
                out[key] = dec
                self._cache_put(key, dec)
        return out, stats
