"""Client SDK (§2.2): prepare data, write blobs, fleet-first paid reads.

Writing (Figure 2): partition the blob into ~10 MiB chunksets (zero-padding
the last), Clay-encode each into n chunks, Merkle-commit every chunk, roll
chunk roots into chunkset roots and a blob root, submit commitments +
payment to the contract (placement comes back), then hand the encoded
chunks to an RPC node to disperse and mark READY.

Reading is **fleet-first** and session-scoped: a :class:`ShelbyClient`
fronts an entire :class:`~repro_torch.net.fleet.RPCFleet` (a single ``RPCNode``
becomes a fleet of one), and a :class:`ShelbySession` lazily opens one
client->RPC micropayment channel *per serving node* (§2.2/§3.2).  Payments
are made **on delivery**: a failed read never debits a channel.  Every read
returns a :class:`ReadReceipt` — the bytes plus the simulated latency,
the per-node payments, and cache/hedge statistics — and ``close()`` (or
leaving the ``with`` block) settles every channel by broadcasting the
freshest refunds, verifying conservation (client refunds + per-node server
income == deposits) and cascading RPC->SP channel settlement so storage
providers realize their serving income.

Streaming primitives: ``client.open(blob_id)`` returns a seekable
file-like :class:`BlobReader`; ``client.stream(blob_id, chunk_size)``
yields successive receipts; ``client.get_many([...])`` routes all ranges
across the fleet in one pass so wide GF batch-decodes span requests.

``replay`` runs a workload's request list open loop on one shared event
loop, with background planes (audits, repair, churn) beside it.

Not here yet: the cohort fast-path replay of a ``RequestBatch``, DAS
``sample_availability`` and the DAS extension on ``put``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import commitments as cm
from repro_torch.core.contract import BlobMetadata, ShelbyContract
from repro_torch.core.payments import ChannelError, MicropaymentChannel
from repro_torch.net.fleet import CacheAffinityPolicy, RPCFleet
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import RPCNode


class SettlementError(Exception):
    """Conservation violated at session settlement (should never happen)."""


@dataclasses.dataclass(frozen=True)
class PreparedBlob:
    """Everything Figure 2 produces before anything touches the network."""

    size_bytes: int
    encoded_chunksets: list[np.ndarray]  # each (n, alpha, w)
    chunk_roots: dict[tuple[int, int], bytes]
    chunk_num_samples: dict[tuple[int, int], int]
    chunkset_roots: list[bytes]
    blob_root: bytes


@dataclasses.dataclass(frozen=True)
class ReadReceipt:
    """Proof-of-what-you-paid-for: one per successful read (§2.2).

    `payments` maps serving rpc_id -> the micropayment made to that node's
    channel for THIS read; cache/hedge stats cover only this read's
    chunksets.  All latencies are simulated milliseconds.  ``coalesced``
    counts chunksets that rode another in-flight request's fetch instead of
    hitting SPs again.
    """

    blob_id: int
    offset: int
    length: int
    data: bytes
    latency_ms: float
    payments: dict[str, float]
    chunksets_by_node: dict[str, int]
    cache_hits: int = 0
    hedges_launched: int = 0
    hedged_wasted: int = 0
    # readahead bookkeeping (BlobReader): this read was issued as a
    # prefetch / this read overlapped N prefetches with its own fetch
    prefetched: bool = False
    prefetches_launched: int = 0
    coalesced: int = 0  # single-flight dedup

    @property
    def total_paid(self) -> float:
        # sorted so the float sum is independent of dict insertion order
        return sum(self.payments[k] for k in sorted(self.payments))


@dataclasses.dataclass(frozen=True)
class SessionSettlement:
    """Outcome of broadcasting every channel's freshest refund (§3.2).

    `deposits`/`client_refunds`/`node_income` cover exactly THIS session's
    client->RPC channels.  `sp_income` is what the RPC->SP cascade
    realized: those channels are node-level infrastructure shared by every
    reader of the fleet, and a settlement broadcast realizes a channel's
    entire accrued balance — on a fleet with concurrent sessions it may
    include micropayments accrued by other traffic since the last cascade.
    """

    deposits: dict[str, float]  # rpc_id -> channel deposit
    client_refunds: dict[str, float]  # rpc_id -> what came back to the client
    node_income: dict[str, float]  # rpc_id -> realized serving income
    sp_income: dict[int, float]  # sp_id -> income realized by the cascade

    @property
    def total_deposited(self) -> float:
        # sorted so these float sums are independent of dict insertion order
        return sum(self.deposits[k] for k in sorted(self.deposits))

    @property
    def total_refunded(self) -> float:
        return sum(self.client_refunds[k] for k in sorted(self.client_refunds))

    @property
    def total_node_income(self) -> float:
        return sum(self.node_income[k] for k in sorted(self.node_income))


class ShelbySession:
    """A read/payment scope over the fleet: per-node channels, receipts,
    settlement.  Use as a context manager or call ``close()`` explicitly."""

    def __init__(self, client: "ShelbyClient", deposit_per_node: float):
        self._client = client
        self._fleet = client.fleet
        self._deposit = deposit_per_node
        self._price = client.read_price_per_byte
        self.channels: dict[str, MicropaymentChannel] = {}  # rpc_id -> channel
        self.receipts: list[ReadReceipt] = []
        self.settlement: SessionSettlement | None = None

    # -- channels ------------------------------------------------------------------
    def _channel(self, rpc_id: str) -> MicropaymentChannel:
        """Lazily open the client->RPC channel the first time a node serves."""
        ch = self.channels.get(rpc_id)
        if ch is None:
            ch = self.channels[rpc_id] = MicropaymentChannel(self._deposit)
        return ch

    @property
    def closed(self) -> bool:
        return self.settlement is not None

    @property
    def total_paid(self) -> float:
        # sorted so the float sum is independent of channel open order
        return sum(self.channels[k].paid for k in sorted(self.channels))

    # -- reads (pay on delivery) ---------------------------------------------------
    def _settle_check(self):
        if self.closed:
            raise ChannelError("session settled; open a new one to keep reading")

    def _receipt_for(self, sr, *, prefetched: bool = False,
                     prefetches_launched: int = 0) -> ReadReceipt:
        """Pay on delivery for one ServedRange and record its receipt: the
        bytes are in hand, split the per-byte fee across serving nodes in
        proportion to chunksets served."""
        total_cs = sum(sr.chunksets_by_node.values())  # simlint: ok SIM007 integer chunkset counts, order-exact
        payments: dict[str, float] = {}
        for rpc_id, count in sr.chunksets_by_node.items():
            amount = max(
                self._price * len(sr.data) * count / total_cs, 1e-12
            )
            self._channel(rpc_id).pay(amount)
            payments[rpc_id] = amount
        receipt = ReadReceipt(
            blob_id=sr.blob_id, offset=sr.offset, length=sr.length,
            data=sr.data, latency_ms=sr.latency_ms, payments=payments,
            chunksets_by_node=dict(sr.chunksets_by_node),
            cache_hits=sr.cache_hits, hedges_launched=sr.hedges_launched,
            hedged_wasted=sr.hedged_wasted, prefetched=prefetched,
            prefetches_launched=prefetches_launched,
            coalesced=sr.coalesced,
        )
        self.receipts.append(receipt)
        return receipt

    def _resolve(self, requests):
        contract = self._client.contract
        resolved = []
        for blob_id, offset, length in requests:
            if length is None:
                length = contract.blobs[blob_id].size_bytes - offset
            resolved.append((blob_id, offset, length))
        return resolved

    def get_many(
        self,
        requests: list[tuple[int, int, int | None]],
        *,
        client: str | None = None,
        t_ms: float = 0.0,
    ) -> list[ReadReceipt]:
        """Batched reads: (blob_id, offset, length|None) triples, all routed
        across the fleet in ONE pass — nodes batch-decode across requests."""
        self._settle_check()
        served = self._fleet.serve_ranges(
            self._resolve(requests), client=client, t_ms=t_ms
        )
        return [self._receipt_for(sr) for sr in served]

    def replay(self, requests, *, background=None, trace: bool = False,
               engine: str | None = None):
        """Open-loop replay of a workload's :class:`ReadRequest` list on ONE
        shared event loop: every request is a concurrent task spawned at its
        arrival time, so hedge timers, failure recoveries, SP disk queues
        and NIC transfers of in-flight requests genuinely interleave.
        ``background`` plane(s) (audits/repair/churn —
        ``repro_torch.storage.background``, ``storage.membership``) spawn on
        the same loop and contend with the paid traffic.

        Payments stay pay-on-delivery, applied at each request's completion
        time in deterministic event order; dropped requests debit nothing.
        Returns ``(receipts, ReplayResult)`` — ``receipts[i]`` is ``None``
        when request ``i`` was dropped by a hard failure (the port has no
        admission control yet, so no request is shed).

        A :class:`~repro_torch.net.workloads.RequestBatch` goes to the cohort
        fast path in the JAX package; that path is not ported yet, so a
        batch without ``background`` raises :class:`NotImplementedError`
        (``batch.to_requests()`` replays the same requests here).
        """
        self._settle_check()
        from repro_torch.net.workloads import RequestBatch, replay_open_loop

        if isinstance(requests, RequestBatch) and background is None:
            raise NotImplementedError(
                "the cohort fast-path replay of a RequestBatch (net/fastpath.py) "
                "is not ported yet; pass batch.to_requests()"
            )

        receipts: list[ReadReceipt | None] = [None] * len(requests)

        def on_served(i, req, sr):
            receipts[i] = self._receipt_for(sr)

        result = replay_open_loop(self._fleet, requests, on_served=on_served,
                                  background=background, trace=trace, engine=engine)
        return receipts, result

    def read(
        self,
        blob_id: int,
        offset: int = 0,
        length: int | None = None,
        *,
        client: str | None = None,
        t_ms: float = 0.0,
    ) -> ReadReceipt:
        return self.get_many(
            [(blob_id, offset, length)], client=client, t_ms=t_ms
        )[0]

    def get(self, blob_id: int, offset: int = 0, length: int | None = None) -> bytes:
        return self.read(blob_id, offset, length).data

    # -- streaming -----------------------------------------------------------------
    def open(self, blob_id: int, readahead: int = 0) -> "BlobReader":
        """`readahead=N` prefetches the next N same-sized windows as
        event-loop tasks overlapping each read's own fetch (see
        :class:`BlobReader`)."""
        self._settle_check()
        return BlobReader(self, blob_id, readahead=readahead)

    def stream(self, blob_id: int, chunk_size: int | None = None):
        """Yield :class:`ReadReceipt` per chunk, sequentially through the
        blob.  `chunk_size` defaults to one chunkset (the cache/decode
        unit, so sequential streaming never re-decodes)."""
        self._settle_check()
        size = self._client.contract.blobs[blob_id].size_bytes
        chunk_size = chunk_size or self._client.layout.chunkset_bytes
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        offset = 0
        while offset < size:
            length = min(chunk_size, size - offset)
            yield self.read(blob_id, offset, length)
            offset += length

    # -- settlement ----------------------------------------------------------------
    def close(self, *, settle_sp_channels: bool = True) -> SessionSettlement:
        """Broadcast the freshest refund of every channel and verify
        conservation; idempotent.  With `settle_sp_channels` (default) the
        settlement cascades: every fleet node also settles its RPC->SP
        channels, so SP serving income is realized on-chain.  The cascade
        realizes each RPC->SP channel's FULL accrued balance — on a shared
        fleet that can include other sessions' traffic (see
        :class:`SessionSettlement`); pass ``settle_sp_channels=False`` if
        another party owns the SP-side settlement schedule."""
        if self.settlement is not None:
            return self.settlement
        deposits, refunds, incomes = {}, {}, {}
        for rpc_id, ch in self.channels.items():
            client_gets, server_gets = ch.settle(ch.latest_refund)
            deposits[rpc_id] = ch.deposit
            refunds[rpc_id] = client_gets
            incomes[rpc_id] = server_gets
            self._fleet.node(rpc_id).serving_income += server_gets
        # conservation: deposits fully split between refunds and income …
        # (sorted sums: the check must not depend on channel-open order)
        total_dep = sum(deposits[k] for k in sorted(deposits))
        total_out = (sum(refunds[k] for k in sorted(refunds))
                     + sum(incomes[k] for k in sorted(incomes)))
        if abs(total_dep - total_out) > 1e-6 * max(total_dep, 1.0):
            raise SettlementError(
                f"conservation violated: deposits {total_dep} != "
                f"refunds+income {total_out}"
            )
        # … and income matches what the receipts say was paid
        paid_by_node: dict[str, float] = {}
        for r in self.receipts:
            for rpc_id, amt in r.payments.items():
                paid_by_node[rpc_id] = paid_by_node.get(rpc_id, 0.0) + amt
        for rpc_id, income in incomes.items():
            # tolerance tracks the deposit's float granularity: income is
            # recovered as deposit - refund, a catastrophic cancellation
            # when the deposit dwarfs what was spent
            tol = max(1e-9, 128 * np.finfo(float).eps * deposits[rpc_id])
            if abs(income - paid_by_node.get(rpc_id, 0.0)) > tol:
                raise SettlementError(
                    f"node {rpc_id}: settled income {income} != receipt "
                    f"payments {paid_by_node.get(rpc_id, 0.0)}"
                )
        sp_income: dict[int, float] = {}
        if settle_sp_channels:
            for rpc in self._fleet.rpcs:
                for sp_id, amt in rpc.settle_sp_channels().items():
                    sp_income[sp_id] = sp_income.get(sp_id, 0.0) + amt
        self.settlement = SessionSettlement(
            deposits=deposits, client_refunds=refunds, node_income=incomes,
            sp_income=sp_income,
        )
        return self.settlement

    def __enter__(self) -> "ShelbySession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BlobReader:
    """Seekable file-like view of a blob; every `read` is a paid, verified
    fleet read recorded as a receipt on the owning session.

    With ``readahead=N`` the reader prefetches the next N same-sized
    windows *in the same fleet pass* as the current read: every range in a
    ``serve_ranges`` batch is its own task on the event loop, so the
    prefetch legs overlap the current read's legs on the simulated clock
    (the current read's latency is still only its own slowest leg).
    Prefetched windows are paid on delivery like any read (their receipts
    carry ``prefetched=True``); a sequential consumer then drains them from
    the buffer without touching the fleet again.  ``prefetch_hits`` /
    ``prefetches_issued`` count the overlap on the reader; the triggering
    read's receipt records ``prefetches_launched``.
    """

    def __init__(self, session: ShelbySession, blob_id: int, readahead: int = 0):
        self._session = session
        self.blob_id = blob_id
        self.size = session._client.contract.blobs[blob_id].size_bytes
        self._pos = 0
        self._closed = False
        self._readahead = max(0, int(readahead))
        self._buffer: dict[tuple[int, int], ReadReceipt] = {}
        self.prefetches_issued = 0
        self.prefetch_hits = 0

    def readable(self) -> bool:
        return not self._closed

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence not in (0, 1, 2):
            raise ValueError(f"unsupported whence {whence}")
        base = {0: 0, 1: self._pos, 2: self.size}[whence]
        pos = base + offset
        if pos < 0:
            raise ValueError(f"negative seek position {pos}")
        self._pos = pos
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("I/O operation on closed BlobReader")
        remaining = self.size - self._pos
        if remaining <= 0:
            return b""
        length = remaining if n is None or n < 0 else min(n, remaining)
        if length == 0:
            return b""
        self._session._settle_check()  # even buffered reads need a live session
        receipt = self._buffer.pop((self._pos, length), None)
        if receipt is not None:
            self.prefetch_hits += 1
        else:
            windows = [(self._pos, length)]
            nxt = self._pos + length
            for _ in range(self._readahead):
                if nxt >= self.size:
                    break
                w = (nxt, min(length, self.size - nxt))
                if w not in self._buffer:
                    windows.append(w)
                nxt += w[1]
            served = self._session._fleet.serve_ranges(
                [(self.blob_id, off, ln) for off, ln in windows]
            )
            receipt = self._session._receipt_for(
                served[0], prefetches_launched=len(windows) - 1
            )
            for sr in served[1:]:
                self._buffer[(sr.offset, sr.length)] = self._session._receipt_for(
                    sr, prefetched=True
                )
            self.prefetches_issued += len(windows) - 1
        self._pos += len(receipt.data)
        return receipt.data

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "BlobReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShelbyClient:
    """Fleet-first client: writes disperse through the fleet's primary
    node; reads flow through a session (per-node channels, receipts,
    settlement).  A bare ``RPCNode`` is accepted and becomes a fleet of
    one, so the smallest deployment and the CDN-scale one share one API."""

    def __init__(
        self,
        contract: ShelbyContract,
        fleet: RPCFleet | RPCNode,
        layout: BlobLayout | None = None,
        read_price_per_byte: float = 1e-9,
        deposit: float = 100.0,
    ):
        self.contract = contract
        self.fleet = (
            fleet if isinstance(fleet, RPCFleet)
            else RPCFleet([fleet], CacheAffinityPolicy())
        )
        self.layout = layout or self.fleet.primary.layout
        self.read_price_per_byte = read_price_per_byte
        self.deposit_per_node = deposit
        self._session: ShelbySession | None = None

    @property
    def rpc(self) -> RPCNode:
        """The fleet's primary node (write dispersal front)."""
        return self.fleet.primary

    # -- sessions ------------------------------------------------------------------
    def session(self, deposit_per_node: float | None = None) -> ShelbySession:
        """Open a fresh read/payment session (explicit lifecycle)."""
        return ShelbySession(self, deposit_per_node or self.deposit_per_node)

    @property
    def current_session(self) -> ShelbySession:
        """The client's implicit session, opened lazily on first read."""
        if self._session is None or self._session.closed:
            self._session = self.session()
        return self._session

    def settle(self) -> SessionSettlement:
        """Settle the implicit session (no-op settlement if nothing read)."""
        settlement = self.current_session.close()
        self._session = None
        return settlement

    def __enter__(self) -> "ShelbyClient":
        return self

    def __exit__(self, *exc) -> None:
        if self._session is not None and not self._session.closed:
            self.settle()

    # -- data preparation (Figure 2) ---------------------------------------------
    def prepare(self, data: bytes) -> PreparedBlob:
        """Partition on the device, Clay-encode every chunkset at once
        (``ClayCode.encode_batch``: one wide ``gf_matmul`` per plane group),
        then copy the coded blob to the host once, where each chunk is
        Merkle-committed with hashlib and later dispersed to SPs."""
        lay = self.layout
        encoded = list(lay.code.encode_batch(lay.partition(data)).cpu().numpy())
        chunk_roots, nsamples, cs_roots = {}, {}, []
        for cs, coded in enumerate(encoded):
            roots = []
            for ck in range(lay.n):
                commit, _ = cm.commit_chunk(coded[ck])
                chunk_roots[(cs, ck)] = commit.root
                nsamples[(cs, ck)] = commit.num_samples
                roots.append(commit.root)
            cs_root, _ = cm.commit_roots(roots)
            cs_roots.append(cs_root)
        blob_root, _ = cm.commit_roots(cs_roots)
        return PreparedBlob(
            size_bytes=len(data),
            encoded_chunksets=encoded,
            chunk_roots=chunk_roots,
            chunk_num_samples=nsamples,
            chunkset_roots=cs_roots,
            blob_root=blob_root,
        )

    # -- write (§2.2) ---------------------------------------------------------------
    def put(self, data: bytes, payment: float = 1.0, epochs: int = 10) -> BlobMetadata:
        prep = self.prepare(data)
        meta = self.contract.begin_write(
            owner="client",
            size_bytes=prep.size_bytes,
            n=self.layout.n,
            k=self.layout.k,
            blob_root=prep.blob_root,
            chunkset_roots=prep.chunkset_roots,
            chunk_roots=prep.chunk_roots,
            chunk_num_samples=prep.chunk_num_samples,
            payment=payment,
            epochs=epochs,
        )
        self.fleet.primary.write_blob(meta, prep.encoded_chunksets)
        return meta

    # -- reads (§2.2): pay-on-delivery via the implicit session ---------------------
    def read(
        self,
        blob_id: int,
        offset: int = 0,
        length: int | None = None,
        *,
        client: str | None = None,
        t_ms: float = 0.0,
    ) -> ReadReceipt:
        return self.current_session.read(
            blob_id, offset, length, client=client, t_ms=t_ms
        )

    def get(self, blob_id: int, offset: int = 0, length: int | None = None) -> bytes:
        return self.read(blob_id, offset, length).data

    def get_many(
        self,
        requests: list[tuple[int, int, int | None]],
        *,
        client: str | None = None,
        t_ms: float = 0.0,
    ) -> list[ReadReceipt]:
        return self.current_session.get_many(requests, client=client, t_ms=t_ms)

    def replay(self, requests, *, background=None, trace: bool = False,
               engine: str | None = None):
        """Concurrent open-loop replay through the implicit session (see
        :meth:`ShelbySession.replay`)."""
        return self.current_session.replay(requests, background=background,
                                           trace=trace, engine=engine)

    def open(self, blob_id: int, readahead: int = 0) -> BlobReader:
        return self.current_session.open(blob_id, readahead=readahead)

    def stream(self, blob_id: int, chunk_size: int | None = None):
        return self.current_session.stream(blob_id, chunk_size)
