"""Deterministic workload scenario generators + arrival-process drivers.

Each generator yields a list of :class:`ReadRequest` — (sim time, client
node, blob, byte range) — modelling one of the paper's target workloads
(§1: "video streaming, AI training, analytics"):

* ``video_streaming`` — sequential segment reads paced at the bitrate;
* ``training_epoch``  — every sample of a dataset, reshuffled per epoch;
* ``analytics_scan``  — large sequential scans over whole blobs;
* ``zipf_hotset``     — Zipf-popular random-access traffic (the CDN case
  where hot-cache policy dominates), with fixed or Poisson interarrivals.

Generators are pure functions of their seed, so two runs of a benchmark
replay byte-for-byte identical traffic.

The *drivers* push those requests through the shared event engine:

* ``replay_open_loop``   — one task per request, spawned at its arrival
  time regardless of whether earlier requests finished (the §2.3 serving
  regime: load does not back off when the fleet slows down);
* ``replay_closed_loop`` — one task per client, each issuing its next
  request only after the previous one completed plus a think time.

Both return a :class:`ReplayResult` whose ``digest()`` hashes every
per-request timing and the backbone's per-link byte counters — the
determinism gate CI asserts on (two identical runs -> identical digests).
Both also accept ``background=`` plane(s) (``repro_torch.storage.background``):
audit and repair tasks spawned on the SAME loop, so background traffic
contends with the replay and its per-op timings join the digest
(:class:`BackgroundRecord`, in ``ReplayResult.background``).
Requests the fleet refuses at admission (typed ``Overloaded`` NACKs) are
recorded as *shed*, separately from hard failures; ``sweep_open_loop``
ramps the offered rate and returns the goodput / shed-rate / p99 series
that make the saturation knee measurable.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.net.events import EventLoop, Sleep


@dataclasses.dataclass(frozen=True, slots=True)
class ReadRequest:
    t_ms: float
    client: str  # backbone node id (or bare label when no backbone attached)
    blob_id: int
    offset: int
    length: int


@dataclasses.dataclass(frozen=True, slots=True)
class SampleRequest:
    """One DAS sample: a tiny proof-carrying read of share (row, col).

    ``cache_bypass`` is the cache-steering hint threaded workload ->
    fleet -> RPCNode: sample storms are cache-hostile (uniform random
    single-use coordinates), so by default they skip hot-cache insertion
    rather than churn streaming readers' entries out.
    """

    t_ms: float
    client: str
    blob_id: int
    row: int
    col: int
    cache_bypass: bool = True


@dataclasses.dataclass
class RequestBatch:
    """Struct-of-arrays block of read requests — the million-request form.

    One frozen :class:`ReadRequest` per request costs hundreds of bytes of
    Python object; a 1M-request storm held that way is ~0.5 GB of boxed
    floats before the engine even starts.  A batch keeps the five columns
    as numpy arrays (client names interned once in ``clients``), which is
    what the cohort fast path (``repro_torch.net.fastpath``) consumes directly —
    ``to_requests()`` materializes the identical request list for the
    task-per-request drivers, so the same batch replays on either path.
    """

    t_ms: np.ndarray  # float64 arrival times
    client_idx: np.ndarray  # index into ``clients``
    blob_id: np.ndarray  # int64
    offset: np.ndarray  # int64
    length: np.ndarray  # int64
    clients: list[str]

    def __len__(self) -> int:
        return int(self.t_ms.size)

    def request(self, i: int) -> ReadRequest:
        return ReadRequest(
            float(self.t_ms[i]), self.clients[int(self.client_idx[i])],
            int(self.blob_id[i]), int(self.offset[i]), int(self.length[i]),
        )

    def to_requests(self) -> list[ReadRequest]:
        """Materialize the equivalent per-request list (task-mode replay)."""
        names = self.clients
        return [
            ReadRequest(t, names[c], b, off, ln)
            for t, c, b, off, ln in zip(
                self.t_ms.tolist(), self.client_idx.tolist(),
                self.blob_id.tolist(), self.offset.tolist(),
                self.length.tolist(),
            )
        ]


def zipf_hotset_batch(
    metas,
    *,
    clients: list[str],
    num_requests: int = 200,
    exponent: float = 1.1,
    read_bytes: int = 64 * 1024,
    interarrival_ms: float = 0.4,
    seed: int = 0,
    arrival: str = "fixed",
) -> RequestBatch:
    """Vectorized Zipf storm: every column drawn as ONE numpy array.

    Same workload *shape* as :func:`zipf_hotset` (Zipf-ranked blobs behind
    a seeded rank permutation, uniform in-blob offsets, uniform clients,
    fixed or Poisson gaps) but each column is a single vectorized draw, so
    generating 1M requests costs milliseconds, not seconds.  The draw
    *order* differs from the scalar generator's interleaved stream, so the
    two are distinct seeded workloads — existing benches keep their exact
    request sequences, big-world ramps use this.
    """
    if arrival not in ("fixed", "poisson"):
        raise ValueError(f"arrival must be fixed|poisson, got {arrival!r}")
    n = num_requests
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(metas) + 1, dtype=np.float64)
    popularity = ranks**-exponent
    popularity /= popularity.sum()
    blob_order = rng.permutation(len(metas))  # which blob holds which rank
    sizes = np.array([m.size_bytes for m in metas], dtype=np.int64)
    blob_ids = np.array([m.blob_id for m in metas], dtype=np.int64)
    picks = blob_order[rng.choice(len(metas), size=n, p=popularity)]
    sz = sizes[picks]
    length = np.minimum(read_bytes, sz)
    offset = (rng.random(n) * (sz - length + 1)).astype(np.int64)
    client_idx = rng.integers(0, len(clients), size=n)
    if arrival == "poisson":
        gaps = rng.exponential(interarrival_ms, size=n)
        gaps[0] = 0.0
        t = np.cumsum(gaps)
    else:
        t = np.arange(n, dtype=np.float64) * interarrival_ms
    return RequestBatch(
        t_ms=t, client_idx=client_idx, blob_id=blob_ids[picks],
        offset=offset, length=length, clients=list(clients),
    )


def das_storm_batch(
    das_records,
    *,
    clients: list[str],
    num_requests: int = 200,
    interarrival_ms: float = 0.3,
    seed: int = 0,
    arrival: str = "poisson",
    cache_bypass: bool = True,
) -> list[SampleRequest]:
    """Vectorized DAS storm: blobs, (row, col) coordinates, clients and
    gaps drawn as whole numpy arrays up front (cf. :func:`das_storm`, whose
    per-request scalar draws pin the existing bench sequences)."""
    if arrival not in ("fixed", "poisson"):
        raise ValueError(f"arrival must be fixed|poisson, got {arrival!r}")
    recs = list(das_records)
    n = num_requests
    rng = np.random.default_rng(seed)
    ri = rng.integers(0, len(recs), size=n)
    sides = np.array([r.side for r in recs], dtype=np.int64)[ri]
    rows = (rng.random(n) * sides).astype(np.int64)
    cols = (rng.random(n) * sides).astype(np.int64)
    ci = rng.integers(0, len(clients), size=n)
    if arrival == "poisson":
        gaps = rng.exponential(interarrival_ms, size=n)
        gaps[0] = 0.0
        t = np.cumsum(gaps)
    else:
        t = np.arange(n, dtype=np.float64) * interarrival_ms
    blob_ids = np.array([r.blob_id for r in recs], dtype=np.int64)[ri]
    return [
        SampleRequest(tt, clients[c], b, r, cc, cache_bypass=cache_bypass)
        for tt, c, b, r, cc in zip(
            t.tolist(), ci.tolist(), blob_ids.tolist(),
            rows.tolist(), cols.tolist(),
        )
    ]


def video_streaming(
    meta,
    *,
    client: str,
    segment_bytes: int = 128 * 1024,
    bitrate_mbps: float = 25.0,
    start_ms: float = 0.0,
) -> list[ReadRequest]:
    """Sequential range reads of one blob, paced at the playback bitrate."""
    out, t = [], start_ms
    pace_ms = segment_bytes * 8e-3 / bitrate_mbps
    for off in range(0, meta.size_bytes, segment_bytes):
        out.append(
            ReadRequest(t, client, meta.blob_id, off, min(segment_bytes, meta.size_bytes - off))
        )
        t += pace_ms
    return out


def training_epoch(
    metas,
    *,
    client: str,
    sample_bytes: int = 64 * 1024,
    epochs: int = 1,
    interarrival_ms: float = 1.0,
    seed: int = 0,
) -> list[ReadRequest]:
    """Shuffled reads of every fixed-size sample record, per epoch."""
    rng = np.random.default_rng(seed)
    samples = [
        (m.blob_id, off, min(sample_bytes, m.size_bytes - off))
        for m in metas
        for off in range(0, m.size_bytes, sample_bytes)
    ]
    out, t = [], 0.0
    for _ in range(epochs):
        order = rng.permutation(len(samples))
        for i in order:
            blob_id, off, ln = samples[i]
            out.append(ReadRequest(t, client, blob_id, off, ln))
            t += interarrival_ms
    return out


def analytics_scan(
    metas,
    *,
    client: str,
    scan_bytes: int = 512 * 1024,
    interarrival_ms: float = 0.5,
) -> list[ReadRequest]:
    """Full sequential scans of every blob in large strides."""
    out, t = [], 0.0
    for m in metas:
        for off in range(0, m.size_bytes, scan_bytes):
            out.append(
                ReadRequest(t, client, m.blob_id, off, min(scan_bytes, m.size_bytes - off))
            )
            t += interarrival_ms
    return out


def zipf_hotset(
    metas,
    *,
    clients: list[str],
    num_requests: int = 200,
    exponent: float = 1.1,
    read_bytes: int = 64 * 1024,
    interarrival_ms: float = 0.4,
    seed: int = 0,
    arrival: str = "fixed",
) -> list[ReadRequest]:
    """Zipf-popular random reads: a few blobs soak up most of the traffic.

    ``arrival="fixed"`` paces requests exactly ``interarrival_ms`` apart;
    ``"poisson"`` draws exponential gaps with that mean — the open-loop
    storm shape IPFS measurement studies report for real dApp traffic.
    """
    if arrival not in ("fixed", "poisson"):
        raise ValueError(f"arrival must be fixed|poisson, got {arrival!r}")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(metas) + 1, dtype=np.float64)
    popularity = ranks**-exponent
    popularity /= popularity.sum()
    blob_order = rng.permutation(len(metas))  # which blob holds which rank
    out, t = [], 0.0
    for _ in range(num_requests):
        m = metas[blob_order[rng.choice(len(metas), p=popularity)]]
        ln = min(read_bytes, m.size_bytes)
        off = int(rng.integers(0, m.size_bytes - ln + 1))
        out.append(ReadRequest(t, str(rng.choice(clients)), m.blob_id, off, ln))
        if arrival == "poisson":
            t += float(rng.exponential(interarrival_ms))
        else:
            t += interarrival_ms
    return out


def das_storm(
    das_records,
    *,
    clients: list[str],
    num_requests: int = 200,
    interarrival_ms: float = 0.3,
    seed: int = 0,
    arrival: str = "poisson",
    cache_bypass: bool = True,
) -> list[SampleRequest]:
    """Open-loop storm of single-share DAS sample requests.

    ``das_records`` expose ``.blob_id`` and ``.side`` (the contract's
    :class:`~repro_torch.core.contract.DASRecord`).  Blobs, coordinates and
    issuing clients are drawn uniformly — the cache-hostile opposite of
    ``zipf_hotset`` — and the generator is a pure function of its seed,
    so the storm joins the determinism digest like any other workload.
    """
    if arrival not in ("fixed", "poisson"):
        raise ValueError(f"arrival must be fixed|poisson, got {arrival!r}")
    recs = list(das_records)
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(num_requests):
        rec = recs[int(rng.integers(0, len(recs)))]
        row = int(rng.integers(0, rec.side))
        col = int(rng.integers(0, rec.side))
        out.append(
            SampleRequest(t, str(rng.choice(clients)), rec.blob_id, row, col,
                          cache_bypass=cache_bypass)
        )
        if arrival == "poisson":
            t += float(rng.exponential(interarrival_ms))
        else:
            t += interarrival_ms
    return out


# ---------------------------------------------------------------------------
# arrival-process drivers on the shared event engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BackgroundRecord:
    """One background-plane operation (audit, repair, or a membership
    event — join/leave/crash/slash/reconfigure) on the shared clock.

    Background traffic rides the same loop, NICs, trunks and SP disk slots
    as the foreground replay, so these timings are part of the determinism
    digest: same seed ⇒ same foreground AND background schedule — including
    WHO churned and WHAT got remapped.
    """

    kind: str  # "audit" | "repair" | "member"
    key: str  # stable id, e.g. "e0/a3/b1/c0/k2"
    t_ms: float  # task start on the sim clock
    finish_ms: float
    ok: bool
    nbytes: int  # bytes the op moved over the network (0 without a backbone)

    @property
    def latency_ms(self) -> float:
        return self.finish_ms - self.t_ms


@dataclasses.dataclass(frozen=True, slots=True)
class RequestRecord:
    """One request's fate on the shared simulated clock."""

    index: int
    t_ms: float  # arrival
    finish_ms: float
    latency_ms: float
    nbytes: int
    ok: bool
    client: str
    blob_id: int
    shed: bool = False  # refused at admission (Overloaded), not a failure
    kind: str = "read"  # "read" | "das" (a single-share sample)


@dataclasses.dataclass
class RecordBatch:
    """Struct-of-arrays pool of request records (one row per request).

    The fast path's counterpart to ``list[RequestRecord]``: a 1M-request
    replay keeps nine columns instead of a million frozen dataclasses, and
    every aggregate (shed counts, goodput, percentiles, the digest rows)
    reduces over arrays.  Rows are in request-index order and cover EVERY
    request of the replay — including the ones that de-opted to real
    generator tasks, whose records are folded back in after the loop runs.
    """

    index: np.ndarray  # int64
    t_ms: np.ndarray  # float64
    finish_ms: np.ndarray
    latency_ms: np.ndarray
    nbytes: np.ndarray  # int64
    ok: np.ndarray  # bool
    shed: np.ndarray  # bool
    client_idx: np.ndarray  # index into ``clients``
    blob_id: np.ndarray  # int64
    clients: list[str]
    kind: str = "read"

    def __len__(self) -> int:
        return int(self.index.size)

    def to_records(self) -> list[RequestRecord]:
        names = self.clients
        return [
            RequestRecord(i, t, f, lat, nb, ok, names[c], b, shed, self.kind)
            for i, t, f, lat, nb, ok, c, b, shed in zip(
                self.index.tolist(), self.t_ms.tolist(),
                self.finish_ms.tolist(), self.latency_ms.tolist(),
                self.nbytes.tolist(), self.ok.tolist(),
                self.client_idx.tolist(), self.blob_id.tolist(),
                self.shed.tolist(),
            )
        ]


@dataclasses.dataclass
class ReplayResult:
    """Outcome of replaying a workload through the shared event loop.

    Task-mode drivers fill ``records``; the cohort fast path fills
    ``batch`` (one :class:`RecordBatch` row per request, de-opted task
    records folded back in) and leaves ``records`` empty.  Every aggregate
    below reads both, so callers never care which driver produced the
    result — including ``digest()``, whose per-request rows are formatted
    identically from either representation.
    """

    records: list[RequestRecord]
    span_ms: float  # first arrival -> last client-observed finish
    link_bytes: dict  # backbone trunk utilization snapshot after the run
    trace: list[tuple[float, str, str]] | None = None  # loop audit trail
    # background-plane operations (audits, repairs) that shared the loop
    background: list[BackgroundRecord] = dataclasses.field(default_factory=list)
    # pooled per-request rows from the cohort fast path (records stay empty)
    batch: RecordBatch | None = None
    # fast-path cohort accounting (repro_torch.net.fastpath.CohortStats): which
    # requests advanced vectorized, which individuated into tasks, and the
    # per-leg (request, node) attribution payment batching consumes
    cohort: object = None
    # engine telemetry: events the loop processed + wall-clock spent (the
    # fast path adds one event per vectorized request completion)
    engine_events: int = 0
    engine_wall_s: float = 0.0

    @property
    def engine_events_per_sec(self) -> float:
        """Engine throughput (events per wall-clock second) of this replay."""
        if self.engine_wall_s <= 0:
            return 0.0
        return self.engine_events / self.engine_wall_s

    @property
    def num_requests(self) -> int:
        return len(self.records) + (len(self.batch) if self.batch is not None else 0)

    @property
    def dropped(self) -> int:
        """Hard failures only; admission refusals are counted by `shed`."""
        n = sum(1 for r in self.records if not r.ok and not r.shed)
        if self.batch is not None:
            n += int(np.count_nonzero(~self.batch.ok & ~self.batch.shed))
        return n

    @property
    def shed(self) -> int:
        """Requests the fleet refused at admission (typed Overloaded)."""
        n = sum(1 for r in self.records if r.shed)
        if self.batch is not None:
            n += int(np.count_nonzero(self.batch.shed))
        return n

    @property
    def shed_rate(self) -> float:
        total = self.num_requests
        return self.shed / total if total else 0.0

    def _arrivals(self) -> np.ndarray:
        parts = []
        if self.records:
            parts.append(np.array([r.t_ms for r in self.records]))
        if self.batch is not None and len(self.batch):
            parts.append(self.batch.t_ms)
        return np.concatenate(parts) if parts else np.empty(0)

    @property
    def offered_rps(self) -> float:
        """Offered load: arrivals over the arrival window (requests/s)."""
        t = self._arrivals()
        if t.size < 2:
            return 0.0
        window = float(t.max() - t.min())
        return (t.size - 1) * 1e3 / window if window > 0 else float("inf")

    @property
    def goodput_mbps(self) -> float:
        """Delivered bits (served requests only) over the serving span."""
        if self.span_ms <= 0:
            return 0.0
        nbytes = sum(r.nbytes for r in self.records if r.ok)
        if self.batch is not None:
            nbytes += int(self.batch.nbytes[self.batch.ok].sum())
        return nbytes * 8e-3 / self.span_ms

    def latencies_ms(self, kind: str | None = None) -> list[float]:
        lats = [
            r.latency_ms for r in self.records
            if r.ok and (kind is None or r.kind == kind)
        ]
        if self.batch is not None and (kind is None or kind == self.batch.kind):
            lats.extend(self.batch.latency_ms[self.batch.ok].tolist())
        return lats

    def percentile(self, q: float, kind: str | None = None) -> float:
        lats = self.latencies_ms(kind)
        return float(np.percentile(np.asarray(lats), q)) if lats else 0.0

    # -- DAS sampling accounting ------------------------------------------------
    @property
    def das_samples(self) -> int:
        """Sample requests that ran to a verdict (served or hard-failed)."""
        return sum(1 for r in self.records if r.kind == "das" and not r.shed)

    @property
    def das_detections(self) -> int:
        """Samples that hit a withheld/bad share (ReadError, unpaid)."""
        return sum(
            1 for r in self.records if r.kind == "das" and not r.ok and not r.shed
        )

    # -- background-plane accounting ------------------------------------------------
    @property
    def background_ops(self) -> int:
        return len(self.background)

    @property
    def background_bytes(self) -> int:
        return sum(b.nbytes for b in self.background)

    @property
    def background_failures(self) -> int:
        return sum(1 for b in self.background if not b.ok)

    @property
    def membership_events(self) -> int:
        """Membership-plane records (joins/leaves/crashes/slashes plus the
        per-epoch reconfigure/lost summaries) that rode this replay."""
        return sum(1 for b in self.background if b.kind == "member")

    def background_percentile(self, q: float) -> float:
        lats = [b.latency_ms for b in self.background if b.ok]
        return float(np.percentile(np.asarray(lats), q)) if lats else 0.0

    def digest(self) -> str:
        """Determinism fingerprint: every request's exact timings, every
        background op's timings, plus the per-link byte counters.  Two runs
        of the same workload on a fresh world must produce byte-identical
        digests — including the audit/repair schedule."""
        h = hashlib.sha256()
        for r in self.records:
            h.update(
                f"{r.index}|{r.t_ms!r}|{r.finish_ms!r}|{r.latency_ms!r}|"
                f"{r.nbytes}|{r.ok}|{r.client}|{r.blob_id}|{r.shed}|{r.kind}\n".encode()
            )
        if self.batch is not None:
            # identical row format from the pooled columns (``.tolist()``
            # yields native float/int/bool, so every !r matches the record
            # path byte for byte) — a fast replay and a task replay of the
            # same schedule digest equal
            b = self.batch
            names, kind = b.clients, b.kind
            for i, t, f, lat, nb, ok, c, blob, shed in zip(
                b.index.tolist(), b.t_ms.tolist(), b.finish_ms.tolist(),
                b.latency_ms.tolist(), b.nbytes.tolist(), b.ok.tolist(),
                b.client_idx.tolist(), b.blob_id.tolist(), b.shed.tolist(),
            ):
                h.update(
                    f"{i}|{t!r}|{f!r}|{lat!r}|{nb}|{ok}|{names[c]}|{blob}|"
                    f"{shed}|{kind}\n".encode()
                )
        for b in self.background:
            h.update(
                f"bg|{b.kind}|{b.key}|{b.t_ms!r}|{b.finish_ms!r}|{b.ok}|"
                f"{b.nbytes}\n".encode()
            )
        for key in sorted(self.link_bytes, key=str):
            h.update(f"{key}={self.link_bytes[key]}\n".encode())
        return h.hexdigest()


@dataclasses.dataclass
class LoadSweep:
    """Goodput-vs-offered-load and shed-rate series across an open-loop
    ramp: one :class:`ReplayResult` per offered rate, with the aligned
    series the saturation analysis (and `benchmarks.backbone_serve`) plots.
    The *knee* is where goodput stops tracking offered load — with
    admission control it shows up as a rising shed rate and a bounded p99
    instead of a diverging queue.
    """

    rates_rps: list[float]
    results: list[ReplayResult]

    @property
    def goodput_mbps(self) -> list[float]:
        return [r.goodput_mbps for r in self.results]

    @property
    def shed_rate(self) -> list[float]:
        return [r.shed_rate for r in self.results]

    def p99_ms(self) -> list[float]:
        return [r.percentile(99.0) for r in self.results]

    def p50_ms(self) -> list[float]:
        return [r.percentile(50.0) for r in self.results]


def sweep_open_loop(make_fleet, make_requests, rates_rps, *,
                    driver=None) -> LoadSweep:
    """Replay the same workload shape at each offered rate on a FRESH fleet
    (``make_fleet() -> fleet``, ``make_requests(rate_rps) -> [ReadRequest]``)
    and collect the aligned saturation series.  ``driver`` defaults to
    :func:`replay_open_loop`; pass a session-aware closure to keep reads
    paid (see ``ShelbySession.replay``)."""
    results = []
    for rate in rates_rps:
        fleet = make_fleet()
        reqs = make_requests(rate)
        if driver is None:
            results.append(replay_open_loop(fleet, reqs))
        else:
            results.append(driver(fleet, reqs))
    return LoadSweep(rates_rps=list(rates_rps), results=results)


def _serve_one(loop, fleet, records, i, req, label, on_served, on_shed=None):
    """Task body shared by both drivers: serve one request, record its fate."""
    # deferred imports: storage.rpc imports repro_torch.net.scheduler
    from repro_torch.storage.rpc import Overloaded, ReadError

    t0 = loop.now
    try:
        srs = yield from fleet.serve_ranges_task(
            loop, [(req.blob_id, req.offset, req.length)],
            client=req.client, label=label,
        )
    except Overloaded:
        # load-shed: the fleet said no before doing the work — a cheap,
        # fast NACK that debits nothing (distinct from a hard failure)
        records[i] = RequestRecord(i, t0, loop.now, loop.now - t0, 0, False,
                                   req.client, req.blob_id, shed=True)
        if on_shed is not None:
            on_shed(i, req, loop.now - t0)
        return
    except ReadError:
        # unrecoverable under current failures: the request is dropped (and
        # pay-on-delivery means it debits nothing)
        records[i] = RequestRecord(i, t0, loop.now, loop.now - t0, 0, False,
                                   req.client, req.blob_id)
        return
    sr = srs[0]
    finish = t0 + sr.latency_ms  # client-observed (includes response prop)
    records[i] = RequestRecord(i, t0, finish, sr.latency_ms, len(sr.data),
                               True, req.client, req.blob_id)
    if on_served is not None:
        on_served(i, req, sr)
    return sr


def _sample_one(loop, fleet, records, i, req, label, on_sampled, on_shed=None):
    """Task body: one DAS sample through the fleet, recorded like a read.

    A hard failure (withheld / bad share) is the sampler's DETECTION
    signal, not an error to retry: it lands as ``ok=False, kind="das"``
    and debits nothing (pay-on-delivery)."""
    from repro_torch.storage.rpc import Overloaded, ReadError

    t0 = loop.now
    try:
        ss = yield from fleet.sample_share_task(
            loop, req.blob_id, req.row, req.col,
            client=req.client, cache_bypass=req.cache_bypass, label=label,
        )
    except Overloaded:
        records[i] = RequestRecord(i, t0, loop.now, loop.now - t0, 0, False,
                                   req.client, req.blob_id, shed=True, kind="das")
        if on_shed is not None:
            on_shed(i, req, loop.now - t0)
        return
    except ReadError:
        records[i] = RequestRecord(i, t0, loop.now, loop.now - t0, 0, False,
                                   req.client, req.blob_id, kind="das")
        return
    finish = t0 + ss.latency_ms
    records[i] = RequestRecord(i, t0, finish, ss.latency_ms, ss.nbytes,
                               True, req.client, req.blob_id, kind="das")
    if on_sampled is not None:
        on_sampled(i, req, ss)
    return ss


def _planes(background) -> list:
    """Normalize the ``background`` argument: None, one plane, or a list of
    planes — anything with ``spawn(loop)`` and a ``records`` list (see
    ``repro_torch.storage.background``)."""
    if background is None:
        return []
    if hasattr(background, "spawn"):
        return [background]
    return list(background)


def _finish_replay(loop, records, network, planes=()) -> ReplayResult:
    """Shared result assembly: drop unserved slots, compute the span, and
    snapshot link utilization for the determinism digest."""
    done = [r for r in records if r is not None]
    span = (
        max(r.finish_ms for r in done) - min(r.t_ms for r in done) if done else 0.0
    )
    link = dict(network.link_bytes) if network is not None else {}
    bg = [rec for p in planes for rec in p.records]
    return ReplayResult(records=done, span_ms=span, link_bytes=link,
                        trace=loop.trace, background=bg,
                        engine_events=loop.events_processed,
                        engine_wall_s=loop.wall_s)


def replay_open_loop(
    fleet,
    requests: list[ReadRequest],
    *,
    on_served=None,  # (index, request, ServedRange) -> None, completion order
    on_shed=None,  # (index, request, nack_latency_ms) -> None
    on_sampled=None,  # (index, SampleRequest, SampledShare) -> None
    background=None,  # plane(s) with spawn(loop): audits/repair share the loop
    trace: bool = False,
    engine: str | None = None,  # event-queue discipline (calendar|heap)
) -> ReplayResult:
    """Open-loop replay: every request is its own task spawned at its
    arrival time on ONE shared loop, so all in-flight requests' hedge
    timers, recoveries, SP queues and NIC transfers interleave.

    ``requests`` may mix :class:`ReadRequest` and :class:`SampleRequest`
    (a streaming workload concurrent with a DAS storm is just one merged
    request list); sample outcomes land in the same records under
    ``kind="das"``.

    ``background`` plane(s) are spawned on the SAME loop before it runs:
    audit proofs and repair helper reads contend with the replay for NICs,
    trunks and SP disk slots, and their records land in
    ``ReplayResult.background`` (covered by the determinism digest)."""
    if isinstance(requests, RequestBatch):
        requests = requests.to_requests()
    loop = EventLoop(network=fleet.network, trace=trace, engine=engine)
    records: list[RequestRecord | None] = [None] * len(requests)
    for i, req in enumerate(requests):
        if isinstance(req, SampleRequest):
            task = _sample_one(loop, fleet, records, i, req, f"req{i}",
                               on_sampled, on_shed)
        else:
            task = _serve_one(loop, fleet, records, i, req, f"req{i}",
                              on_served, on_shed)
        loop.spawn(task, at_ms=req.t_ms, label=f"req{i}")
    planes = _planes(background)
    for p in planes:
        p.spawn(loop)
    loop.run()
    return _finish_replay(loop, records, loop.network, planes)


def replay_closed_loop(
    fleet,
    schedules: list[tuple[str, list[tuple[int, int, int]]]],  # (client, ranges)
    *,
    think_ms: float = 0.0,
    background=None,  # plane(s) with spawn(loop), as in replay_open_loop
    trace: bool = False,
    engine: str | None = None,  # event-queue discipline (calendar|heap)
) -> ReplayResult:
    """Closed-loop replay: one task per client, each issuing its next
    request only after the previous one finished (plus ``think_ms``) — the
    training/analytics regime where offered load self-throttles."""
    loop = EventLoop(network=fleet.network, trace=trace, engine=engine)
    records: list[RequestRecord] = []

    def client_task(cname, ranges):
        for blob_id, off, ln in ranges:
            req = ReadRequest(loop.now, cname, blob_id, off, ln)
            i = len(records)
            records.append(None)  # reserve the slot in issue order
            sr = yield from _serve_one(loop, fleet, records, i, req, cname, None)
            if sr is not None:
                # pace to the client-observed completion (the node-side join
                # lands one propagation earlier than the client sees data)
                gap = records[i].finish_ms - loop.now
                if gap > 0 or think_ms > 0:
                    yield Sleep(max(gap, 0.0) + think_ms)

    for cname, ranges in schedules:
        loop.spawn(client_task(cname, ranges), at_ms=0.0, label=cname)
    planes = _planes(background)
    for p in planes:
        p.spawn(loop)
    loop.run()
    return _finish_replay(loop, records, loop.network, planes)
