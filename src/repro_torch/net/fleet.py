"""Multi-RPC serving fleet (§2.3): request routing + per-node hot caches.

One RPC node cannot serve "millions of users"; Shelby's data plane is a
*fleet* of RPC nodes behind the same contract, each with its own decoded
hot-cache.  The router decides which node serves which request; the policy
determines the cache economics:

* ``LatencyAwarePolicy``   — client->node propagation + EWMA of the node's
  recent fetch latency (greedy, CDN-edge-style).
* ``CacheAffinityPolicy``  — rendezvous (highest-random-weight) hashing on
  (blob, chunkset): every object has one home node, so the fleet's
  aggregate cache behaves like one big cache.
* ``PowerOfTwoPolicy``     — classic power-of-two-choices on routed load;
  near-uniform balance with two probes.

Routing is per *chunkset*, the cache/decode unit, so a range read spanning
chunksets may fan out across the fleet and assemble at the edge (chunkset
fetches overlap; the request's simulated latency is the slowest leg plus
the client<->node round trip when a backbone is attached).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.net.backbone import Backbone
from repro_torch.net.events import EventLoop, Join, Sleep

if TYPE_CHECKING:  # avoid a cycle: storage.rpc imports repro_torch.net.scheduler
    from repro_torch.storage.rpc import RPCNode


@dataclasses.dataclass
class ServedRange:
    """One byte-range served by the fleet, with per-node attribution.

    `chunksets_by_node` maps rpc_id -> number of this range's chunksets that
    node served — the basis for the client's per-serving-node payments.
    """

    blob_id: int
    offset: int
    length: int
    data: bytes
    latency_ms: float
    chunksets_by_node: dict[str, int]
    cache_hits: int = 0
    hedges_launched: int = 0
    hedged_wasted: int = 0
    coalesced: int = 0  # chunksets that joined another request's fetch
    # rpc_id -> chunksets this range served on that node AFTER its routed
    # node shed the leg (retry-on-sibling); payments follow the server
    retried_nodes: dict[str, int] = dataclasses.field(default_factory=dict)


class LatencyAwarePolicy:
    """Route to the node minimizing propagation + recent-latency EWMA."""

    # routing depends on live fleet state (EWMA, routed counts): the cohort
    # fast path cannot precompute it, so batches de-opt to task mode
    static = False

    def pick(self, key: tuple[int, int], client: str | None, fleet: "RPCFleet") -> int:
        def est(i: int) -> tuple[float, int, int]:
            prop = 0.0
            if fleet.backbone is not None and client is not None:
                prop = fleet.backbone.propagation_ms(client, fleet.node_ids[i])
            return (prop + fleet.ewma_ms[i], fleet.routed[i], i)

        return min(range(len(fleet.rpcs)), key=est)


class CacheAffinityPolicy:
    """Rendezvous hashing on (blob_id, chunkset) -> stable home node.

    A pure function of (key, node set), so picks are memoized: a hot key
    re-routed a million times costs one sha256 sweep, not a million — and
    the cohort fast path can route whole batches through the same memo.
    """

    static = True  # pick depends only on (key, node set): vectorizable

    def __init__(self):
        self._memo: dict[tuple[int, int], int] = {}
        self._memo_nodes: object = None  # fleet.node_ids identity the memo is valid for

    def pick(self, key: tuple[int, int], client: str | None, fleet: "RPCFleet") -> int:
        if fleet.node_ids is not self._memo_nodes:
            self._memo.clear()
            self._memo_nodes = fleet.node_ids
        hit = self._memo.get(key)
        if hit is not None:
            return hit

        def weight(i: int) -> bytes:
            tag = f"{fleet.node_ids[i]}|{key[0]}|{key[1]}".encode()
            return hashlib.sha256(tag).digest()

        best = max(range(len(fleet.rpcs)), key=weight)
        self._memo[key] = best
        return best


class PowerOfTwoPolicy:
    """Two seeded random probes, pick the less-loaded (routed count)."""

    static = False  # consumes an rng stream in routing order

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def pick(self, key: tuple[int, int], client: str | None, fleet: "RPCFleet") -> int:
        n = len(fleet.rpcs)
        if n == 1:
            return 0
        a, b = self._rng.choice(n, size=2, replace=False)
        return int(a if fleet.routed[a] <= fleet.routed[b] else b)


# named policy factories: the routing_policy config knob and the scenario
# registry resolve policies by these names (fresh instance per fleet —
# policies carry per-fleet state: memos, rng streams, EWMA views)
POLICY_FACTORIES = {
    "latency": LatencyAwarePolicy,
    "affinity": CacheAffinityPolicy,
    "p2c": lambda: PowerOfTwoPolicy(seed=0),
}


def make_policy(name: str):
    """A fresh routing-policy instance for a registered name."""
    try:
        factory = POLICY_FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"routing_policy must be one of {sorted(POLICY_FACTORIES)}, "
            f"got {name!r}"
        ) from None
    return factory()


class RPCFleet:
    """Routes chunkset reads across RPC nodes and accounts serving metrics."""

    def __init__(
        self,
        rpcs: list[RPCNode],
        policy,
        *,
        backbone: Backbone | None = None,
        ewma_alpha: float = 0.3,
    ):
        if not rpcs:
            raise ValueError("fleet needs at least one RPC node")
        self.rpcs = list(rpcs)
        self.node_ids = [r.rpc_id for r in self.rpcs]
        self.policy = policy
        self.backbone = backbone
        self._alpha = ewma_alpha
        self.ewma_ms = [0.0] * len(self.rpcs)
        self._ewma_seeded = [False] * len(self.rpcs)
        self.routed = [0] * len(self.rpcs)
        self.chunkset_reads = 0
        self.samples_routed = 0  # DAS samples (accounted apart from reads)
        self.bytes_served = 0
        self.request_latencies_ms: list[float] = []
        # overload accounting (legs = one node's share of one request)
        self.shed_legs = 0  # node legs refused at admission
        self.retried_legs = 0  # shed legs rescued by a sibling
        self.retried_chunksets = 0  # chunksets served via those retries

    @property
    def primary(self) -> RPCNode:
        """The node that fronts write dispersal (any node can; pick node 0)."""
        return self.rpcs[0]

    @property
    def network(self) -> Backbone | None:
        """The Backbone event-loop Transfers route over: the fleet's own, or
        — for a bare RPCNode wrapped into a fleet of one — the primary
        transport's."""
        return self.backbone or getattr(self.primary.transport, "backbone", None)

    def node(self, rpc_id: str) -> RPCNode:
        return self.rpcs[self.node_ids.index(rpc_id)]

    def admit_sp(self, sp_id: int, sp, node: str | None = None) -> None:
        """Fan a mid-run SP join out to every RPC node (membership plane):
        each opens its payment channel and learns the transport route, so
        reassigned chunksets are servable fleet-wide the moment the
        contract's placement points at the newcomer."""
        for rpc in self.rpcs:
            rpc.admit_sp(sp_id, sp, node)

    # -- serving ------------------------------------------------------------------
    def _route(self, blob_id: int, chunkset: int, client: str | None) -> int:
        i = self.policy.pick((blob_id, chunkset), client, self)
        self.routed[i] += 1
        self.chunkset_reads += 1
        return i

    def _observe(self, i: int, ms: float) -> None:
        if not self._ewma_seeded[i]:
            self.ewma_ms[i], self._ewma_seeded[i] = ms, True
        else:
            self.ewma_ms[i] = (1 - self._alpha) * self.ewma_ms[i] + self._alpha * ms

    def _prop(self, i: int, client: str | None) -> float:
        if self.backbone is None or client is None:
            return 0.0
        return self.backbone.propagation_ms(client, self.node_ids[i])

    def serve_ranges_task(
        self,
        loop: EventLoop,
        ranges: list[tuple[int, int, int]],  # (blob_id, offset, length)
        client: str | None = None,
        label: str = "serve",
    ):
        """Task: serve many byte ranges — possibly of different blobs — in
        ONE fleet pass on the shared event loop.

        Every (blob, chunkset) across ALL ranges is routed individually at
        the task's start time (deduplicated — two ranges sharing a chunkset
        fetch it once), then each node reads its entire share as ONE
        spawned `read_items_task`, so wide GF batch-decodes span requests
        and all node legs run concurrently on the shared heap — contending
        with every other in-flight request's legs for trunks, NICs and SP
        disk slots.  Client<->node legs are pure propagation (clients reach
        the fleet over the public internet, not the dedicated backbone): a
        range's latency is the max over its own chunksets' legs plus the
        client<->node round trip.

        Overload: a node leg refused at admission (:class:`Overloaded`) is
        retried ONCE on the least-loaded sibling — the NACK is cheap, so
        the edge re-issues: extra latency is the round trip burned on the
        refusing node plus the sibling's own propagation.  If the sibling
        sheds too, the whole request surfaces as `Overloaded` (replay
        drivers record it as *shed*, and pay-on-delivery means it debits
        nothing).  Payments follow the node that actually served.
        """
        from repro_torch.storage.rpc import Overloaded  # deferred: import cycle

        lay = self.primary.layout
        contract = self.primary.contract
        per_range_items: list[list[tuple[int, int]]] = []
        routed_node: dict[tuple[int, int], int] = {}  # (blob, cs) -> node index
        by_node: dict[int, list[tuple[int, int]]] = {}
        for blob_id, offset, length in ranges:
            first, last = lay.byte_range_to_chunksets(offset, length)
            items = [(blob_id, cs) for cs in range(first, last + 1)]
            per_range_items.append(items)
            for key in items:
                if key not in routed_node:
                    i = self._route(key[0], key[1], client)
                    routed_node[key] = i
                    by_node.setdefault(i, []).append(key)

        decoded: dict[tuple[int, int], object] = {}
        item_stats: dict[tuple[int, int], object] = {}
        served_by: dict[tuple[int, int], int] = {}  # who ACTUALLY served
        retried: set[tuple[int, int]] = set()
        extra_ms: dict[tuple[int, int], float] = {}  # client round trips
        handles: dict[int, object] = {}
        for i, node_items in by_node.items():
            prop = self._prop(i, client)

            def node_task(i=i, node_items=node_items, prop=prop):
                if prop > 0:
                    yield Sleep(prop)  # request reaches the serving node
                try:
                    out, stats = yield from self.rpcs[i].read_items_task(
                        loop, node_items, label=f"{label}/{self.node_ids[i]}"
                    )
                    return out, stats, i, 2.0 * prop
                except Overloaded:
                    self.shed_legs += 1
                    j = self._sibling(i)
                    if j is None:
                        raise  # fleet of one: nowhere to retry
                    # the NACK came back (prop) and the edge re-issues to
                    # the sibling (its own propagation); if the sibling
                    # sheds too, Overloaded propagates and drops the request
                    prop_j = self._prop(j, client)
                    if prop + prop_j > 0:
                        yield Sleep(prop + prop_j)
                    out, stats = yield from self.rpcs[j].read_items_task(
                        loop, node_items, label=f"{label}/{self.node_ids[j]}"
                    )
                    self.retried_legs += 1
                    self.retried_chunksets += len(node_items)
                    self.routed[j] += len(node_items)  # load landed on the sibling
                    return out, stats, j, 2.0 * prop + 2.0 * prop_j

            handles[i] = loop.spawn(
                node_task(), label=f"{label}/{self.node_ids[i]}"
            )
        first_err: Exception | None = None
        for i, h in handles.items():
            try:
                out, stats, srv, extra = yield Join(h)
            except (GeneratorExit, KeyboardInterrupt):
                # task teardown / user interrupt must never be harvested as
                # a leg failure — propagate immediately
                raise
            except Exception as e:  # harvest every node leg before raising
                if first_err is None:
                    first_err = e
                continue
            self._observe(srv, max(s.latency_ms for s in stats.values()))
            decoded.update(out)
            item_stats.update(stats)
            for key in out:
                served_by[key] = srv
                extra_ms[key] = extra
                if srv != i:
                    retried.add(key)
        if first_err is not None:
            raise first_err

        served: list[ServedRange] = []
        for (blob_id, offset, length), items in zip(ranges, per_range_items):
            meta = contract.blobs[blob_id]
            first = items[0][1]
            data = lay.extract_range(
                [decoded[key] for key in items], first, offset, length,
                meta.size_bytes,
            )
            by_node_count: dict[str, int] = {}
            retried_nodes: dict[str, int] = {}
            latency, hits, hedges, wasted, coalesced = 0.0, 0, 0, 0, 0
            for key in items:
                nid = self.node_ids[served_by[key]]
                by_node_count[nid] = by_node_count.get(nid, 0) + 1
                if key in retried:
                    retried_nodes[nid] = retried_nodes.get(nid, 0) + 1
                s = item_stats[key]
                latency = max(latency, s.latency_ms + extra_ms[key])
                hits += s.cache_hit
                hedges += s.hedges
                wasted += s.wasted
                coalesced += s.coalesced
            served.append(
                ServedRange(
                    blob_id=blob_id, offset=offset, length=length, data=data,
                    latency_ms=latency, chunksets_by_node=by_node_count,
                    cache_hits=hits, hedges_launched=hedges, hedged_wasted=wasted,
                    coalesced=coalesced, retried_nodes=retried_nodes,
                )
            )
            self.bytes_served += len(data)
            self.request_latencies_ms.append(latency)
        return served

    # -- DAS sampling (tiny proof-carrying reads) ----------------------------------
    def sample_share_task(
        self,
        loop: EventLoop,
        blob_id: int,
        row: int,
        col: int,
        *,
        client: str | None = None,
        cache_bypass: bool = True,
        label: str = "das",
    ):
        """Task: route ONE DAS sample to a node, fetch + verify it there.

        Routing uses the policy with a coordinate-derived key (each share
        is its own cache/decode unit), but samples are accounted apart
        from chunkset reads: they do not touch ``chunkset_reads`` (so the
        streaming ``cache_hit_rate`` stays a streaming metric) and do not
        feed the latency EWMA (tiny single-slot reads would make every
        node look fast to the latency-aware router).  A shed leg retries
        once on the least-loaded sibling, like any other request.
        """
        from repro_torch.storage.rpc import Overloaded  # deferred: import cycle

        rec = self.primary.contract.das.get(blob_id)
        if rec is None:
            from repro_torch.storage.rpc import ReadError

            raise ReadError(f"blob {blob_id} has no DAS extension")
        key = (blob_id, rec.side * rec.side + row * rec.side + col)
        i = self.policy.pick(key, client, self)
        self.routed[i] += 1
        self.samples_routed += 1
        prop = self._prop(i, client)
        if prop > 0:
            yield Sleep(prop)
        srv, extra = i, 2.0 * prop
        try:
            ss = yield from self.rpcs[i].sample_share_task(
                loop, blob_id, row, col, cache_bypass=cache_bypass,
                label=f"{label}/{self.node_ids[i]}",
            )
        except Overloaded:
            self.shed_legs += 1
            j = self._sibling(i)
            if j is None:
                raise
            prop_j = self._prop(j, client)
            if prop + prop_j > 0:
                yield Sleep(prop + prop_j)
            ss = yield from self.rpcs[j].sample_share_task(
                loop, blob_id, row, col, cache_bypass=cache_bypass,
                label=f"{label}/{self.node_ids[j]}",
            )
            self.retried_legs += 1
            self.routed[j] += 1
            srv, extra = j, 2.0 * prop + 2.0 * prop_j
        return dataclasses.replace(
            ss, latency_ms=ss.latency_ms + extra, rpc_id=self.node_ids[srv]
        )

    def _sibling(self, i: int) -> int | None:
        """Deterministic overflow target for a shed leg: the least-routed
        OTHER node (ties by index); None on a fleet of one."""
        others = [j for j in range(len(self.rpcs)) if j != i]
        if not others:
            return None
        return min(others, key=lambda j: (self.routed[j], j))

    def serve_ranges(
        self,
        ranges: list[tuple[int, int, int]],  # (blob_id, offset, length)
        *,
        client: str | None = None,
        t_ms: float = 0.0,
    ) -> list[ServedRange]:
        """Synchronous wrapper over :meth:`serve_ranges_task`.

        `t_ms` anchors the batch on the global simulated clock; trunk/NIC
        reservations persist in the shared Backbone, so sequential callers
        still queue against earlier traffic.  For genuinely concurrent
        requests, spawn `serve_ranges_task` per request on one shared loop
        (see ``repro_torch.net.workloads.replay_open_loop``)."""
        loop = EventLoop(network=self.network)
        h = loop.spawn(
            self.serve_ranges_task(loop, ranges, client=client),
            at_ms=t_ms, label="serve",
        )
        return loop.run_until(h)

    def read_range(
        self, blob_id: int, offset: int, length: int, *, client: str | None = None,
        t_ms: float = 0.0,
    ) -> tuple[bytes, float]:
        """Serve [offset, offset+length) and return (bytes, sim_latency_ms)."""
        sr = self.serve_ranges([(blob_id, offset, length)], client=client, t_ms=t_ms)[0]
        return sr.data, sr.latency_ms

    # -- metrics -------------------------------------------------------------------
    def cache_hit_rate(self) -> float:
        hits = sum(r.stats.cache_hits for r in self.rpcs)
        return hits / self.chunkset_reads if self.chunkset_reads else 0.0

    def hedged_wasted(self) -> int:
        """Paid-but-unused requests, incl. crash-recovery replacements."""
        return sum(r.stats.hedged_wasted for r in self.rpcs)

    def hedges_launched(self) -> int:
        """Requests launched by hedge deadlines only (straggler mitigation)."""
        return sum(r.stats.hedges_launched for r in self.rpcs)

    def hedges_suppressed(self) -> int:
        """Hedge deadlines the per-node overload gate refused to act on."""
        return sum(r.stats.hedges_suppressed for r in self.rpcs)

    def coalesced(self) -> int:
        """Cache misses that piggybacked on an in-flight fetch (stampede
        collapse) instead of fetching from SPs again."""
        return sum(r.stats.coalesced for r in self.rpcs)

    def requests_shed(self) -> int:
        """Node-level admission refusals (each is one leg's Overloaded)."""
        return sum(r.stats.shed_requests for r in self.rpcs)

    def samples_served(self) -> int:
        """DAS shares delivered + verified across the fleet."""
        return sum(r.stats.samples_served for r in self.rpcs)

    def samples_withheld(self) -> int:
        """DAS samples an SP went silent on (the detection signal)."""
        return sum(r.stats.samples_withheld for r in self.rpcs)

    def sample_proof_bytes(self) -> int:
        """Proof bandwidth moved for DAS samples, fleet-wide."""
        return sum(r.stats.sample_proof_bytes for r in self.rpcs)

    def latency_percentiles(self, *qs: float) -> tuple[float, ...]:
        if not self.request_latencies_ms:
            return tuple(0.0 for _ in qs)
        arr = np.asarray(self.request_latencies_ms)
        return tuple(float(np.percentile(arr, q)) for q in qs)
