"""Simulated dedicated backbone (§2.3): topology + transfer accounting.

The paper's RPC and storage nodes talk over a *dedicated* network, so
serving performance is a property of topology and load, not of the public
internet.  This module models that network as a set of datacenters joined
by directed trunks, each with a propagation latency and a bandwidth.  All
times are **simulated milliseconds**: a transfer departs at a caller-chosen
sim time and the model returns its arrival time, accounting FIFO
serialization on every trunk it crosses.  Nothing here reads a wall clock,
so latency numbers are workload-driven and exactly reproducible.

Model, per directed DC pair (a, b):

    arrival = start_tx + serialize(nbytes) + propagation(a, b)

where ``start_tx`` is the earliest idle slot on the trunk at or after the
departure time that fits the serialization window.  Reservations are kept
as disjoint busy intervals, so accounting stays correct even when callers
replay transfers out of time order (a straggler's late response must never
block a transfer that departs while the trunk is still idle).

Intra-DC transfers use a single (fat, short) implicit link per DC with the
same accounting.  Per-link byte counters expose utilization to benchmarks.

Nodes can additionally be NIC-limited: ``register_node(..., nic=NICSpec)``
gives a node full-duplex egress/ingress line rates.  A transfer then
serializes through up to three stages — source egress NIC, DC-pair trunk,
destination ingress NIC — modelled cut-through: each stage reserves its
earliest idle window at/after the *start* of the upstream stage's window,
and the arrival is the latest window end plus propagation.  A fan-in hot
node (one RPC node pulling chunks from a dozen SPs at once) therefore
queues on its own ingress NIC even when every trunk is idle — the paper's
"serving performance is a property of topology and load" made concrete.
Nodes without a NIC spec are unlimited (the pre-NIC behaviour, bit-exact).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One directed trunk: propagation delay + line rate."""

    latency_ms: float
    gbps: float

    def serialize_ms(self, nbytes: int) -> float:
        return nbytes * 8e-6 / self.gbps  # bits / (Gbit/s) in ms


DEFAULT_INTRA_DC = LinkSpec(latency_ms=0.2, gbps=100.0)
DEFAULT_INTER_DC = LinkSpec(latency_ms=8.0, gbps=40.0)


@dataclasses.dataclass(frozen=True)
class NICSpec:
    """Per-node full-duplex line rates (egress and ingress serialize
    independently; each direction is one FIFO resource)."""

    egress_gbps: float = 10.0
    ingress_gbps: float = 10.0

    def egress_ms(self, nbytes: int) -> float:
        return nbytes * 8e-6 / self.egress_gbps

    def ingress_ms(self, nbytes: int) -> float:
        return nbytes * 8e-6 / self.ingress_gbps


class Backbone:
    """Datacenter topology with simulated-clock transfer accounting.

    Nodes (SPs, RPC nodes, clients) are registered into a DC; transfers are
    node-to-node but queue on the DC-pair trunk (or the intra-DC fabric).
    """

    def __init__(
        self,
        dcs: list[str],
        *,
        inter_dc: dict[tuple[str, str], LinkSpec] | None = None,
        default_inter: LinkSpec = DEFAULT_INTER_DC,
        intra_dc: LinkSpec = DEFAULT_INTRA_DC,
        default_nic: NICSpec | None = None,
    ):
        self.dcs = list(dcs)
        self._inter = dict(inter_dc or {})
        self._default_inter = default_inter
        self._intra = intra_dc
        self._default_nic = default_nic
        self._node_dc: dict[str, str] = {}
        self._node_nic: dict[str, NICSpec | None] = {}
        # directed (src_dc, dst_dc) trunk — or ("nic>", node) egress /
        # ("nic<", node) ingress — key -> sorted disjoint busy intervals
        self._busy: dict[tuple[str, str], list[tuple[float, float]]] = defaultdict(list)
        self.link_bytes: dict[tuple[str, str], int] = defaultdict(int)
        self.nic_bytes: dict[tuple[str, str], int] = defaultdict(int)  # ("out"|"in", node)
        self.transfers = 0

    # -- topology builders ---------------------------------------------------------
    @classmethod
    def mesh(cls, num_dcs: int = 3, *, base_latency_ms: float = 8.0,
             gbps: float = 40.0, intra_dc: LinkSpec = DEFAULT_INTRA_DC,
             default_nic: NICSpec | None = None) -> "Backbone":
        """Full mesh of `num_dcs` DCs; latency grows with DC-index distance
        (a stand-in for geographic spread)."""
        dcs = [f"dc{i}" for i in range(num_dcs)]
        inter = {}
        for i, a in enumerate(dcs):
            for j, b in enumerate(dcs):
                if a != b:
                    inter[(a, b)] = LinkSpec(base_latency_ms * abs(i - j), gbps)
        return cls(dcs, inter_dc=inter, intra_dc=intra_dc, default_nic=default_nic)

    # -- membership --------------------------------------------------------------
    def register_node(self, node_id: str, dc: str,
                      nic: NICSpec | None = None) -> None:
        if dc not in self.dcs:
            raise ValueError(f"unknown dc {dc!r} (have {self.dcs})")
        self._node_dc[node_id] = dc
        self._node_nic[node_id] = nic or self._default_nic

    def nic_of(self, node_id: str) -> NICSpec | None:
        return self._node_nic.get(node_id)

    def dc_of(self, node_id: str) -> str:
        return self._node_dc[node_id]

    def _link(self, src_dc: str, dst_dc: str) -> LinkSpec:
        if src_dc == dst_dc:
            return self._intra
        return self._inter.get((src_dc, dst_dc), self._default_inter)

    # -- latency model -------------------------------------------------------------
    def propagation_ms(self, src: str, dst: str) -> float:
        """One-way propagation between two registered nodes."""
        return self._link(self.dc_of(src), self.dc_of(dst)).latency_ms

    def estimate_ms(self, src: str, dst: str, nbytes: int) -> float:
        """Uncongested transfer estimate (no queueing) — scheduler's prior.

        Cut-through pipeline: the serialization cost is the slowest stage
        (source NIC, trunk, destination NIC), not their sum."""
        link = self._link(self.dc_of(src), self.dc_of(dst))
        tx = link.serialize_ms(nbytes)
        src_nic, dst_nic = self.nic_of(src), self.nic_of(dst)
        if src_nic is not None:
            tx = max(tx, src_nic.egress_ms(nbytes))
        if dst_nic is not None:
            tx = max(tx, dst_nic.ingress_ms(nbytes))
        return link.latency_ms + tx

    def _reserve(self, key: tuple[str, str], depart_ms: float, tx_ms: float) -> float:
        """Earliest idle slot of length `tx_ms` at/after `depart_ms`."""
        intervals = self._busy[key]
        t = depart_ms
        i = bisect.bisect_left(intervals, (t, float("-inf")))
        if i > 0 and intervals[i - 1][1] > t:  # departure lands mid-interval
            t = intervals[i - 1][1]
        while i < len(intervals) and intervals[i][0] < t + tx_ms:
            t = max(t, intervals[i][1])
            i += 1
        intervals.insert(i, (t, t + tx_ms))
        return t

    # -- the one state-mutating call -----------------------------------------------
    def transfer(self, src: str, dst: str, nbytes: int, depart_ms: float) -> float:
        """Send `nbytes` src -> dst at sim time `depart_ms`; returns arrival.

        Serialization reserves the earliest idle window on every stage the
        bytes cross — source egress NIC, DC-pair trunk, destination ingress
        NIC — cut-through (each stage may start once the upstream window
        starts); arrival is the latest window end plus propagation.
        Propagation overlaps freely (links are pipes, not buses).
        """
        a, b = self.dc_of(src), self.dc_of(dst)
        link = self._link(a, b)
        src_nic, dst_nic = self.nic_of(src), self.nic_of(dst)
        stages: list[tuple[tuple[str, str], float]] = []
        if src_nic is not None:
            stages.append((("nic>", src), src_nic.egress_ms(nbytes)))
            self.nic_bytes[("out", src)] += nbytes
        stages.append(((a, b), link.serialize_ms(nbytes)))
        if dst_nic is not None:
            stages.append((("nic<", dst), dst_nic.ingress_ms(nbytes)))
            self.nic_bytes[("in", dst)] += nbytes
        t = depart_ms
        finish = depart_ms
        for key, tx in stages:
            start = self._reserve(key, t, tx)
            t = start
            finish = max(finish, start + tx)
        self.link_bytes[(a, b)] += nbytes
        self.transfers += 1
        return finish + link.latency_ms

    # -- introspection -------------------------------------------------------------
    def utilization(self) -> dict[tuple[str, str], int]:
        """Bytes moved per directed DC pair (intra-DC under (dc, dc))."""
        return dict(self.link_bytes)

    def reset_accounting(self) -> None:
        self._busy.clear()
        self.link_bytes.clear()
        self.nic_bytes.clear()
        self.transfers = 0
