"""Membership plane: epoch-scale churn + contract reconfiguration (§2.5,
Appendix A; Walrus-style epoch reconfiguration).

The SP fleet is a living thing: providers join, announce departure, crash,
or get slashed-and-ejected — and the durability story ("erasure coding with
low replication overhead and minimal repair bandwidth") is only credible
when repair RACES that churn while paid serving continues.  This module
drives exactly that on the shared :class:`~repro_torch.net.events.EventLoop`:

* :class:`ChurnSpec` — a seeded per-SP per-epoch churn process
  (crash / announced-departure / slash probabilities, joins per epoch),
  plus explicitly *scripted* events for deterministic scenarios.  Draws
  are content-addressed per (epoch, SP) from the contract's epoch seed,
  so a higher churn rate fails a SUPERSET of the SPs a lower rate fails
  under the same seed — lost-chunkset probability is provably monotone in
  the churn rate, per seed (the coupling the property tests assert).
* :class:`MembershipPlane` — a background plane (same ``spawn(loop)`` /
  ``records`` contract as the audit/repair planes): mid-epoch it applies
  crashes and slashes at seeded times and registers joiners with the
  contract, the backbone and the serving fleet; at each epoch boundary it
  finalizes departures, takes a **census** (a chunkset with fewer than k
  live chunk holders is counted LOST — measured, not computed), asks the
  contract to :meth:`~repro_torch.core.contract.ShelbyContract.reconfigure_epoch`
  the displaced placement entries, and enqueues the resulting
  **re-dispersal backlog** through a :class:`RepairPlane` under the SPs'
  existing :class:`~repro_torch.storage.sp.BackgroundSpec` budget.  Every event
  appends a ``kind="member"`` :class:`BackgroundRecord`, so WHO churned
  and WHAT was remapped ride the replay determinism digest.
* :func:`measure_durability` — the measured lost-chunksets-vs-churn-rate
  series (`core.durability.ChurnPoint`): tiny seeded worlds churned for a
  few epochs, losses *counted* from the census and set against the
  analytic no-repair binomial tail.

Serving keeps running throughout: a crashed/departed SP NACKs, the hedged
k-of-n read path recovers from surviving code symbols mid-epoch, the RPC
hot caches version-check entries against ``contract.placement_version``
(no read is served off a stale member set), and pay-on-delivery means a
dead SP is never paid.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import placement as placement_mod
from repro_torch.core.contract import BlobState, ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.net.events import EventLoop, Sleep
from repro_torch.net.workloads import BackgroundRecord
from repro_torch.storage.background import RepairPlane
from repro_torch.storage.repair import RepairCoordinator
from repro_torch.storage.sp import ServiceSpec, StorageProvider

# deterministic application order for same-instant events: joins first
# (capacity arrives before demand), then failures
_KIND_RANK = {"join": 0, "announce": 1, "crash": 2, "slash": 3}


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Seeded churn process knobs (per SP, per epoch).

    ``p_crash`` / ``p_leave`` / ``p_slash`` are evaluated per live SP per
    epoch from ONE uniform draw each (content-addressed by epoch seed and
    sp_id, independent of iteration order), with crash taking precedence
    over leave over slash.  ``joins_per_epoch`` registers that many fresh
    SPs at seeded mid-epoch times.  ``min_active`` caps removals so the
    fleet never shrinks below it (``None`` = no floor).  ``scripted``
    pins explicit (epoch, kind, sp_id) events — kind is one of
    ``join|announce|crash|slash``, sp_id is ignored for joins, and an
    optional 4th element fixes the in-epoch time fraction — applied in
    ADDITION to the probabilistic draws (and exempt from the floor), for
    deterministic benchmark scenarios.
    """

    p_crash: float = 0.0
    p_leave: float = 0.0
    p_slash: float = 0.0
    joins_per_epoch: int = 0
    min_active: int | None = None
    seed: int = 0
    join_stake: float = 1000.0
    scripted: tuple[tuple[int, str, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One membership transition on the simulated clock."""

    kind: str  # join | announce | leave | crash | slash
    epoch: int
    t_ms: float
    sp_id: int


@dataclasses.dataclass
class EpochStats:
    """Boundary summary of one churned epoch."""

    epoch: int
    boundary_ms: float
    joins: int = 0
    crashes: int = 0
    departures: int = 0
    slashes: int = 0
    reassigned: int = 0
    enqueued: int = 0
    lost_new: int = 0
    handles: list = dataclasses.field(default_factory=list, repr=False)

    def drain_ms(self) -> float:
        """Boundary -> last repair of this epoch's backlog landed (NaN
        while any repair is still in flight; 0 for an empty backlog)."""
        if not self.handles:
            return 0.0
        return max(h.finished_ms for h in self.handles) - self.boundary_ms


class MembershipPlane:
    """Epoch-scale churn + reconfiguration as a background plane.

    Spawn it (optionally alongside its ``repair`` plane — see
    :meth:`planes`) on the same loop as a foreground replay and the churn
    process, the boundary reconfigurations and the re-dispersal backlog
    all contend with paid serving.

    ``repair``: a :class:`RepairCoordinator` to rebuild displaced chunks
    through (``None`` disables re-dispersal — the no-repair durability
    measurement).  ``fleet`` / ``backbone`` / ``nodes`` / ``nic`` wire
    joiners into serving: contract registration always happens; with a
    fleet the joiner gets payment channels + transport routes, with a
    backbone it gets a NIC'd node (and ``nodes`` gains the sp->node id
    the audit/repair planes route by).  ``lost`` may be a shared set when
    one logical churn run spans several replay loops (``run_sim``).
    """

    def __init__(
        self,
        contract: ShelbyContract,
        sps: dict[int, StorageProvider],
        layout,
        churn: ChurnSpec,
        *,
        repair: RepairCoordinator | None = None,
        repair_pace_ms: float | None = None,
        fleet=None,
        backbone=None,
        nodes: dict[int, str] | None = None,
        nic=None,
        epochs: int = 1,
        epoch_ms: float = 250.0,
        start_epoch: int = 0,
        num_dcs: int = 3,
        racks_per_dc: int = 4,
        service_factory=None,
        lost: set[tuple[int, int]] | None = None,
    ):
        self.contract = contract
        self.sps = sps
        self.layout = layout
        self.churn = churn
        self.repair = (
            RepairPlane(repair, lost=[], pace_ms=repair_pace_ms)
            if repair is not None else None
        )
        self.fleet = fleet
        self.backbone = backbone
        self.nodes = nodes
        self.nic = nic
        self.epochs = epochs
        self.epoch_ms = epoch_ms
        self.start_epoch = start_epoch
        self.num_dcs = num_dcs
        self.racks_per_dc = racks_per_dc
        self.service_factory = service_factory or ServiceSpec
        # lost chunksets are PERMANENT: a shared set lets one churn run
        # span several replay loops without re-counting old losses
        self.lost: set[tuple[int, int]] = lost if lost is not None else set()
        self.events: list[MembershipEvent] = []
        self.records: list[BackgroundRecord] = []
        self.epoch_stats: list[EpochStats] = []
        self.reassigned_total = 0
        self.joined: list[int] = []
        self._crashed: set[int] = set()  # crashes awaiting boundary finalize
        self._announced: set[int] = set()
        self._repairing: dict[tuple[int, int, int], object] = {}

    # -- plane contract ----------------------------------------------------------
    def planes(self) -> list:
        """What to pass as ``background=``: this plane + its repair plane
        (so backlog repairs land in the same replay's records/digest)."""
        return [self] if self.repair is None else [self, self.repair]

    def spawn(self, loop: EventLoop) -> None:
        loop.spawn(self._epochs_task(loop), at_ms=loop.now, label="membership")

    @property
    def lost_chunksets(self) -> int:
        return len(self.lost)

    # -- the churn process -------------------------------------------------------
    def _draw_epoch(self, epoch: int) -> list[tuple[float, str, int]]:
        """(t_frac, kind, sp_id) events for one epoch — content-addressed
        draws, so the failure set at rate p is a superset of the failure
        set at rate p' < p under the same seed (monotone coupling)."""
        spec = self.churn
        seed = self.contract.epoch_seed(epoch)
        dead = self.contract.dead_sps() | self._crashed
        alive = [i for i in sorted(self.sps)
                 if i not in dead and not self.sps[i].behavior.crashed]
        removals: list[tuple[float, str, int]] = []
        for sp_id in alive:
            rng = placement_mod._rng(seed, b"churn", spec.seed, sp_id)
            u_crash, u_leave, u_slash, u_t = (float(x) for x in rng.random(4))
            if u_crash < spec.p_crash:
                removals.append((u_t, "crash", sp_id))
            elif u_leave < spec.p_leave:
                removals.append((u_t, "announce", sp_id))
            elif u_slash < spec.p_slash:
                removals.append((u_t, "slash", sp_id))
        if spec.min_active is not None:
            allowed = max(0, len(alive) - spec.min_active)
            removals = sorted(removals)[:allowed]
        events = list(removals)
        for j in range(spec.joins_per_epoch):
            rng = placement_mod._rng(seed, b"churn-join", spec.seed, j)
            events.append((float(rng.random()), "join", -1))
        for idx, ev in enumerate(spec.scripted):
            e, kind, sp_id = ev[0], ev[1], ev[2]
            if e != epoch:
                continue
            if len(ev) > 3:
                t_frac = float(ev[3])
            else:
                rng = placement_mod._rng(seed, b"scripted", spec.seed, idx)
                t_frac = float(rng.random())
            events.append((t_frac, kind, sp_id))
        return sorted(events, key=lambda ev: (ev[0], _KIND_RANK[ev[1]], ev[2]))

    def _epochs_task(self, loop: EventLoop):
        for e in range(self.start_epoch, self.start_epoch + self.epochs):
            yield from self._one_epoch(loop, e)

    def _one_epoch(self, loop: EventLoop, epoch: int):
        t0 = loop.now
        stats = EpochStats(epoch=epoch, boundary_ms=t0 + self.epoch_ms)
        for t_frac, kind, sp_id in self._draw_epoch(epoch):
            target = t0 + t_frac * self.epoch_ms
            if target > loop.now:
                yield Sleep(target - loop.now)
            self._apply(loop, epoch, kind, sp_id, stats)
        end = t0 + self.epoch_ms
        if end > loop.now:
            yield Sleep(end - loop.now)
        self._boundary(loop, epoch, stats)
        self.epoch_stats.append(stats)

    def _record(self, loop: EventLoop, epoch: int, kind: str, tag,
                ok: bool = True, nbytes: int = 0) -> None:
        self.records.append(BackgroundRecord(
            kind="member", key=f"e{epoch}/{kind}/{tag}",
            t_ms=loop.now, finish_ms=loop.now, ok=ok, nbytes=nbytes,
        ))

    def _apply(self, loop: EventLoop, epoch: int, kind: str, sp_id: int,
               stats: EpochStats) -> None:
        if kind == "join":
            sp_id = self._admit_joiner(epoch)
            stats.joins += 1
        elif kind == "crash":
            # mid-epoch availability fault; detection is the boundary census
            if sp_id not in self.sps or self.sps[sp_id].behavior.crashed:
                return
            self.sps[sp_id].crash()
            self._crashed.add(sp_id)
            stats.crashes += 1
        elif kind == "announce":
            # graceful intent: the SP keeps serving until the boundary
            if sp_id in self.contract.dead_sps() or sp_id in self._announced:
                return
            self.contract.announce_departure(sp_id)
            self._announced.add(sp_id)
            stats.departures += 1
        elif kind == "slash":
            # protocol violation: full-stake slash ejects NOW; an ejected
            # SP is off the serving set immediately (no boundary grace)
            if sp_id in self.contract.ejected:
                return
            stake = self.contract.stakes.get(sp_id, 0.0)
            self.contract.slash(sp_id, max(stake, 1.0))
            if sp_id in self.sps:
                self.sps[sp_id].crash()
            stats.slashes += 1
        else:  # pragma: no cover - guarded by _KIND_RANK
            raise ValueError(f"unknown membership event kind {kind!r}")
        self.events.append(MembershipEvent(kind, epoch, loop.now, sp_id))
        self._record(loop, epoch, kind, f"sp{sp_id}")

    def _admit_joiner(self, epoch: int) -> int:
        """Register a fresh SP with the contract and wire it into serving
        (backbone node + NIC, fleet payment channels, repair routing)."""
        sp_id = max(self.contract.sps, default=-1) + 1
        rng = placement_mod._rng(
            self.contract.epoch_seed(epoch), b"join-domain", self.churn.seed, sp_id
        )
        dc = f"dc{int(rng.integers(self.num_dcs))}"
        rack = f"r{int(rng.integers(self.racks_per_dc))}"
        self.contract.register_sp(
            SPInfo(sp_id=sp_id, stake=self.churn.join_stake, dc=dc, rack=rack)
        )
        sp = StorageProvider(sp_id, service=self.service_factory())
        self.sps[sp_id] = sp
        node = None
        if self.backbone is not None:
            node = f"sp{sp_id}"
            self.backbone.register_node(node, dc, nic=self.nic)
            if self.nodes is not None:
                self.nodes[sp_id] = node
        if self.fleet is not None:
            self.fleet.admit_sp(sp_id, sp, node)
        self.joined.append(sp_id)
        return sp_id

    # -- epoch boundary: finalize, census, reconfigure, enqueue -------------------
    def _boundary(self, loop: EventLoop, epoch: int, stats: EpochStats) -> None:
        # 1) finalize announced departures (the node powers off) and fold
        #    detected crashes into the departed set — both are permanent
        for sp_id in sorted(self._announced):
            self.contract.finalize_departure(sp_id)
            self.sps[sp_id].decommission()
            self.events.append(MembershipEvent("leave", epoch, loop.now, sp_id))
            self._record(loop, epoch, "leave", f"sp{sp_id}")
        self._announced.clear()
        # fold ANY crashed SP into the departed set (churn-crashed this
        # epoch, or pre-existing faults the census just detected) so the
        # reconfiguration below remaps its placement entries
        for sp_id in sorted(self.sps):
            if (self.sps[sp_id].behavior.crashed
                    and sp_id not in self.contract.dead_sps()):
                self.contract.finalize_departure(sp_id)
        self._crashed.clear()

        # 2) census: COUNT each READY chunkset's live chunk holders; below
        #    k it is lost — permanently (measured durability, not a formula)
        newly_lost = self._census()
        stats.lost_new = newly_lost
        self._record(loop, epoch, "lost", "census", ok=newly_lost == 0,
                     nbytes=newly_lost)

        # 3) reconfigure: remap displaced placement entries to survivors
        #    (bumps placement_version -> serving caches invalidate)
        reassigned = self.contract.reconfigure_epoch(
            epoch, skip_chunksets=self.lost
        )
        stats.reassigned = len(reassigned)
        self.reassigned_total += len(reassigned)
        self._record(loop, epoch, "reconfig", "placement",
                     nbytes=len(reassigned))

        # 4) enqueue the re-dispersal backlog: every non-lost chunk whose
        #    assigned live SP lacks its bytes and is not already in flight
        #    (covers fresh reassignments AND retries of failed repairs),
        #    most-fragile chunksets first so the paced launch schedule
        #    shrinks the window where one more failure loses data
        if self.repair is not None:
            items = self.repair.rc.risk_order(self._redispersal_items())
            handles = self.repair.enqueue(loop, items)
            self._repairing.update(zip(items, handles))
            stats.enqueued = len(items)
            stats.handles = handles
            self._record(loop, epoch, "enqueue", "backlog", nbytes=len(items))

    def _census(self) -> int:
        newly_lost = 0
        for blob_id in sorted(self.contract.blobs):
            meta = self.contract.blobs[blob_id]
            if meta.state is not BlobState.READY:
                continue
            for cs in range(meta.num_chunksets):
                if (blob_id, cs) in self.lost:
                    continue
                alive = 0
                for ck in range(meta.n):
                    sp = self.sps.get(meta.placement.get((cs, ck)))
                    if (sp is not None and not sp.behavior.crashed
                            and sp.has_chunk(blob_id, cs, ck)):
                        alive += 1
                if alive < meta.k:
                    self.lost.add((blob_id, cs))
                    newly_lost += 1
        return newly_lost

    def _redispersal_items(self) -> list[tuple[int, int, int]]:
        items = []
        for blob_id in sorted(self.contract.blobs):
            meta = self.contract.blobs[blob_id]
            if meta.state is not BlobState.READY:
                continue
            for (cs, ck) in sorted(meta.placement):
                if (blob_id, cs) in self.lost:
                    continue
                sp = self.sps.get(meta.placement[(cs, ck)])
                if sp is None or sp.behavior.crashed:
                    continue  # still unplaced (no candidate had room)
                if sp.has_chunk(blob_id, cs, ck):
                    continue
                key = (blob_id, cs, ck)
                h = self._repairing.get(key)
                if h is not None and math.isnan(h.finished_ms):
                    continue  # already racing in the backlog
                items.append(key)
        return items


# ---------------------------------------------------------------------------
# measured durability: lost-chunkset probability vs churn rate
# ---------------------------------------------------------------------------
def measure_durability(
    churn_rates,
    *,
    seeds=(0, 1, 2),
    epochs: int = 3,
    num_sps: int = 10,
    num_blobs: int = 2,
    layout=None,
    epoch_ms: float = 100.0,
    repair: bool = True,
    min_active: int | None = None,
    device=None,
):
    """Measure lost-chunkset probability at each churn rate by COUNTING.

    Builds a tiny direct-transport world per (rate, seed) — contract, SPs,
    dispersed blobs — churns it for `epochs` epochs of crash-rate `rate`
    (with the re-dispersal backlog racing the failures when ``repair``),
    and counts census losses.  Returns one
    :class:`~repro_torch.core.durability.ChurnPoint` per rate, carrying the
    matching analytic no-repair binomial tail for comparison.  ``device``
    places the layout built when none is given (``None``: the card;
    ``"cpu"``: the plain path).
    """
    import numpy as np

    from repro_torch.core import durability
    from repro_torch.storage.blob import BlobLayout
    from repro_torch.storage.rpc import RPCNode

    layout = layout or BlobLayout(k=4, m=2, chunkset_bytes_target=16 * 1024,
                                  device=device)
    points = []
    for rate in churn_rates:
        lost = 0
        chunksets = 0
        for seed in seeds:
            contract = ShelbyContract()
            sps: dict[int, StorageProvider] = {}
            for i in range(num_sps):
                contract.register_sp(
                    SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 2}")
                )
                sps[i] = StorageProvider(i)
            writer = RPCNode(f"writer{seed}", contract, sps, layout)
            rng = np.random.default_rng(seed * 541 + 7)
            from repro_torch.storage.sdk import ShelbyClient

            client = ShelbyClient(contract, writer, deposit=1e9)
            for _ in range(num_blobs):
                data = rng.integers(
                    0, 256, 2 * layout.chunkset_bytes, dtype=np.uint8
                ).tobytes()
                client.put(data)
            rc = (
                RepairCoordinator(contract, sps, layout) if repair else None
            )
            plane = MembershipPlane(
                contract, sps, layout,
                ChurnSpec(p_crash=float(rate), seed=seed, min_active=min_active),
                repair=rc, epochs=epochs, epoch_ms=epoch_ms,
            )
            loop = EventLoop()
            plane.spawn(loop)
            if plane.repair is not None:
                plane.repair.spawn(loop)
            loop.run()
            lost += plane.lost_chunksets
            chunksets += sum(m.num_chunksets for m in contract.blobs.values())  # simlint: ok SIM007 integer chunkset counts, order-exact
        points.append(durability.ChurnPoint(
            churn_rate=float(rate),
            epochs=epochs,
            seeds=len(tuple(seeds)),
            chunksets=chunksets,
            lost=lost,
            analytic_no_repair=1.0 - (
                1.0 - durability.p_chunkset_loss_per_epoch(
                    layout.n, layout.k, float(rate)
                )
            ) ** epochs,
        ))
    return points
