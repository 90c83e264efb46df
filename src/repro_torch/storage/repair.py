"""Repair planner (§3.3 "Flexible Repair Structure" + "Repair Coordination").

Detect-and-repair for lost/corrupted chunks:

* **MSR path** — when all d = n-1 helpers are alive, read only the
  alpha/q repair-plane sub-chunks from each helper (the Clay optimum; the
  coordination layer "allows planning for bandwidth-optimal recoveries").
* **MDS fallback** — "when the optimal repair pattern cannot be followed,
  Shelby can fall back to the MDS property (any k chunks recover data) even
  if it must temporarily sacrifice repair bandwidth efficiency."

Every MDS helper chunk is verified against its on-chain commitment as it
arrives — one corrupt helper among the first k no longer poisons the
decode; the planner simply reads the next candidate (retry with a
different helper subset).  ``repair_all`` records per-chunk failures in
``failures`` instead of aborting the remaining repairs on the first raise.
Detection covers *corrupted-at-rest* data too: ``scan_lost_chunks`` can
spot-check a sampled fraction of live chunks against their commitments
(an audit-shaped cost — reads + hashes — so the scan itself shows up as
background load once it runs on the event loop).

The planner also verifies the repaired chunk against its on-chain root
before re-dispersal (once: an MSR candidate is checked before it is taken), and reports exact helper-bytes-read so the repair
bandwidth benchmark measures the real data path, not a formula.

The byte work runs on the layout's device: an MSR repair is
``ClayCode.repair`` (one host-to-device copy of the helpers' sub-chunks and
one ``gf_matmul``), the MDS fallback ``ClayCode.decode``; the rebuilt chunk
comes back to the host once, for the SHA-256 commitment check and the new
SP's store.

**On the event loop** (the background plane): :meth:`repair_chunk_task`
is the same repair as a generator task — helper reads travel as real
``Transfer``\\ s over the attached :class:`~repro_torch.net.backbone.Backbone`
(request out, sub-chunks/chunks back), each helper read holds one of the
helper SP's disk slots *in the background scheduling class* (capped by the
SP's :class:`~repro_torch.storage.sp.BackgroundSpec` slot share, woken after any
queued paid read), and the re-dispersal write ships the rebuilt chunk to
the new SP and occupies its disk too.  Repair bandwidth therefore shows up
on NIC/trunk counters and can delay — but never starve — paid serving.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core import commitments as cm
from repro_torch.core.contract import ShelbyContract
from repro_torch.net.events import (
    Acquire, EventLoop, Join, Release, Sleep, Transfer, safe_release,
)
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import NACK_BYTES, REQUEST_BYTES
from repro_torch.storage.sp import StorageProvider


class RepairError(Exception):
    pass


@dataclasses.dataclass
class RepairReport:
    blob_id: int
    chunkset: int
    chunk: int
    mode: str  # "msr" | "mds"
    helper_bytes_read: int
    new_sp: int
    verified: bool
    helpers_rejected: int = 0  # helper chunks failing their commitment check
    sim_ms: float = 0.0  # simulated duration when run as an event-loop task


class RepairCoordinator:
    """Plans and executes repairs, synchronously or as event-loop tasks.

    ``nodes`` maps sp_id -> backbone node id (e.g. ``{3: "sp3"}``); when
    given together with a loop whose network is attached, task-based
    repairs move real bytes from ``coordinator_node``.  ``spot_check_rate``
    samples that fraction of *live* chunks per scan for commitment
    verification, catching bit rot that a pure liveness scan misses.
    """

    def __init__(
        self,
        contract: ShelbyContract,
        sps: dict[int, StorageProvider],
        layout: BlobLayout,
        *,
        spot_check_rate: float = 0.0,
        seed: int = 0,
        nodes: dict[int, str] | None = None,
        coordinator_node: str = "repairer",
    ):
        self.contract = contract
        self.sps = sps
        self.layout = layout
        self.nodes = nodes
        self.coordinator_node = coordinator_node
        self.spot_check_rate = spot_check_rate
        self._scan_rng = np.random.default_rng(seed * 6151 + 17)
        self.reports: list[RepairReport] = []
        # per-run_all failure list (reset each call) + cumulative counter —
        # a permanently unrecoverable chunk re-appears every scan, so the
        # list alone would grow duplicates unboundedly
        self.failures: list[tuple[tuple[int, int, int], str]] = []
        self.failures_total = 0
        self.spot_checks = 0  # live chunks sampled for commitment verification
        self.spot_check_bytes = 0

    # -- detection (§2.4 audits / Appendix A "trivial to detect") -----------------
    def scan_lost_chunks(self, *, spot_check_rate: float | None = None
                         ) -> list[tuple[int, int, int]]:
        """Missing/crashed chunks, plus — at ``spot_check_rate`` — live
        chunks whose served bytes fail their on-chain commitment (bit rot
        or a corrupt SP would otherwise never be scheduled for repair)."""
        rate = self.spot_check_rate if spot_check_rate is None else spot_check_rate
        lost = []
        for meta in self.contract.blobs.values():
            for (cs, ck), sp_id in meta.placement.items():
                sp = self.sps.get(sp_id)
                if sp is None or sp.behavior.crashed or not sp.has_chunk(meta.blob_id, cs, ck):
                    lost.append((meta.blob_id, cs, ck))
                    continue
                if rate > 0 and self._scan_rng.random() < rate:
                    self.spot_checks += 1
                    resp = sp.serve_chunk(meta.blob_id, cs, ck)
                    if resp is None:
                        lost.append((meta.blob_id, cs, ck))
                        continue
                    self.spot_check_bytes += resp[0].nbytes
                    commit, _ = cm.commit_chunk(resp[0])
                    if commit.root != meta.chunk_roots[(cs, ck)]:
                        lost.append((meta.blob_id, cs, ck))
        return lost

    # -- shared repair planning ------------------------------------------------------
    def live_holders(self, blob_id: int, chunkset: int) -> int:
        """How many of a chunkset's placed chunks sit on a live SP that
        actually holds the bytes (the boundary-census liveness count)."""
        meta = self.contract.blobs[blob_id]
        alive = 0
        for ck in range(meta.n):
            sp = self.sps.get(meta.placement.get((chunkset, ck)))
            if (sp is not None and not sp.behavior.crashed
                    and sp.has_chunk(blob_id, chunkset, ck)):
                alive += 1
        return alive

    def risk_order(self, items: list[tuple[int, int, int]]
                   ) -> list[tuple[int, int, int]]:
        """Most-fragile-first ordering for a repair backlog: chunks of
        chunksets with the fewest live holders launch first — a chunkset
        sitting at exactly k is one failure away from data loss, so it
        must not wait behind comfortable re-dispersals (Appendix A
        recovery priority).  Ties break on ids, keeping the paced launch
        schedule — and the determinism digest — reproducible."""
        return sorted(
            items, key=lambda it: (self.live_holders(it[0], it[1]),) + it
        )

    def _alive_helpers(self, meta, blob_id: int, chunkset: int, chunk: int
                       ) -> dict[int, StorageProvider]:
        helpers = {}
        for ck in range(self.layout.n):
            if ck == chunk:
                continue
            sp = self.sps.get(meta.placement[(chunkset, ck)])
            if sp is not None and not sp.behavior.crashed and sp.has_chunk(blob_id, chunkset, ck):
                helpers[ck] = sp
        return helpers

    def _verify_chunk(self, meta, chunkset: int, ck: int, data) -> bool:
        commit, _ = cm.commit_chunk(data)
        return commit.root == meta.chunk_roots[(chunkset, ck)]

    def _place(self, meta, blob_id: int, chunkset: int, chunk: int) -> int:
        """Pick where the rebuilt chunk lives (restore in place when the
        original SP merely lost it; otherwise contract randomness)."""
        old_sp = meta.placement[(chunkset, chunk)]
        old = self.sps.get(old_sp)
        if (old is not None and not old.behavior.crashed
                and not old.has_chunk(blob_id, chunkset, chunk)):
            return old_sp  # same SP lost one chunk: restore in place
        return self.contract.reassign_chunk(blob_id, chunkset, chunk)

    # -- synchronous repair ---------------------------------------------------------
    def repair_chunk(self, blob_id: int, chunkset: int, chunk: int) -> RepairReport:
        """Synchronous wrapper: run :meth:`repair_chunk_task` on a private
        event loop — ONE implementation of the MSR-first/MDS-fallback plan.
        The private loop has no network attached, so no transfers are
        modelled (byte movement needs a shared loop with a Backbone); the
        helper-bytes accounting is identical either way."""
        loop = EventLoop()
        h = loop.spawn(
            self.repair_chunk_task(loop, blob_id, chunkset, chunk),
            label=f"repair/b{blob_id}/c{chunkset}/k{chunk}",
        )
        return loop.run_until(h)

    def repair_all(self) -> list[RepairReport]:
        """Repair every lost chunk; an unrecoverable chunk is recorded in
        ``failures`` (this call's list — check it after every sweep) instead
        of aborting the remaining repairs on the first raise."""
        reports = []
        self.failures = []
        for lost in self.scan_lost_chunks():
            try:
                reports.append(self.repair_chunk(*lost))
            except RepairError as e:
                self.failures.append((lost, str(e)))
                self.failures_total += 1
        return reports

    # -- event-loop repair (the background plane) ------------------------------------
    def _node_of(self, sp_id: int) -> str | None:
        return self.nodes.get(sp_id) if self.nodes is not None else None

    def _helper_read_task(self, loop: EventLoop, sp_id: int, ck: int,
                          blob_id: int, chunkset: int, sub_ids=None):
        """One background helper read: request over the backbone, a disk
        slot in the background class (under the SP's slot-share budget),
        then the payload back over the helper's NIC and the trunks."""
        sp = self.sps[sp_id]
        node = self._node_of(sp_id)
        networked = node is not None and loop.network is not None
        if networked:
            yield Transfer(self.coordinator_node, node, REQUEST_BYTES)
        if sub_ids is not None:
            resp = sp.serve_subchunks(blob_id, chunkset, ck, sub_ids)
        else:
            resp = sp.serve_chunk(blob_id, chunkset, ck)
        if resp is None:
            if networked:
                yield Transfer(node, self.coordinator_node, NACK_BYTES)
            return None
        data, _ = resp
        prio = sp.service.background.priority
        yield Acquire(("sp", sp_id), sp.service.slots, priority=prio,
                      limit=sp.bg_slots())
        try:
            yield Sleep(sp.service_ms())
        finally:
            yield from safe_release(Release(("sp", sp_id), priority=prio))
        if networked:
            yield Transfer(node, self.coordinator_node, data.nbytes)
        return data

    def repair_chunk_task(self, loop: EventLoop, blob_id: int, chunkset: int,
                          chunk: int, label: str = "repair"):
        """Task: the same MSR-first/MDS-fallback repair, with helper reads
        as concurrent background tasks moving real bytes.  Returns the
        :class:`RepairReport`; raises :class:`RepairError` when the chunk
        is unrecoverable (callers — e.g. ``RepairPlane`` — record it)."""
        meta = self.contract.blobs[blob_id]
        lay = self.layout
        code = lay.code
        t0 = loop.now
        helpers_alive = self._alive_helpers(meta, blob_id, chunkset, chunk)

        bytes_read = 0
        rejected = 0
        repaired = None
        mode = ""
        if len(helpers_alive) == lay.n - 1:
            ids = code.repair_subchunk_ids(chunk)
            handles = [
                (ck, loop.spawn(
                    self._helper_read_task(loop, sp.sp_id, ck, blob_id,
                                           chunkset, sub_ids=ids),
                    label=f"{label}/msr{ck}"))
                for ck, sp in sorted(helpers_alive.items())
            ]
            subs: dict[int, object] = {}
            vanished = False
            for ck, h in handles:  # harvest every leg before deciding —
                data = yield Join(h)  # delivered bytes count even when the
                if data is None:  # MSR plan dies (they crossed the links)
                    vanished = True
                else:
                    subs[ck] = data
                    bytes_read += data.nbytes
            if not vanished:
                # rebuilt on the layout's device; back to the host once, for
                # the commitment check and the SP's store
                candidate = code.repair(chunk, subs).cpu().numpy()
                if self._verify_chunk(meta, chunkset, chunk, candidate):
                    repaired, mode = candidate, "msr"

        if repaired is None:
            if len(helpers_alive) < lay.k:
                raise RepairError(
                    f"unrecoverable: {len(helpers_alive)} helpers < k={lay.k} "
                    f"for chunk ({blob_id},{chunkset},{chunk})"
                )
            # MDS fallback in waves: k concurrent verified reads, replacing
            # rejected/missing helpers from the remaining candidates
            remaining = deque(sorted(helpers_alive))
            shards: dict[int, object] = {}
            while len(shards) < lay.k and remaining:
                wave = []
                while remaining and len(shards) + len(wave) < lay.k:
                    wave.append(remaining.popleft())
                handles = [
                    (ck, loop.spawn(
                        self._helper_read_task(loop, helpers_alive[ck].sp_id,
                                               ck, blob_id, chunkset),
                        label=f"{label}/mds{ck}"))
                    for ck in wave
                ]
                for ck, h in handles:
                    data = yield Join(h)
                    if data is None:
                        continue
                    bytes_read += data.nbytes
                    if not self._verify_chunk(meta, chunkset, ck, data):
                        rejected += 1
                        continue
                    shards[ck] = data
            if len(shards) < lay.k:
                raise RepairError(
                    f"unrecoverable: only {len(shards)} verified helpers < "
                    f"k={lay.k} for chunk ({blob_id},{chunkset},{chunk}) "
                    f"({rejected} rejected by commitment check)"
                )
            repaired, mode = code.decode(shards)[chunk].cpu().numpy(), "mds"

        # an MSR chunk was verified as the candidate above: hash it once
        if mode == "mds" and not self._verify_chunk(meta, chunkset, chunk, repaired):
            raise RepairError("repaired chunk fails commitment check")
        new_sp = self._place(meta, blob_id, chunkset, chunk)
        # re-dispersal: ship the rebuilt chunk and occupy the new SP's disk
        # for the write — still background class
        dst_sp = self.sps[new_sp]
        dst_node = self._node_of(new_sp)
        if dst_node is not None and loop.network is not None:
            yield Transfer(self.coordinator_node, dst_node, int(repaired.nbytes))
        prio = dst_sp.service.background.priority
        yield Acquire(("sp", new_sp), dst_sp.service.slots, priority=prio,
                      limit=dst_sp.bg_slots())
        try:
            yield Sleep(dst_sp.service_ms())
        finally:
            yield from safe_release(Release(("sp", new_sp), priority=prio))
        dst_sp.store_chunk(blob_id, chunkset, chunk, repaired)

        report = RepairReport(blob_id, chunkset, chunk, mode, bytes_read,
                              new_sp, True, helpers_rejected=rejected,
                              sim_ms=loop.now - t0)
        self.reports.append(report)
        return report
