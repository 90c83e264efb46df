"""Cohort fast path: advance homogeneous request batches in vectorized steps.

A million-request replay spends most of its time doing the SAME thing a
million times: route a (blob, chunkset) key, probe a warm cache, charge two
propagation legs, record a latency.  The task-per-request engine pays full
generator machinery for every one of them.  This module recognises the
*cohort* — requests whose fate is decided by arithmetic alone — and advances
it through routing, cache accounting and latency bookkeeping as numpy array
operations, while any request that *individuates* (a cold-key first toucher
that must actually fetch, hedge, queue on SP disk slots and maybe NACK)
de-opts to a full :func:`repro_torch.net.workloads._serve_one` generator task on a
real :class:`~repro_torch.net.events.EventLoop`.  The de-opted cold-key
leaders fetch and Clay-decode through the ordinary read path, so their
decodes run on the layout's device (``gf_matmul`` on the card); the cohort
arithmetic stays numpy on the host, in the JAX package's order of
operations, because the digest and the settled floats are compared with
``==``.

Semantics contract (matched float-for-float against task mode):

* warm-cache hit  -> latency ``0.0 + 2*prop`` — identical ops to
  ``serve_ranges_task``'s ``max(0.0, s.latency_ms + extra_ms)``;
* coalesced probe (arrives while the leader's fetch is in flight) ->
  latency ``(put_t - probe_t) + 2*prop`` where ``put_t`` comes from the
  node's ``cache_put_log`` — for single-chunkset leaders the put lands at
  exactly the flight's ``finished_ms``, which is what a real single-flight
  waiter observes, so the digest is bit-identical;
* cold first toucher (per probe-time order ``(probe_t, arrival, index)``,
  mirroring the heap's push-order tie-break) -> de-opt: a real task that
  routes, fetches, hedges and pays through the ordinary machinery.

Documented deviations from task mode (why exact-equality tests pin
single-chunkset worlds):

* a MULTI-chunkset leader decodes all its keys only after its last flight
  lands, so a probe falling in the gap between one key's flight finish and
  the leader's decode would duplicate-fetch in task mode; the fast path
  resumes such probes at ``put_t`` instead (strictly less work, slightly
  later);
* an exact float tie ``probe_t == put_t`` classifies as a hit (task mode's
  outcome depends on event seq order); latency is identical either way,
  only the per-node hit/coalesce counter attribution can differ;
* vectorized requests do not update the fleet latency EWMA
  (``_observe``) or the cache's LRU recency order — both unobservable
  under a static policy with the no-eviction guard below.

When the world is NOT cohort-safe — a stateful routing policy, admission
control, cache TTLs, admission-by-size, single-flight disabled, or enough
distinct keys that LRU eviction becomes possible — the whole batch falls
back to :func:`repro_torch.net.workloads.replay_open_loop` and the reason is
recorded on ``ReplayResult.cohort.fallback_reason``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.net.events import ENGINE_COUNTERS, EventLoop
from repro_torch.net.workloads import (
    RecordBatch,
    ReplayResult,
    RequestBatch,
    _serve_one,
    replay_open_loop,
)


@dataclasses.dataclass
class CohortStats:
    """How a batch split between the vectorized cohort and real tasks.

    The per-leg arrays cover ONLY vectorized legs (de-opted requests route
    and pay through the ordinary task machinery); payment batching in
    ``storage/sdk.py`` consumes them to settle whole cohorts with one
    channel debit per node."""

    vec_requests: int = 0
    deopt_requests: int = 0
    hits: int = 0  # vectorized legs served from warm cache
    coalesced: int = 0  # vectorized legs that rode an in-flight fetch
    fallback_reason: str | None = None
    # vectorized-leg attribution: request index, serving node index, and the
    # request's total leg count (payment pro-rata denominator)
    leg_req: np.ndarray | None = None
    leg_node: np.ndarray | None = None
    leg_total: np.ndarray | None = None
    # vectorized request rows (indices into the batch) and their sizes
    vec_req_idx: np.ndarray | None = None
    vec_nbytes: np.ndarray | None = None
    node_ids: list[str] | None = None


def fastpath_fallback_reason(fleet, batch: RequestBatch | None = None) -> str | None:
    """World-level checks: None when the cohort fast path preserves task
    semantics, else a human-readable reason to replay request-per-task."""
    if not getattr(fleet.policy, "static", False):
        return "routing policy is stateful (depends on live fleet load)"
    for nid, node in zip(fleet.node_ids, fleet.rpcs):
        if node.admission is not None:
            return f"admission control attached ({nid})"
        if node.cache_ttl_ms is not None:
            return f"cache TTL attached ({nid})"
        if node.cache_admit_bytes is not None:
            return f"cache admission filter attached ({nid})"
        if not node.single_flight:
            return f"single-flight disabled ({nid})"
        if node._cache_size <= 0:
            return f"cache disabled ({nid})"
    if batch is not None and len(batch) and int(batch.length.min()) <= 0:
        return "zero-length read in batch"
    return None


def _fallback(fleet, batch, reason, *, engine, on_served, on_shed, trace):
    result = replay_open_loop(
        fleet, batch.to_requests(), engine=engine,
        on_served=on_served, on_shed=on_shed, trace=trace,
    )
    result.cohort = CohortStats(
        deopt_requests=len(batch), fallback_reason=reason,
        node_ids=list(fleet.node_ids),
    )
    return result


def replay_open_loop_fast(
    fleet,
    batch: RequestBatch,
    *,
    engine: str | None = None,
    on_served=None,  # (index, request, ServedRange) — de-opted requests only
    on_shed=None,
    trace: bool = False,
) -> ReplayResult:
    """Open-loop replay of a :class:`RequestBatch` through the cohort fast
    path; drop-in for ``replay_open_loop(fleet, batch.to_requests())`` on
    cohort-safe worlds (same records, digest, counters and payments), with
    per-request cost paid only by the requests that individuate.

    Rows land in ``ReplayResult.batch`` (``records`` stays empty);
    ``ReplayResult.cohort`` carries the split plus the per-leg (request,
    node) attribution that batched settlement consumes.
    """
    t_wall0 = time.perf_counter()  # simlint: ok SIM001 engine wall telemetry only
    n = len(batch)
    reason = fastpath_fallback_reason(fleet, batch)
    if reason is not None or n == 0:
        return _fallback(fleet, batch, reason or "empty batch", engine=engine,
                         on_served=on_served, on_shed=on_shed, trace=trace)

    lay = fleet.primary.layout
    csb = lay.chunkset_bytes
    t = batch.t_ms
    ln = batch.length

    # -- leg expansion: one leg per (request, chunkset) --------------------------
    first = batch.offset // csb
    last = (batch.offset + ln - 1) // csb
    nlegs = last - first + 1
    total = int(nlegs.sum())
    req_of_leg = np.repeat(np.arange(n, dtype=np.int64), nlegs)
    starts = np.cumsum(nlegs) - nlegs
    leg_cs = first[req_of_leg] + (np.arange(total, dtype=np.int64) - starts[req_of_leg])
    leg_blob = batch.blob_id[req_of_leg]

    # -- distinct keys, routed once each (the policy is static) ------------------
    stride = int(leg_cs.max()) + 1
    codes, inv = np.unique(leg_blob * stride + leg_cs, return_inverse=True)
    ub, uc = codes // stride, codes % stride
    policy = fleet.policy
    node_of_key = np.fromiter(
        (policy.pick((int(b), int(c)), None, fleet) for b, c in zip(ub, uc)),
        dtype=np.int64, count=len(codes),
    )

    # -- warm/cold scan + no-eviction guard --------------------------------------
    # A warm entry must also survive a version check (epoch reconfiguration
    # invalidates cached decodes); stale entries are deleted exactly as the
    # first task-mode probe would.  The guard then requires every node's
    # (surviving ∪ newly-routed) key set to fit its cache, so no LRU
    # eviction can occur mid-batch — the precondition for classifying hits
    # without replaying the recency order.
    nkeys = len(codes)
    warm = np.zeros(nkeys, dtype=bool)
    stale: list[tuple[object, tuple[int, int]]] = []
    routed_keys: list[set] = [set() for _ in fleet.rpcs]
    surviving: list[set] = [set(node._cache.keys()) for node in fleet.rpcs]
    for j in range(nkeys):
        i = int(node_of_key[j])
        node = fleet.rpcs[i]
        key = (int(ub[j]), int(uc[j]))
        routed_keys[i].add(key)
        entry = node._cache.get(key)
        if entry is None:
            continue
        _, expires, version = entry
        if expires is not None:
            return _fallback(fleet, batch, f"TTL-stamped cache entry ({fleet.node_ids[i]})",
                             engine=engine, on_served=on_served, on_shed=on_shed,
                             trace=trace)
        if version != node.contract.placement_version.get(key, 0):
            stale.append((node, key))
            surviving[i].discard(key)
        else:
            warm[j] = True
    for i, node in enumerate(fleet.rpcs):
        if len(surviving[i] | routed_keys[i]) > node._cache_size:
            return _fallback(fleet, batch,
                             f"cache eviction possible ({fleet.node_ids[i]})",
                             engine=engine, on_served=on_served, on_shed=on_shed,
                             trace=trace)
    for node, key in stale:  # committed to the fast path: apply the drops
        del node._cache[key]

    # -- probe times + cold-key leader election ----------------------------------
    bb = fleet.backbone
    if bb is None:
        prop_tab = np.zeros((len(batch.clients), len(fleet.rpcs)))
    else:
        prop_tab = np.array([
            [float(bb.propagation_ms(c, nid)) for nid in fleet.node_ids]
            for c in batch.clients
        ])
    leg_node = node_of_key[inv]
    leg_prop = prop_tab[batch.client_idx[req_of_leg], leg_node]
    leg_t = t[req_of_leg]
    probe_t = leg_t + leg_prop

    # the task-mode leader of a cold key is whichever probe event pops
    # first: earliest probe time, ties broken by push order = arrival time,
    # then spawn (request index) order
    order = np.lexsort((req_of_leg, leg_t, probe_t, inv))
    sorted_inv = inv[order]
    grp_first = np.ones(total, dtype=bool)
    grp_first[1:] = sorted_inv[1:] != sorted_inv[:-1]
    leader_leg = np.zeros(total, dtype=bool)
    leader_leg[order[grp_first]] = True
    leader_leg &= ~warm[inv]
    deopt = np.zeros(n, dtype=bool)
    deopt[req_of_leg[leader_leg]] = True

    # -- de-opted requests run as real tasks, puts instrumented ------------------
    loop = EventLoop(network=fleet.network, trace=trace, engine=engine)
    records: list = [None] * n
    for node in fleet.rpcs:
        node.cache_put_log = {}
    try:
        for i in np.flatnonzero(deopt).tolist():
            req = batch.request(i)
            loop.spawn(
                _serve_one(loop, fleet, records, i, req, f"req{i}",
                           on_served, on_shed),
                at_ms=req.t_ms, label=f"req{i}",
            )
        loop.run()
        put_logs = [node.cache_put_log for node in fleet.rpcs]
    finally:
        for node in fleet.rpcs:
            node.cache_put_log = None

    put_t_key = np.full(nkeys, np.nan)
    for j in np.flatnonzero(~warm).tolist():
        pt = put_logs[int(node_of_key[j])].get((int(ub[j]), int(uc[j])))
        if pt is not None:
            put_t_key[j] = pt

    # -- vectorized classification: hit vs coalesced -----------------------------
    vec_leg = ~deopt[req_of_leg]
    leg_cold = ~warm[inv]
    unservable = vec_leg & leg_cold & ~np.isfinite(put_t_key)[inv]
    if unservable.any():
        # the leader's fetch never produced a decode (ReadError under heavy
        # failures): its followers' fates need real error propagation, which
        # arrays cannot reproduce — this world must replay request-per-task
        raise RuntimeError(
            "cohort fast path: a cold key's leader fetch failed with "
            "vectorized followers attached; replay this world with "
            "replay_open_loop (fleet state has already advanced)"
        )
    leg_put = put_t_key[inv]
    coal = vec_leg & leg_cold & (probe_t < leg_put)
    s_lat = np.zeros(total)
    s_lat[coal] = leg_put[coal] - probe_t[coal]
    contrib = s_lat + 2.0 * leg_prop
    contrib[~vec_leg] = 0.0
    lat_all = np.maximum.reduceat(contrib, starts) if total else np.zeros(0)

    # -- fold the cohort into fleet/node accounting ------------------------------
    vec_req = ~deopt
    n_nodes = len(fleet.rpcs)
    routed_cnt = np.bincount(leg_node[vec_leg], minlength=n_nodes)
    hit_leg = vec_leg & ~coal
    hits_cnt = np.bincount(leg_node[hit_leg], minlength=n_nodes)
    coal_cnt = np.bincount(leg_node[coal], minlength=n_nodes)
    for i, node in enumerate(fleet.rpcs):
        fleet.routed[i] += int(routed_cnt[i])
        node.stats.cache_hits += int(hits_cnt[i])
        node.stats.coalesced += int(coal_cnt[i])
    n_vec_legs = int(vec_leg.sum())
    fleet.chunkset_reads += n_vec_legs
    fleet.bytes_served += int(ln[vec_req].sum())
    fleet.request_latencies_ms.extend(lat_all[vec_req].tolist())

    # -- assemble the pooled record rows -----------------------------------------
    t_arr = t.astype(np.float64, copy=True)
    finish = np.empty(n)
    lat = np.empty(n)
    nbytes = np.empty(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    shed_arr = np.zeros(n, dtype=bool)
    finish[vec_req] = t[vec_req] + lat_all[vec_req]
    lat[vec_req] = lat_all[vec_req]
    nbytes[vec_req] = ln[vec_req]
    for i in np.flatnonzero(deopt).tolist():
        r = records[i]
        t_arr[i], finish[i], lat[i] = r.t_ms, r.finish_ms, r.latency_ms
        nbytes[i], ok[i], shed_arr[i] = r.nbytes, r.ok, r.shed
    rows = RecordBatch(
        index=np.arange(n, dtype=np.int64), t_ms=t_arr, finish_ms=finish,
        latency_ms=lat, nbytes=nbytes, ok=ok, shed=shed_arr,
        client_idx=batch.client_idx.astype(np.int64, copy=True),
        blob_id=batch.blob_id.astype(np.int64, copy=True),
        clients=list(batch.clients),
    )

    vlegs = np.flatnonzero(vec_leg)
    n_vec = int(vec_req.sum())
    cohort = CohortStats(
        vec_requests=n_vec, deopt_requests=n - n_vec,
        hits=int(hit_leg.sum()), coalesced=int(coal.sum()),
        leg_req=req_of_leg[vlegs], leg_node=leg_node[vlegs],
        leg_total=nlegs[req_of_leg[vlegs]],
        vec_req_idx=np.flatnonzero(vec_req), vec_nbytes=ln[vec_req].copy(),
        node_ids=list(fleet.node_ids),
    )

    span = float(finish.max() - t_arr.min()) if n else 0.0
    link = dict(fleet.network.link_bytes) if fleet.network is not None else {}
    # a vectorized completion counts as one engine event: the batch retired
    # n_vec requests that task mode would each have popped several events for
    elapsed = time.perf_counter() - t_wall0  # simlint: ok SIM001 engine wall telemetry only
    ENGINE_COUNTERS["events"] += n_vec
    ENGINE_COUNTERS["wall_s"] += elapsed - loop.wall_s
    return ReplayResult(
        records=[], span_ms=span, link_bytes=link, trace=loop.trace,
        background=[], engine_events=loop.events_processed + n_vec,
        engine_wall_s=elapsed, batch=rows, cohort=cohort,
    )
