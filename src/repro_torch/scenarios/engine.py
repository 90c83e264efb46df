"""The engine scale ramp as a registry entry: million-request worlds.

A 500-SP / 50-RPC world serves a Zipf read storm at three sizes —
10k -> 100k -> 1M requests — through the cohort fast path
(``repro_torch.net.fastpath``): warm-cache cohorts advance as numpy array steps,
cold-key first touchers de-opt to full generator tasks on the calendar-queue
event loop, and settlement debits each serving node's channel once per
cohort.  Three regression-shaped bars:

* **Determinism** (inline assert — structural): two fast replays of the
  same 10k batch on fresh fleets produce byte-identical digests, AND the
  digest equals a task-per-request replay of the identical schedule on
  the binary-heap baseline engine.
* **Throughput** (declared SLO): at the 100k rung the fast path clears
  >= 10x the heap-baseline engine events/sec.
* **Scale**: the 1M-request rung completes inside the scenario's CI
  budget (enforced by the smoke loop's wall clock, not an assert).

The world's layout lives on ``ctx.device``: the 192 puts encode and the
cold-key leaders' reads decode there (``gf_matmul`` on the card).

This scenario ignores the smoke flag — the ramp IS the point, and the
``engine`` BENCH section's schema must not change shape under CI.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.net.backbone import Backbone
from repro_torch.net.fleet import RPCFleet
from repro_torch.net.workloads import replay_open_loop, zipf_hotset_batch
from repro_torch.scenarios.registry import SLO, register
from repro_torch.scenarios.report import row
from repro_torch.scenarios.runner import ScenarioContext
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import BackboneTransport, RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import ServiceSpec, StorageProvider

NUM_SPS = 500
NUM_RPCS = 50
NUM_BLOBS = 192  # single-chunkset blobs: every read is exactly one leg
RAMP = (10_000, 100_000, 1_000_000)
CACHE_CHUNKSETS = 16  # x50 nodes: the whole key set fits, no eviction


def _world(device=None):
    """The world on ``device`` (``None``: the card): its 192 puts encode
    there and the de-opted reads decode there."""
    layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024,
                        device=device)
    contract = ShelbyContract()
    bb = Backbone.mesh(5, base_latency_ms=6.0, gbps=25.0)
    rng = np.random.default_rng(99)
    sps = {}
    for i in range(NUM_SPS):
        dc = f"dc{i % 5}"
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=dc,
                                    rack=f"r{i % 20}"))
        sps[i] = StorageProvider(i, service=ServiceSpec(disk_ms_per_chunk=0.5,
                                                        slots=4))
        sps[i].behavior.latency_ms = float(rng.uniform(1.0, 8.0))
        bb.register_node(f"sp{i}", dc)
    for c in range(3):
        bb.register_node(f"client{c}", f"dc{c}")
    bb.register_node("writer", "dc0")
    writer = RPCNode("writer", contract, sps, layout)
    put_client = ShelbyClient(contract, writer, deposit=1e9)
    metas = []
    for _ in range(NUM_BLOBS):
        # <= one chunkset of payload each, so offset 0 + whole-blob reads
        # never span chunksets (the fast path's exact-equality regime)
        data = rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
        metas.append(put_client.put(data))
    return layout, contract, bb, sps, metas


def _fleet(cfg, layout, contract, bb, sps):
    rpcs = []
    for r in range(NUM_RPCS):
        node = f"rpc{r}"
        if node not in bb._node_dc:
            bb.register_node(node, f"dc{r % 5}")
        rpcs.append(RPCNode(node, contract, sps, layout,
                            cache_chunksets=CACHE_CHUNKSETS,
                            transport=BackboneTransport(sps, bb, node)))
    bb.reset_accounting()
    return RPCFleet(rpcs, cfg.policy(), backbone=bb)


def _batch(metas, n):
    return zipf_hotset_batch(
        metas, clients=["client0", "client1", "client2"], num_requests=n,
        read_bytes=64 * 1024, interarrival_ms=0.05, seed=23, arrival="poisson",
    )


def run_engine(ctx: ScenarioContext) -> dict:
    cfg = ctx.config
    t0 = time.perf_counter()
    layout, contract, bb, sps, metas = _world(ctx.device)
    print(f"# world: {NUM_SPS} SPs / {NUM_RPCS} RPCs / {NUM_BLOBS} blobs "
          f"({time.perf_counter() - t0:.1f}s to build)")

    ramp_json = {}
    speedup_100k = None
    digest_10k = None

    for n in RAMP:
        batch = _batch(metas, n)

        # -- fast path through the paid session (batched settlement) --------
        fleet = _fleet(cfg, layout, contract, bb, sps)
        reader = ShelbyClient(contract, fleet, deposit=1e9)
        wall0 = time.perf_counter()
        with reader.session(deposit_per_node=1e6) as session:
            rb, fast = session.replay(batch)
        wall_fast = time.perf_counter() - wall0
        settlement = session.settlement
        co = fast.cohort
        assert co.fallback_reason is None, (
            f"fast path fell back at {n}: {co.fallback_reason}"
        )
        # conservation on arrays: the cohort's one-debit-per-node totals +
        # de-opted per-request receipts == realized node income
        assert abs(settlement.total_node_income
                   - (rb.total_paid
                      + sum(r.total_paid for r in session.receipts))) < 1e-6

        entry = {
            "requests": n,
            "wall_s": wall_fast,
            "engine_events": fast.engine_events,
            "engine_wall_s": fast.engine_wall_s,
            "events_per_sec": fast.engine_events_per_sec,
            "requests_per_sec": n / wall_fast,
            "vec_requests": co.vec_requests,
            "deopt_requests": co.deopt_requests,
            "coalesced_legs": co.coalesced,
            "p50_ms": fast.percentile(50.0),
            "p99_ms": fast.percentile(99.0),
            "goodput_mbps": fast.goodput_mbps,
        }
        row(
            f"engine_scale/fast_{n}",
            wall_fast * 1e6 / n,
            f"events_per_sec={fast.engine_events_per_sec:.0f};"
            f"vec={co.vec_requests};deopt={co.deopt_requests};"
            f"p99={entry['p99_ms']:.1f}ms",
        )

        if n <= 100_000:
            # -- heap-engine task-per-request baseline on a fresh fleet ------
            fleet_h = _fleet(cfg, layout, contract, bb, sps)
            reqs = batch.to_requests()
            wall0 = time.perf_counter()
            base = replay_open_loop(fleet_h, reqs, engine="heap")
            wall_heap = time.perf_counter() - wall0
            entry["heap_baseline"] = {
                "wall_s": wall_heap,
                "engine_events": base.engine_events,
                "events_per_sec": base.engine_events_per_sec,
                "requests_per_sec": n / wall_heap,
            }
            row(
                f"engine_scale/heap_{n}",
                wall_heap * 1e6 / n,
                f"events_per_sec={base.engine_events_per_sec:.0f}",
            )
            if n == 10_000:
                # exact digest equality: fast cohort vs heap task engine,
                # plus fast-path determinism on a third fresh fleet
                assert fast.digest() == base.digest(), (
                    f"fast/task digest mismatch at {n}: "
                    f"{fast.digest()[:16]} != {base.digest()[:16]}"
                )
                from repro_torch.net.fastpath import replay_open_loop_fast

                redo = replay_open_loop_fast(
                    _fleet(cfg, layout, contract, bb, sps), batch)
                assert redo.digest() == fast.digest(), "fast path not deterministic"
                digest_10k = fast.digest()
                print(f"# engine digest (fast == heap task): "
                      f"{digest_10k[:16]} OK")
            if n == 100_000:
                speedup_100k = (fast.engine_events_per_sec
                                / base.engine_events_per_sec)
                print(f"# engine speedup at 100k: {speedup_100k:.1f}x "
                      f"({fast.engine_events_per_sec:.0f} vs "
                      f"{base.engine_events_per_sec:.0f} events/s)")
        ramp_json[f"{n}"] = entry

    return {
        "world": {"sps": NUM_SPS, "rpcs": NUM_RPCS, "blobs": NUM_BLOBS,
                  "cache_chunksets": CACHE_CHUNKSETS},
        "ramp": ramp_json,
        "digest_10k": digest_10k[:16],
        "speedup_events_per_sec_100k": speedup_100k,
    }


register(
    name="engine",
    description=("Event-engine scale ramp: 500 SPs / 50 RPCs, Zipf batch "
                 "at 10k/100k/1M requests through the cohort fast path vs "
                 "the heap task-per-request baseline"),
    workload="zipf_hotset_batch, poisson arrivals, 3-size ramp (never shrunk)",
    section="engine",
    run=run_engine,
    slos=(
        SLO("speedup_events_per_sec_100k", ">=", 10.0,
            description="the cohort fast path clears >=10x the heap "
                        "baseline's events/sec at the 100k rung"),
    ),
    tunable=("event_engine",),
    headline=("speedup_events_per_sec_100k", "ramp.1000000.requests_per_sec",
              "ramp.1000000.wall_s"),
    budget_s=420,
)
