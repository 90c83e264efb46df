"""Multi-RPC CDN demo on the port: a fleet serving Zipf-hot content over the backbone.

Three datacenters, one RPC node in each with its own decoded hot-cache,
twelve SPs, Zipf-popular traffic from clients in all three regions.
Cache-affinity routing (rendezvous hashing) gives every chunkset one home
node, so the fleet's caches compose instead of duplicating — the §5.3
hot-cache story at fleet scale, with a straggler and a dead SP thrown in.
The program of ``examples/multi_rpc_cdn.py`` on ``repro_torch``: every
node's batched Clay decode runs ``gf_matmul`` on ``--device``.

    PYTHONPATH=src python examples/torch/multi_rpc_cdn.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.device import resolve_device
from repro_torch.net.backbone import Backbone
from repro_torch.net.fleet import CacheAffinityPolicy, RPCFleet
from repro_torch.net.workloads import zipf_hotset
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import BackboneTransport, RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import StorageProvider

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, device=device)
contract = ShelbyContract()
backbone = Backbone.mesh(3, base_latency_ms=6.0, gbps=25.0)
rng = np.random.default_rng(7)

sps = {}
for i in range(12):
    dc = f"dc{i % 3}"
    contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 4}"))
    sps[i] = StorageProvider(i)
    sps[i].behavior.latency_ms = float(rng.uniform(1.0, 10.0))
    backbone.register_node(f"sp{i}", dc)
for c in range(3):
    backbone.register_node(f"client{c}", f"dc{c}")

rpcs = []
for r in range(3):
    node = f"rpc{r}"
    backbone.register_node(node, f"dc{r}")
    rpcs.append(RPCNode(node, contract, sps, layout, cache_chunksets=16,
                        transport=BackboneTransport(sps, backbone, node)))
fleet = RPCFleet(rpcs, CacheAffinityPolicy(), backbone=backbone)

print("uploading a hot content library (8 objects)...")
client = ShelbyClient(contract, fleet, deposit=1e9)  # fleet-first client
blobs = {}
metas = []
for b in range(8):
    data = rng.integers(0, 256, 4 * layout.chunkset_bytes, dtype=np.uint8).tobytes()
    meta = client.put(data)
    blobs[meta.blob_id] = data
    metas.append(meta)

# adversity after the write phase: one straggler, one dead SP
sps[2].behavior.latency_ms = 250.0
sps[5].crash()

print("serving 300 Zipf-distributed requests from 3 regions...")
reqs = zipf_hotset(metas, clients=["client0", "client1", "client2"],
                   num_requests=300, seed=11)
with client.session() as session:
    for req in reqs:
        receipt = session.read(req.blob_id, req.offset, req.length,
                               client=req.client, t_ms=req.t_ms)
        expect = blobs[req.blob_id][req.offset : req.offset + req.length]
        assert receipt.data == expect, "served bytes must match stored content"
settlement = session.settlement

p50, p99 = fleet.latency_percentiles(50.0, 99.0)
print(f"cache hit rate: {fleet.cache_hit_rate():.0%} "
      f"(per-node hits: {[r.stats.cache_hits for r in rpcs]})")
print(f"simulated latency: p50={p50:.1f} ms, p99={p99:.1f} ms "
      f"(straggler at 250 ms never gates a read)")
print(f"hedged requests wasted: {fleet.hedged_wasted()}; "
      f"routed per node: {fleet.routed}")
print("settled per-node serving income: "
      + ", ".join(f"{nid}=${amt:.9f}" for nid, amt in sorted(settlement.node_income.items())))
print(f"RPC->SP income realized at settlement: "
      f"${sum(settlement.sp_income.values()):.6f} across {len(settlement.sp_income)} SPs")
assert abs(settlement.total_deposited
           - (settlement.total_refunded + settlement.total_node_income)) < 1e-3
assert p99 < 250.0
assert fleet.cache_hit_rate() > 0.5
print("CDN serving over the dedicated backbone: OK")
