"""The paper's canonical workload (§1) on the port: 4K video streaming at >= 40 Mbps.

Stores a simulated video, then "plays" it through the session API's
streaming path — ``client.stream`` yields one :class:`ReadReceipt` per
segment (sequential chunkset reads with hedged k-of-n fetches under the
hood) while one SP is a heavy straggler and another is dead.  Reports
achieved throughput against the 40 Mbps bar and the micropayments that
flowed per serving node ("reads are paid"), then settles the session and
checks conservation.  The program of ``examples/video_streaming.py`` on
``repro_torch``: the layout's device (``--device``, the card by default)
runs the Clay encode and every segment's batched decode through
``gf_matmul``, where the reference picks the decode's kernel by a config
knob.

    PYTHONPATH=src python examples/torch/video_streaming.py [--device cpu]
    VIDEO_SMOKE=1 PYTHONPATH=src python examples/torch/video_streaming.py  # CI-sized
"""
import argparse
import os
import time

import numpy as np

from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.device import resolve_device
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import StorageProvider

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

SMOKE = bool(int(os.environ.get("VIDEO_SMOKE", "0")))
VIDEO_BYTES = (4 if SMOKE else 24) * 1024 * 1024
CHUNKSET = (512 if SMOKE else 1024) * 1024
RTT_BUDGET_MS = 20.0  # dedicated-backbone round trip per segment

layout = BlobLayout(k=10, m=6, chunkset_bytes_target=CHUNKSET, device=device)  # paper (10,6)
contract = ShelbyContract()
sps = {}
for i in range(20):
    contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 5}", rack=f"r{i % 4}"))
    sps[i] = StorageProvider(i)
rpc = RPCNode("rpc0", contract, sps, layout, hedge=2, cache_chunksets=4)
client = ShelbyClient(contract, rpc)

print(f"uploading 'video' ({layout.replication_overhead:.1f}x replication overhead)...")
video = np.random.default_rng(1).integers(0, 256, VIDEO_BYTES, dtype=np.uint8).tobytes()
meta = client.put(video, payment=2.0, epochs=30)

# adversity: one SP dead, one straggling 250 ms/request
dead = meta.placement[(0, 2)]
slow = meta.placement[(0, 5)]
sps[dead].crash()
sps[slow].behavior.latency_ms = 250.0

# "play": stream segment receipts through the seekable reader path
with client.open(meta.blob_id) as probe:  # BlobReader: seek + peek the header
    header = probe.read(16)
    assert header == video[:16]
    probe.seek(0)

played = bytearray()
t0 = time.time()
sim_latency_ms = 0.0
segments = 0
for receipt in client.stream(meta.blob_id, chunk_size=layout.chunkset_bytes):
    played += receipt.data
    sim_latency_ms += receipt.latency_ms + RTT_BUDGET_MS
    segments += 1
wall = time.time() - t0
played = bytes(played)
assert played == video, "bitstream must be intact"

mbits = meta.size_bytes * 8 / 1e6
sim_s = sim_latency_ms / 1e3
print(f"streamed {mbits:.0f} Mbit in {segments} segments, {sim_s:.2f} s simulated "
      f"network time ({mbits / sim_s:.0f} Mbps vs 40 Mbps requirement) "
      f"[decode wall {wall:.1f}s on {device.type}]")
print(f"hedged requests wasted: {rpc.stats.hedged_wasted}, bad/slow SPs never stalled playback")

settlement = client.settle()
assert abs(settlement.total_deposited
           - (settlement.total_refunded + settlement.total_node_income)) < 1e-6
print(f"micropayments: client->RPC ${settlement.total_node_income:.9f} (settled), "
      f"RPC->SPs ${sum(settlement.sp_income.values()):.6f} across "
      f"{len(settlement.sp_income)} SPs ({rpc.stats.chunks_requested} chunk requests)")
assert mbits / sim_s >= 40, "4K streaming bar"
print("4K streaming requirement met under failures: OK")
