"""Quickstart: the Shelby write/read/audit/repair lifecycle in 60 lines, on the port.

    PYTHONPATH=src python examples/torch/quickstart.py               # on the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu  # plain path

The program of ``examples/quickstart.py`` on ``repro_torch``: the Clay encode,
decode and repair run ``gf_matmul`` on ``--device`` (the card by default,
which raises without one).
"""
import argparse

import numpy as np

from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.device import resolve_device
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.repair import RepairCoordinator
from repro_torch.storage.rpc import RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import StorageProvider

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

# 1. a small Shelby deployment: contract + 8 SPs across 3 DCs + one RPC node
layout = BlobLayout(k=4, m=2, chunkset_bytes_target=256 * 1024, device=device)  # 1.5x overhead
contract = ShelbyContract()
sps = {}
for i in range(8):
    contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 4}"))
    sps[i] = StorageProvider(i)
rpc = RPCNode("rpc0", contract, sps, layout)
client = ShelbyClient(contract, rpc)

# 2. write a blob: partition -> Clay-encode -> commit -> pay -> disperse
data = np.random.default_rng(7).integers(0, 256, 1_000_000, dtype=np.uint8).tobytes()
meta = client.put(data, payment=1.0, epochs=12)
print(f"stored blob {meta.blob_id}: {meta.size_bytes} bytes as {meta.num_chunksets} "
      f"chunksets x {meta.n} chunks (overhead {layout.replication_overhead:.2f}x), "
      f"state={meta.state.value}")

# 3. paid, verified reads (any byte range): every read returns a receipt
receipt = client.read(meta.blob_id)
assert receipt.data == data
assert client.get(meta.blob_id, 123_456, 789) == data[123_456 : 123_456 + 789]
print(f"reads ok; paid ${receipt.total_paid:.9f} to {list(receipt.payments)} "
      f"(sim latency {receipt.latency_ms:.1f} ms); RPC paid SPs "
      f"${rpc.stats.payments:.6f} over micropayment channels")

# 4. kill an SP: reads still work (MDS: any k of n), then repair at MSR bandwidth
victim = meta.placement[(0, 0)]
sps[victim].crash()
rpc._cache.clear()
assert client.get(meta.blob_id) == data
print(f"SP {victim} down -> reads fine ({rpc.stats.chunks_requested} chunk requests)")

sps[victim].recover()
sps[victim].wipe()
reports = RepairCoordinator(contract, sps, layout).repair_all()
msr = sum(r.mode == "msr" for r in reports)
print(f"repaired {len(reports)} chunks ({msr} at MSR bandwidth, "
      f"{sum(r.helper_bytes_read for r in reports)} helper bytes)")

# 5. corruption is detected, not served — and the corrupt chunk is NOT paid
evil = meta.placement[(0, 1)]
sps[evil].behavior.corrupt = True
rpc._cache.clear()
assert client.get(meta.blob_id) == data
print(f"corrupt SP detected: {rpc.stats.chunks_bad} bad chunks rejected by commitments")

# 6. close the session: broadcast the freshest refunds; conservation holds
settlement = client.settle()
assert abs(settlement.total_deposited
           - (settlement.total_refunded + settlement.total_node_income)) < 1e-6
print(f"settled: client refunded ${settlement.total_refunded:.6f}, RPC income "
      f"${settlement.total_node_income:.9f}, SPs realized "
      f"${sum(settlement.sp_income.values()):.6f}")
