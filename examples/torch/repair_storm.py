"""Appendix-A scenario: correlated failures and the repair pipeline, on the port.

A rack-level event knocks out several SPs at once; the repair coordinator
rebuilds every lost chunk — MSR path where all n-1 helpers survive, MDS
fallback where two chunks of a chunkset are gone — and we account the exact
helper bytes against the Reed-Solomon counterfactual (§3.3's claim, live).
The program of ``examples/repair_storm.py`` on ``repro_torch``: every
encode, decode and repair is a ``gf_matmul`` on ``--device``.

    PYTHONPATH=src python examples/torch/repair_storm.py [--device cpu]
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

layout = BlobLayout(k=10, m=6, chunkset_bytes_target=512 * 1024, device=device)
contract = ShelbyContract()
sps = {}
for i in range(24):
    contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 4}", rack=f"r{i % 8}"))
    sps[i] = StorageProvider(i)
rpc = RPCNode("rpc0", contract, sps, layout)
client = ShelbyClient(contract, rpc)

rng = np.random.default_rng(3)
blobs = [client.put(rng.integers(0, 256, 1_500_000, dtype=np.uint8).tobytes())
         for _ in range(3)]
total_chunks = sum(len(m.placement) for m in blobs)
print(f"stored {len(blobs)} blobs = {total_chunks} chunks on 24 SPs across 4 DCs")

# rack r3 loses power: every SP on it wipes (data loss, not just downtime)
victims = [i for i in range(24) if i % 8 == 3]
for v in victims:
    sps[v].wipe()
print(f"rack event: SPs {victims} lost all chunks")

rc = RepairCoordinator(contract, sps, layout)
lost = rc.scan_lost_chunks()
print(f"detected {len(lost)} lost chunks")
reports = rc.repair_all()

msr = [r for r in reports if r.mode == "msr"]
mds = [r for r in reports if r.mode == "mds"]
helper_bytes = sum(r.helper_bytes_read for r in reports)
rs_bytes = len(reports) * layout.k * layout.chunk_bytes
print(f"repaired {len(reports)} chunks: {len(msr)} MSR + {len(mds)} MDS-fallback")
print(f"helper bytes read: {helper_bytes/1e6:.1f} MB vs Reed-Solomon {rs_bytes/1e6:.1f} MB "
      f"({1 - helper_bytes/rs_bytes:.0%} saved)")
assert not rc.scan_lost_chunks(), "all chunks restored"

# end-to-end integrity after the storm: one batched fleet pass, paid on
# delivery, then settle the session
rpc._cache.clear()
receipts = client.get_many([(meta.blob_id, 0, None) for meta in blobs])
for meta, receipt in zip(blobs, receipts):
    assert len(receipt.data) == meta.size_bytes
settlement = client.settle()
print(f"post-storm reads verified: OK (paid ${settlement.total_node_income:.9f}, "
      f"SPs realized ${sum(settlement.sp_income.values()):.6f} at settlement)")
