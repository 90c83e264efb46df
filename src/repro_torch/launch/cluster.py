"""A simulated Shelby deployment for the port: contract, SPs, an RPC fleet
and the fleet-first client, with the Clay data path on one device.

The counterpart of the JAX package's ``repro/launch/train.py::build_cluster``
(without the DAS plane and without the trainer):

    from repro_torch.launch.cluster import build_cluster
    contract, sps, rpc, client = build_cluster(device="cpu")
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shelby import CONFIG
from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.device import resolve_device
from repro_torch.net.fleet import CacheAffinityPolicy, RPCFleet
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import ServiceSpec, StorageProvider


def build_cluster(num_sps: int = 8, layout: BlobLayout | None = None,
                  num_rpcs: int = 1, device=None, *, num_dcs: int = 3,
                  racks_per_dc: int = 4):
    """(contract, sps, primary RPC node, client).

    ``device=None`` means the card and raises without one; ``"cpu"`` runs
    the plain path.  The layout is rebound to that device.  SP ``i`` sits
    in ``dc{i % num_dcs}``, rack ``r{i % racks_per_dc}``.
    """
    layout = dataclasses.replace(
        layout or BlobLayout(k=4, m=2, chunkset_bytes_target=256 * 1024),
        device=resolve_device(device),
    )
    contract = ShelbyContract()
    sps = {}
    for i in range(num_sps):
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % num_dcs}",
                                    rack=f"r{i % racks_per_dc}"))
        sps[i] = StorageProvider(
            i, service=ServiceSpec(slots=CONFIG.sp_service_slots)
        )
    rpcs = [
        RPCNode(f"rpc{r}", contract, sps, layout, cache_chunksets=32)
        for r in range(num_rpcs)
    ]
    fleet = RPCFleet(rpcs, CacheAffinityPolicy())
    client = ShelbyClient(contract, fleet, deposit=1e9)
    return contract, sps, fleet.primary, client
