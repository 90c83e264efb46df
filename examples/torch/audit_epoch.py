"""Run Shelby audit epochs against an adversarial SP population (§4), on the port.

Population: honest SPs, one that silently dropped 30% of its chunks, one
lazy auditor (blind '1's, keeps no proofs), one crashed.  Shows scoreboard
-> trimmed BFT scores -> quadratic on-chain challenges -> slashing.  The
program of ``examples/audit_epoch.py`` on ``repro_torch``: the blobs'
Clay encode runs ``gf_matmul`` on ``--device``.

    PYTHONPATH=src python examples/torch/audit_epoch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.audit import AuditParams
from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.device import resolve_device
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import SPBehavior, StorageProvider

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

params = AuditParams(p_a=0.6, auditors_per_audit=4, C=50, p_ata=0.25)
layout = BlobLayout(k=4, m=2, chunkset_bytes_target=128 * 1024, device=device)
contract = ShelbyContract(params)
sps = {}
for i in range(10):
    contract.register_sp(SPInfo(sp_id=i, stake=300.0, dc=f"dc{i % 3}"))
    behavior = SPBehavior()
    if i == 7:
        behavior = SPBehavior(drop_fraction=0.3)  # fakes 30% of storage
    if i == 8:
        behavior = SPBehavior(lazy_auditor=True, retain_proofs=False)
    sps[i] = StorageProvider(i, behavior)
rpc = RPCNode("rpc0", contract, sps, layout)
client = ShelbyClient(contract, rpc)

rng = np.random.default_rng(0)
for _ in range(6):  # several blobs so every SP holds chunks
    client.put(rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
sps[9].crash()  # crashes after writes

for epoch in range(2):
    challenges = contract.internal_challenges(epoch)
    for ch in challenges:
        proof = sps[ch.auditee].respond_challenge(ch)
        for auditor in ch.auditors:
            sps[auditor].audit_peer(ch, proof, contract)
    for sp in sps.values():
        contract.submit_scoreboard(epoch, sp.scoreboard)

    outcome = contract.close_epoch(
        epoch,
        respond_onchain_storage=lambda sp, b, cs, ck, si: (
            (lambda pr: (pr.sample, pr.proof) if pr else None)(
                sps[sp].respond_challenge(
                    type(challenges[0])(epoch, sp, b, cs, ck, si, ())))),
        respond_ata=lambda auditor, auditee, pos: sps[auditor].reproduce_proof(auditee, pos),
    )
    print(f"epoch {epoch}: challenges={len(challenges)}")
    for i in sorted(outcome.scores):
        tag = {7: "fakes 30%", 8: "lazy auditor", 9: "crashed"}.get(i, "honest")
        print(f"  SP{i:2d} [{tag:12s}] score={outcome.scores[i]:.2f} "
              f"onchain={outcome.onchain_challenges[i]:3d} "
              f"slashed=${outcome.slashed.get(i, 0):8.1f} "
              f"utility={outcome.utility(i):+9.2f}")
    # reset per-epoch auditor state
    for sp in sps.values():
        sp.scoreboard.bits.clear()

print("ejected SPs:", sorted(contract.ejected))
