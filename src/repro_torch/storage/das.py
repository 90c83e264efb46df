"""Data-availability sampling (DAS): the proof-carrying light-client regime.

Instead of few large cache-friendly streams, *millions of tiny random
proof-carrying reads*.  This module glues the 2-D extension of
``core/extend2d.py`` into the serving stack:

* :func:`extend_and_disperse` — pad the first k*k*share_bytes bytes of a
  blob into a k x k data square (the rest of a longer blob is not covered,
  as in the JAX package), RS-extend it to 2k x 2k on the device (one wide
  ``gf_matmul`` per axis — the batch variant stacks MANY blobs into the
  same two launches), Merkle-commit rows, columns and the DAS root on the
  host, place every share on a contract-drawn SP (epoch-seeded, like chunk
  placement), and publish a :class:`~repro_torch.core.contract.DASRecord`
  on chain.
* :class:`LightClientSampler` / ``ShelbySession.sample_availability`` —
  each epoch draw ``s`` uniform share coordinates per blob, fetch them
  through the fleet as tiny paid reads (share + commitment path over the
  backbone NICs), verify locally against the DAS root alone, and return
  an :class:`AvailabilityVerdict`.
* :func:`seed_withholding` — the adversary: mark an exact fraction of a
  blob's shares withheld (data *retained* — chunk-possession audits are
  structurally blind to this; refusing samplers is the only tell).
* :func:`measure_detection` — the verifiable claim: with a withheld
  fraction ``q`` and ``s`` with-replacement samples, detection happens
  with probability exactly ``1 - (1-q)^s``
  (:func:`~repro_torch.core.extend2d.detection_probability`); measured rates
  over seeded adversaries must match the analytic curve.

Sampling coordinates are drawn WITH replacement and withholding marks an
EXACT share count, so the analytic formula is exact — measurement
tolerance covers Monte-Carlo noise only, not model mismatch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import extend2d
from repro_torch.core import placement as placement_mod
from repro_torch.core.contract import DASRecord, ShelbyContract


@dataclasses.dataclass(frozen=True)
class DASSpec:
    """Knobs of the DAS regime (see ``configs/shelby.py``).

    ``proof_bytes_per_share=None`` uses the true modeled proof size
    (coordinates + two Merkle paths + the axis root, a function of the
    square side); a number overrides it on the contract record, e.g. to
    model fancier vector commitments.
    """

    k: int = 4  # data square is k x k; extended square 2k x 2k
    share_bytes: int = 512
    samples_per_epoch: int = 16
    extension: bool = True  # master switch: off = no dispersal, no sampling
    proof_bytes_per_share: int | None = None

    @property
    def side(self) -> int:
        return 2 * self.k

    def layout(self) -> extend2d.Extend2D:
        return extend2d.Extend2D(k=self.k)

    def detection_probability(self, q: float, samples: int | None = None) -> float:
        return extend2d.detection_probability(
            q, self.samples_per_epoch if samples is None else samples
        )


@dataclasses.dataclass(frozen=True)
class SampleReceipt:
    """Pay-per-sample record, session-conservation compatible: settlement
    sums ``payments`` per node exactly like a read receipt's."""

    blob_id: int
    row: int
    col: int
    nbytes: int  # wire bytes paid for (share + proof; 0 if failed/shed)
    share_bytes: int
    proof_bytes: int
    latency_ms: float
    payments: dict[str, float]
    verified: bool
    shed: bool = False
    cache_hit: bool = False

    @property
    def total_paid(self) -> float:
        # sorted so the float sum is independent of dict insertion order
        return sum(self.payments[k] for k in sorted(self.payments))


@dataclasses.dataclass(frozen=True)
class AvailabilityVerdict:
    """One blob's verdict after an epoch's sampling round.

    ``available`` is False the moment ANY sample hard-fails (withheld or
    unverifiable share) — that single failure is the detection event the
    ``1-(1-q)^s`` math prices.  Shed samples are inconclusive (the fleet
    refused at admission; nothing was learned about the SP) and counted
    apart.
    """

    blob_id: int
    epoch: int
    samples: int  # coordinates drawn
    verified: int
    failures: int  # withheld / bad shares (detection events)
    shed: int
    first_failure: int | None  # draw-order index of the first detection
    available: bool
    sample_bytes: int  # total wire bytes (shares + proofs)
    proof_bytes: int
    paid: float


def draw_coords(seed: int, blob_id: int, epoch: int, s: int,
                side: int) -> list[tuple[int, int]]:
    """``s`` uniform share coordinates, WITH replacement (pure in its
    arguments — the sampler's storm is deterministic per seed)."""
    rng = placement_mod._rng(
        seed.to_bytes(8, "little", signed=True), b"das-draw", blob_id, epoch
    )
    flat = rng.integers(0, side * side, size=s)
    return [(int(i) // side, int(i) % side) for i in flat]


# -- dispersal ----------------------------------------------------------------
def extend_and_disperse_many(
    contract: ShelbyContract,
    sps: dict,
    blobs: list[tuple[int, bytes]],  # (blob_id, data)
    spec: DASSpec,
    *,
    device=None,
) -> list[DASRecord]:
    """Extend + commit + place MANY blobs' squares.

    The two RS extension stages run on ``device`` (``None`` = the card) as
    ONE wide ``gf_matmul`` each across all of them (the small-and-wide
    kernel regime); the extended squares come back to the host in one
    copy, where each is committed and its shares placed.  Placement is
    drawn from the contract's epoch seed and the blob id, so a blob lands
    the same whether it is extended alone or in a batch."""
    lay = spec.layout()
    squares = [lay.pad_square(data, spec.share_bytes) for _, data in blobs]
    exts = lay.extend_batch(squares, device=device).cpu().numpy() if squares else []
    active = [info.sp_id for info in contract.active_sps()]
    if not active:
        raise RuntimeError("no active SPs to hold DAS shares")
    records = []
    for (blob_id, _), ext in zip(blobs, exts):
        csq = extend2d.commit_square(ext)
        rng = placement_mod._rng(
            contract.epoch_seed(contract.epoch), b"das", blob_id
        )
        placement: dict[tuple[int, int], int] = {}
        proof_bytes = None
        for r in range(lay.side):
            for c in range(lay.side):
                sp_id = int(active[int(rng.integers(0, len(active)))])
                placement[(r, c)] = sp_id
                proof = csq.prove(r, c, axis="row" if (r + c) % 2 == 0 else "col")
                if proof_bytes is None:
                    proof_bytes = proof.nbytes
                sps[sp_id].store_share(blob_id, r, c, csq.share(r, c), proof)
        record = DASRecord(
            blob_id=blob_id,
            side=lay.side,
            share_bytes=spec.share_bytes,
            das_root=csq.commitment.das_root,
            placement=placement,
            proof_bytes=(
                spec.proof_bytes_per_share
                if spec.proof_bytes_per_share is not None else proof_bytes
            ),
        )
        contract.register_das(record)
        records.append(record)
    return records


def extend_and_disperse(
    contract: ShelbyContract, sps: dict, blob_id: int, data: bytes,
    spec: DASSpec, *, device=None,
) -> DASRecord:
    return extend_and_disperse_many(
        contract, sps, [(blob_id, data)], spec, device=device
    )[0]


# -- the adversary ------------------------------------------------------------
def seed_withholding(
    contract: ShelbyContract, sps: dict, blob_id: int, fraction: float,
    seed: int = 0,
) -> int:
    """Withhold an EXACT ``round(fraction * side^2)`` of a blob's shares
    (seeded, without replacement), marking their holders silent on those
    coordinates.  Returns the withheld count W; the effective per-sample
    hit probability is exactly ``W / side^2``."""
    rec = contract.das[blob_id]
    total = rec.side * rec.side
    w = int(round(fraction * total))
    if w == 0:
        return 0
    rng = placement_mod._rng(
        seed.to_bytes(8, "little", signed=True), b"das-withhold", blob_id
    )
    chosen = rng.choice(total, size=w, replace=False)
    for flat in chosen:
        r, c = int(flat) // rec.side, int(flat) % rec.side
        sps[rec.placement[(r, c)]].withhold_share(blob_id, r, c)
    return w


class LightClientSampler:
    """The light client: a seeded per-epoch sampling schedule over a
    session.  Holding only each blob's DAS root (via the contract), it
    draws ``spec.samples_per_epoch`` coordinates per blob per epoch,
    pays per delivered sample, and keeps the availability verdicts."""

    def __init__(self, session, spec: DASSpec, *, seed: int = 0):
        self.session = session
        self.spec = spec
        self.seed = seed
        self.verdicts: list[AvailabilityVerdict] = []

    def sample_epoch(self, epoch: int, blob_ids: list[int] | None = None,
                     **kw) -> list[AvailabilityVerdict]:
        out = self.session.sample_availability(
            blob_ids, epoch=epoch, samples=self.spec.samples_per_epoch,
            seed=self.seed, **kw,
        )
        self.verdicts.extend(out)
        return out

    @property
    def detections(self) -> int:
        return sum(1 for v in self.verdicts if not v.available)


# -- the verifiable claim: measured vs analytic detection ---------------------
@dataclasses.dataclass(frozen=True)
class DetectionPoint:
    """One (withholding fraction, seed) cell of the detection sweep."""

    fraction: float  # requested withholding fraction
    q_effective: float  # exact withheld share fraction (W / side^2)
    samples: int  # s, per trial
    trials: int
    detected: int
    measured: float  # detected / trials
    analytic: float  # 1 - (1 - q_effective)^s
    mean_samples_to_detect: float  # draw-order index of first failure + 1
    mean_sample_bytes: float  # wire bytes per sample (share + proof)


def _mini_world(num_sps: int, spec: DASSpec, num_blobs: int, seed: int,
                device=None):
    """A tiny DirectTransport world carrying only the DAS plane; the
    layout's byte work runs on ``device`` (``None`` = the card)."""
    from repro_torch.core.audit import AuditParams
    from repro_torch.core.placement import SPInfo
    from repro_torch.storage.blob import BlobLayout
    from repro_torch.storage.rpc import RPCNode
    from repro_torch.storage.sdk import ShelbyClient
    from repro_torch.storage.sp import StorageProvider

    layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, device=device)
    contract = ShelbyContract(AuditParams())
    sps: dict[int, StorageProvider] = {}
    for i in range(num_sps):
        contract.register_sp(SPInfo(sp_id=i, stake=10_000.0, dc=f"dc{i % 3}"))
        sps[i] = StorageProvider(i)
    rpc = RPCNode("rpc0", contract, sps, layout)
    client = ShelbyClient(contract, rpc, deposit=1e6, das=spec)
    rng = np.random.default_rng(seed)
    blob_ids = []
    for _ in range(num_blobs):
        data = rng.integers(0, 256, spec.k * spec.k * spec.share_bytes,
                            dtype=np.uint8).tobytes()
        blob_ids.append(client.put(data).blob_id)
    return contract, sps, client, blob_ids


def measure_detection(
    fractions=(0.05, 0.15, 0.30),
    seeds=(0, 1, 2),
    *,
    spec: DASSpec | None = None,
    num_blobs: int = 12,
    rounds: int = 12,
    num_sps: int = 6,
    samples: int | None = None,
    device=None,
) -> list[DetectionPoint]:
    """Measured withholding-detection rate vs the analytic ``1-(1-q)^s``.

    Per (fraction, seed): a fresh world, every blob's shares dispersed,
    an exact-count withholding adversary seeded on every blob, then
    ``rounds`` independent sampling epochs per blob — each epoch's draw
    is one Bernoulli trial whose success probability is the analytic
    curve.  Sessions settle, so pay-per-sample conservation is exercised
    on every run.  The worlds' byte work runs on ``device`` (``None`` = the
    card)."""
    spec = spec or DASSpec()
    s = samples or spec.samples_per_epoch
    points = []
    for fraction in fractions:
        for seed in seeds:
            contract, sps, client, blob_ids = _mini_world(
                num_sps, spec, num_blobs, seed, device=device
            )
            total = spec.side * spec.side
            w = None
            for blob_id in blob_ids:
                w = seed_withholding(contract, sps, blob_id, fraction,
                                     seed=seed * 1013 + blob_id)
            q_eff = (w or 0) / total
            trials = detected = 0
            first_sum = 0
            bytes_sum = bytes_n = 0
            session = client.current_session
            for epoch in range(rounds):
                verdicts = session.sample_availability(
                    blob_ids, epoch=epoch, samples=s, seed=seed * 733 + epoch
                )
                for v in verdicts:
                    trials += 1
                    if not v.available:
                        detected += 1
                        first_sum += (v.first_failure or 0) + 1
                    if v.verified:
                        bytes_sum += v.sample_bytes
                        bytes_n += v.verified
            client.settle()  # conservation checked inside close()
            points.append(
                DetectionPoint(
                    fraction=fraction,
                    q_effective=q_eff,
                    samples=s,
                    trials=trials,
                    detected=detected,
                    measured=detected / trials if trials else 0.0,
                    analytic=extend2d.detection_probability(q_eff, s),
                    mean_samples_to_detect=(
                        first_sum / detected if detected else float("inf")
                    ),
                    mean_sample_bytes=bytes_sum / bytes_n if bytes_n else 0.0,
                )
            )
    return points
