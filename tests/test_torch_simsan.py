"""simsan, the runtime sanitizer of the event loop, in the port
(``repro_torch.analysis.simsan``).

Every case of ``tests/test_simsan.py`` on the port's modules: a leaked
resource slot and an off-loop resource mutation are each caught with an
error naming the task and sim-time; a cancelled task's slots are
reclaimed; the pop-order audit, payment-conservation check, and — crucially
— that a sanitized run is behaviourally identical to an unsanitized one
(same digest), here on the CPU plain path, and equal to the JAX package's.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis.simsan import SanitizerError, check_payment_conservation
from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.net.backbone import Backbone
from repro_torch.net.events import Acquire, EventLoop, Release, Sleep
from repro_torch.net.fleet import CacheAffinityPolicy, RPCFleet
from repro_torch.net.workloads import replay_open_loop, zipf_hotset
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.rpc import BackboneTransport, RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import ServiceSpec, StorageProvider


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs small tensors, where an intra-op thread pool
    costs far more than it saves: one thread per module, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- injected fault (a): leaked resource slot ------------------------------------
def test_leaked_slot_detected_at_drain():
    loop = EventLoop(sanitize=True)

    def leaker():
        yield Acquire(("sp", 3), 2)
        yield Sleep(5.0)
        # returns while still holding the slot

    loop.spawn(leaker(), label="reader/blob7")
    with pytest.raises(SanitizerError) as err:
        loop.run()
    msg = str(err.value)
    assert "leak" in msg
    assert "('sp', 3)" in msg          # resource key
    assert "reader/blob7" in msg       # holder task
    assert "t=0" in msg                # acquire sim-time

    # same program on an unsanitized loop: silent (that's the point)
    loop2 = EventLoop()

    def leaker2():
        yield Acquire(("sp", 3), 2)
        yield Sleep(5.0)

    loop2.spawn(leaker2(), label="reader/blob7")
    loop2.run()
    assert loop2.resource(("sp", 3)).in_use == 1


def test_release_without_acquire_detected():
    loop = EventLoop(sanitize=True)

    def over_releaser():
        yield Sleep(2.0)
        yield Release(("disk", 0))

    loop.spawn(over_releaser(), label="over/0")
    with pytest.raises(SanitizerError, match="release without acquire"):
        loop.run()
    msg_loop = EventLoop(sanitize=True)
    try:
        def again():
            yield Sleep(2.0)
            yield Release(("disk", 0))
        msg_loop.spawn(again(), label="over/1")
        msg_loop.run()
    except SanitizerError as e:
        assert "over/1" in str(e) and "t=2" in str(e)


# -- injected fault (b): off-loop mutation ---------------------------------------
def test_off_loop_scalar_mutation_names_task_and_time():
    loop = EventLoop(sanitize=True)

    def mutator():
        yield Sleep(7.0)
        res = loop.resource(("sp", 1), 4)
        res.in_use += 1  # bypassing Acquire

    loop.spawn(mutator(), label="rogue/writer")
    with pytest.raises(SanitizerError) as err:
        loop.run()
    msg = str(err.value)
    assert "off-loop mutation" in msg
    assert "rogue/writer" in msg       # the task
    assert "t=7" in msg                # the sim-time
    assert "in_use" in msg and "('sp', 1)" in msg


def test_off_loop_dict_mutation_detected_in_window():
    loop = EventLoop(sanitize=True)

    def legit():
        yield Acquire(("sp", 2), 4)
        yield Sleep(1.0)
        yield Release(("sp", 2))

    def rogue():
        yield Sleep(3.0)
        # dict-valued accounting can't be guarded by __setattr__; the
        # shadow check catches it at the next engine touch / drain
        loop.resource(("sp", 2)).in_use_by_class[0] += 1

    loop.spawn(legit(), label="legit")
    loop.spawn(rogue(), label="rogue/dict")
    with pytest.raises(SanitizerError) as err:
        loop.run()
    msg = str(err.value)
    assert "off-loop mutation" in msg and "in_use_by_class" in msg
    assert "('sp', 2)" in msg


# -- regression: a cancelled task never leaks its slots --------------------------
def test_cancelled_task_slots_are_reclaimed():
    loop = EventLoop(sanitize=True)
    granted_at = []

    def holder():
        yield Acquire(("disk", 0), 1)
        yield Sleep(100.0)
        yield Release(("disk", 0))

    def waiter():
        yield Acquire(("disk", 0), 1)
        granted_at.append(loop.now)
        yield Release(("disk", 0))

    h = loop.spawn(holder(), label="holder")

    def canceller():
        yield Sleep(5.0)
        h.cancel()

    loop.spawn(waiter(), at_ms=1.0, label="waiter")
    loop.spawn(canceller(), label="canceller")
    # a leak would deadlock the waiter AND trip the sanitizer at drain;
    # instead the cancel hands the slot over at t=5
    loop.run()
    assert granted_at == [5.0]
    assert loop.resource(("disk", 0)).in_use == 0
    assert h.held == []


def test_cancel_reclaim_works_without_sanitizer():
    loop = EventLoop()

    def holder():
        yield Acquire(("disk", 0), 1)
        yield Sleep(100.0)

    h = loop.spawn(holder(), label="holder")

    def canceller():
        yield Sleep(5.0)
        h.cancel()

    loop.spawn(canceller(), label="canceller")
    loop.run()
    assert loop.resource(("disk", 0)).in_use == 0


# -- pop-order / causality audit -------------------------------------------------
def test_pop_order_audit_unit():
    loop = EventLoop(sanitize=True)
    san = loop._san
    san.on_pop(5.0, 10)
    with pytest.raises(SanitizerError, match="same-timestamp"):
        san.on_pop(5.0, 10)  # seq must strictly ascend within a timestamp
    with pytest.raises(SanitizerError, match="backwards"):
        san.on_pop(4.0, 11)
    with pytest.raises(SanitizerError, match="non-finite"):
        san.on_push(float("nan"), type("H", (), {"label": "x"})())


def test_scheduling_into_the_past_is_a_causality_violation():
    loop = EventLoop(sanitize=True)

    def child():
        yield Sleep(0.0)

    def parent():
        yield Sleep(10.0)
        loop.spawn(child(), at_ms=1.0, label="too-late")

    loop.spawn(parent(), label="parent")
    with pytest.raises(SanitizerError, match="causality"):
        loop.run()


# -- sanitize must not perturb behaviour -----------------------------------------
def _world(num_sps=6, slots=4):
    layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, device="cpu")
    contract = ShelbyContract()
    bb = Backbone.mesh(3, base_latency_ms=4.0, gbps=10.0)
    sps = {}
    for i in range(num_sps):
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}"))
        sps[i] = StorageProvider(i, service=ServiceSpec(slots=slots))
        bb.register_node(f"sp{i}", f"dc{i % 3}")
    bb.register_node("rpc0", "dc0")
    rpc = RPCNode("rpc0", contract, sps, layout,
                  transport=BackboneTransport(sps, bb, "rpc0"))
    bb.register_node("client", "dc0")
    fleet = RPCFleet([rpc], CacheAffinityPolicy(), backbone=bb)
    client = ShelbyClient(contract, fleet, deposit=1e9)
    return fleet, client


def _digest_of_replay(monkeypatch, sanitized: bool) -> str:
    if sanitized:
        monkeypatch.setenv("SHELBY_SIMSAN", "1")
    else:
        monkeypatch.delenv("SHELBY_SIMSAN", raising=False)
    fleet, client = _world()
    rng = np.random.default_rng(0)
    metas = [client.put(rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
             for _ in range(3)]
    reqs = zipf_hotset(metas, clients=["client"], num_requests=60, seed=11)
    result = replay_open_loop(fleet, reqs)
    assert all(r.ok for r in result.records)
    return result.digest()


def test_sanitized_replay_digest_identical(monkeypatch):
    """EventLoop(sanitize=True) observes; it must never move an event —
    the determinism digest of a sanitized replay equals the plain one."""
    assert (_digest_of_replay(monkeypatch, sanitized=True)
            == _digest_of_replay(monkeypatch, sanitized=False))


# -- payment conservation --------------------------------------------------------
class _Chan:
    def __init__(self, deposit, paid):
        self.deposit = deposit
        self.paid = paid


class _Receipt:
    def __init__(self, payments):
        self.payments = payments


class _Session:
    def __init__(self, receipts, channels):
        self.receipts = receipts
        self.receipt_batches = []
        self.channels = channels


def test_payment_conservation_clean():
    session = _Session(
        receipts=[_Receipt({"rpc0": 0.25}), _Receipt({"rpc0": 0.25, "rpc1": 0.1})],
        channels={"rpc0": _Chan(10.0, 0.5), "rpc1": _Chan(10.0, 0.1)},
    )
    check_payment_conservation(session)  # no raise


def test_payment_conservation_catches_unreceipted_debit():
    session = _Session(
        receipts=[_Receipt({"rpc0": 0.25})],
        channels={"rpc0": _Chan(10.0, 0.40)},  # 0.15 paid with no receipt
    )
    with pytest.raises(SanitizerError, match="payment conservation"):
        check_payment_conservation(session, where="epoch 1")
    with pytest.raises(SanitizerError, match="epoch 1"):
        check_payment_conservation(session, where="epoch 1")


def test_payment_conservation_catches_receipt_without_channel():
    session = _Session(receipts=[_Receipt({"ghost": 0.1})], channels={})
    with pytest.raises(SanitizerError, match="no\\s+channel"):
        check_payment_conservation(session)


def test_run_sim_per_epoch_conservation_wired():
    from repro_torch.core.simulation import run_sim
    from repro_torch.storage.sp import SPBehavior
    res = run_sim({i: SPBehavior() for i in range(6)}, epochs=1,
                  read_requests_per_epoch=20, seed=5, sanitize=True,
                  device="cpu")
    assert res.client_read_payments > 0


# -- beyond the reference: the port against the JAX package ----------------------
def _reference_digest() -> str:
    """The same replay on the JAX package's modules, unsanitized."""
    from repro.core.contract import ShelbyContract as RContract
    from repro.core.placement import SPInfo as RSPInfo
    from repro.net.backbone import Backbone as RBackbone
    from repro.net.fleet import CacheAffinityPolicy as RPolicy
    from repro.net.fleet import RPCFleet as RFleet
    from repro.net.workloads import replay_open_loop as r_replay
    from repro.net.workloads import zipf_hotset as r_zipf
    from repro.storage.blob import BlobLayout as RLayout
    from repro.storage.rpc import BackboneTransport as RTransport
    from repro.storage.rpc import RPCNode as RNode
    from repro.storage.sdk import ShelbyClient as RClient
    from repro.storage.sp import ServiceSpec as RService
    from repro.storage.sp import StorageProvider as RSP

    layout = RLayout(k=4, m=2, chunkset_bytes_target=64 * 1024)
    contract = RContract()
    bb = RBackbone.mesh(3, base_latency_ms=4.0, gbps=10.0)
    sps = {}
    for i in range(6):
        contract.register_sp(RSPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}"))
        sps[i] = RSP(i, service=RService(slots=4))
        bb.register_node(f"sp{i}", f"dc{i % 3}")
    bb.register_node("rpc0", "dc0")
    rpc = RNode("rpc0", contract, sps, layout, transport=RTransport(sps, bb, "rpc0"))
    bb.register_node("client", "dc0")
    fleet = RFleet([rpc], RPolicy(), backbone=bb)
    client = RClient(contract, fleet, deposit=1e9)
    rng = np.random.default_rng(0)
    metas = [client.put(rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
             for _ in range(3)]
    return r_replay(fleet, r_zipf(metas, clients=["client"], num_requests=60,
                                  seed=11)).digest()


def test_sanitized_replay_digest_equals_reference(monkeypatch):
    """The port's sanitized replay gives the JAX package's digest."""
    assert _digest_of_replay(monkeypatch, sanitized=True) == _reference_digest()


def test_sanitizer_is_armed_by_flag_or_env(monkeypatch):
    from repro_torch.analysis.simsan import GuardedResource, Sanitizer

    monkeypatch.delenv("SHELBY_SIMSAN", raising=False)
    plain = EventLoop()
    assert plain._san is None and type(plain.resource(("sp", 0), 1)) is not GuardedResource
    assert isinstance(EventLoop(sanitize=True)._san, Sanitizer)
    monkeypatch.setenv("SHELBY_SIMSAN", "1")
    loop = EventLoop()
    assert isinstance(loop._san, Sanitizer)
    assert isinstance(loop.resource(("sp", 0), 1), GuardedResource)


def test_payment_conservation_counts_receipt_batches():
    """A cohort fast-path replay pays through a ReceiptBatch: its
    ``paid_by_node`` backs the channel debits, and a debit it does not
    account for is caught."""
    from repro_torch.net.workloads import zipf_hotset_batch

    fleet, client = _world()
    rng = np.random.default_rng(0)
    metas = [client.put(rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
             for _ in range(3)]
    batch = zipf_hotset_batch(metas, clients=["client"], num_requests=200, seed=3)
    session = client.session()
    rb, fast = session.replay(batch)
    assert fast.cohort is not None and session.receipt_batches == [rb]
    assert sum(rb.paid_by_node.values()) > 0
    check_payment_conservation(session, where="after the batch")
    node = sorted(rb.paid_by_node)[0]
    rb.paid_by_node[node] += 1e-3
    with pytest.raises(SanitizerError, match="after the batch"):
        check_payment_conservation(session, where="after the batch")
    rb.paid_by_node[node] -= 1e-3
    session.close()


def test_run_sim_sanitized_equals_plain_and_reference():
    """``run_sim(sanitize=True)`` checks conservation at every epoch and
    changes nothing: its result equals the unsanitized run's and the JAX
    package's."""
    import dataclasses

    from repro.core.simulation import run_sim as ref_run_sim
    from repro.storage.sp import SPBehavior as RBehavior
    from repro_torch.core.simulation import run_sim
    from repro_torch.storage.sp import SPBehavior

    kw = dict(epochs=2, read_requests_per_epoch=20, seed=5)
    san = run_sim({i: SPBehavior() for i in range(6)}, sanitize=True, device="cpu", **kw)
    plain = run_sim({i: SPBehavior() for i in range(6)}, sanitize=False, device="cpu", **kw)
    ref = ref_run_sim({i: RBehavior() for i in range(6)}, sanitize=True, **kw)
    assert dataclasses.asdict(san) == dataclasses.asdict(plain) == dataclasses.asdict(ref)
