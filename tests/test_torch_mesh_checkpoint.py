"""Checkpoints of a train state sharded over the port's mesh, on the CPU.

One world of four Gloo processes (a module fixture) holds two meshes over
the same ranks (``launch/mesh.py::process_mesh``): the 2 x 2 ``("data",
"model")`` mesh that trains, and the 4 x 1 one of the elastic restore.
World rank 0 holds a Shelby cluster (``launch/cluster.py``, Clay (4,2) over
8 SPs).  On the 2 x 2 mesh a ``Trainer`` with a ``MeshCtx`` trains
hymba-smoke (attention, Mamba with its part-wise ``in_proj``, the MLP) in
two microbatches of 4 x 16, checkpoints at step 2 through rank 0's client
(the state gathered to rank 0 one leaf at a time), has an SP lose every
chunk it stored, trains two more steps, checkpoints at step 4 and repairs
the lost chunks (rank 0 repairs, the others wait), then restores the latest
checkpoint into the 2 x 2 mesh, into one process and into the 4 x 1 mesh.

Checked: the checkpoint bytes equal ``serialize_pytree`` of the unsharded
state (what one process writes of that state), and the JAX package's
``deserialize_pytree`` reads them back to the same leaves; each restore
equals the state saved (every rank's shards under its own mesh's rules,
the whole state in one process) bit for bit; the repairs ran and verified,
and the reports (checkpoint bytes, repairs, restarts) are equal on every
rank.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import launch, process_mesh
from repro_torch.sharding import TRAIN_RULES, MeshCtx, flatten, shard_params, unshard
from repro_torch.storage import checkpoint as tck
from repro_torch.train.loop import Trainer

ARCH = "hymba-1.5b"
BATCH, SEQ, MICROBATCHES, CKPT_EVERY = 4, 16, 2, 2


def _batches(vocab: int):
    """The same global batches on every rank."""
    rng = np.random.default_rng(5)
    while True:
        toks = rng.integers(0, vocab, (BATCH, SEQ + 1))
        yield toks[:, :-1], toks[:, 1:]


def _whole(state, specs, ctx, mesh) -> dict:
    return {**{k: unshard(state[k], specs, ctx.rules, mesh) for k in ("params", "m", "v")},
            "step": state["step"]}


def _equal(a: dict, b: dict) -> bool:
    fa, fb = flatten(a), flatten(b)
    return list(fa) == list(fb) and all(torch.equal(x.cpu(), y.cpu())
                                        for x, y in zip(fa.values(), fb.values()))


def _bytes(client, rec) -> np.ndarray:
    data = b"".join(r.data for r in client.get_many([(b, 0, None) for b in rec.shard_blob_ids]))
    return np.frombuffer(data[:rec.total_bytes], np.uint8).copy()


def _rank(mesh) -> dict:
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.storage.checkpoint import CheckpointManager
    from repro_torch.storage.repair import RepairCoordinator

    cfg = get_smoke(ARCH)
    root = mesh.rank == 0
    mgr = repair = client = sps = None
    if root:
        contract, sps, rpc, client = build_cluster(device="cpu")
        mgr = CheckpointManager(client, num_host_shards=2)
        repair = RepairCoordinator(contract, sps, rpc.layout)
    ctx = MeshCtx(TRAIN_RULES, mesh, cfg)
    trainer = Trainer(cfg, ctx=ctx, ckpt=mgr, repair=repair, ckpt_every=CKPT_EVERY,
                      num_microbatches=MICROBATCHES)
    specs = trainer.specs
    batches = _batches(cfg.vocab)
    out = {"rank": mesh.rank}
    state, rep1 = trainer.run(trainer.init_state(seed=3), batches, CKPT_EVERY)
    saved2 = _whole(state, specs, ctx, mesh)
    if root:  # an SP loses every chunk it stored
        victim = next(iter(sps))
        sps[victim].crash()
        sps[victim].recover()
        sps[victim].wipe()
    state, rep2 = trainer.run(state, batches, CKPT_EVERY, start_step=CKPT_EVERY)
    saved4 = _whole(state, specs, ctx, mesh)
    out["reports"] = [(r.steps_run, r.ckpt_bytes, r.repairs, r.losses) for r in (rep1, rep2)]
    if root:
        out["repairs_verified"] = not repair.failures and not repair.scan_lost_chunks()
        out["bytes2"] = _bytes(client, mgr.records[2])
        out["bytes4"] = _bytes(client, mgr.records[4])
        out["serialized2"] = np.frombuffer(tck.serialize_pytree(saved2), np.uint8).copy()
        out["saved2"] = flatten(saved2)
    # restore into the 2 x 2 mesh, the world's own
    restored, step = trainer.restore_latest(state)
    out["restored_step"], out["restarts"] = step, trainer.restarts
    out["mesh_equal"] = _equal(restored, state)
    # into one process, on rank 0
    if root:
        one = Trainer(cfg, ckpt=mgr, device="cpu")
        whole, step1 = one.restore_latest(one.init_state())
        out["one_step"], out["one_equal"] = step1, _equal(whole, saved4)
    # into a 4 x 1 mesh over the same ranks (other shards under the same rules)
    mesh41 = process_mesh(4, 1, mesh.device)
    trainer41 = Trainer(cfg, ctx=MeshCtx(TRAIN_RULES, mesh41, cfg), ckpt=mgr)  # a row a rank
    restored41, step41 = trainer41.restore_latest(None)
    want = {k: shard_params(saved4[k], specs, TRAIN_RULES, mesh41, mesh41.coords)
            for k in ("params", "m", "v")}
    out["elastic_step"] = step41
    out["elastic_equal"] = _equal(restored41, {**want, "step": saved4["step"]})
    out["elastic_shapes_differ"] = any(
        restored41["params"][k].shape != state["params"][k].shape for k in specs)
    # and the 4 x 1 mesh trains on from it
    _, rep3 = trainer41.run(restored41, _batches(cfg.vocab), 1, start_step=step41)
    out["elastic_loss"] = rep3.final_loss
    out["refused"] = None
    if not root:  # a client on another rank is refused before any collective
        try:
            Trainer(cfg, ctx=ctx, ckpt=object())
        except ValueError as e:
            out["refused"] = "world rank 0" in str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch(_rank, data=2, model=2, device="cpu", timeout=600)


def test_checkpoint_bytes_equal_one_process_serialization(ranks):
    """What rank 0 wrote is ``serialize_pytree`` of the whole state, unsharded
    on every rank by all-gathers."""
    root = ranks[0]
    np.testing.assert_array_equal(root["bytes2"], root["serialized2"])
    assert root["bytes4"].size == root["bytes2"].size > 0


def test_the_jax_package_restores_the_mesh_checkpoint(ranks):
    import jax

    from repro.configs import get_smoke as jget
    from repro.models.model import build as jbuild
    from repro.sharding import ParamSpec as JParamSpec
    from repro.storage import checkpoint as jck

    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jbuild(jget(ARCH)).param_specs(),
                         is_leaf=lambda x: isinstance(x, JParamSpec))
    template = {"params": zeros, "m": zeros, "v": zeros, "step": np.int32(0)}
    back = flatten(jck.deserialize_pytree(ranks[0]["bytes2"].tobytes(), template))
    saved = ranks[0]["saved2"]
    assert list(back) == list(saved)
    for k, v in back.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(saved[k]), err_msg=k)


def test_restores_into_the_mesh_one_process_and_a_4x1_mesh(ranks):
    for r in ranks:
        assert r["restored_step"] == r["elastic_step"] == 2 * CKPT_EVERY
        assert r["mesh_equal"] and r["elastic_equal"] and r["elastic_shapes_differ"]
        assert np.isfinite(r["elastic_loss"])
    assert ranks[0]["one_step"] == 2 * CKPT_EVERY and ranks[0]["one_equal"]
    assert len({r["elastic_loss"] for r in ranks}) == 1


def test_a_lost_sp_is_repaired_between_save_and_restore(ranks):
    root = ranks[0]
    assert root["repairs_verified"]
    (_, _, repairs1, _), (_, _, repairs2, _) = root["reports"]
    assert repairs1 == 0 and repairs2 > 0  # the chunks step 2's checkpoint lost


def test_reports_and_restarts_agree_on_every_rank(ranks):
    for r in ranks:
        assert r["reports"] == ranks[0]["reports"] and r["restarts"] == 1
    (steps, nbytes, _, losses), _ = ranks[0]["reports"]
    assert steps == CKPT_EVERY and nbytes == ranks[0]["bytes2"].size and all(np.isfinite(losses))


def test_trainer_on_a_mesh_refuses_a_client_off_rank_0(ranks):
    """Only world rank 0 holds the Shelby client (``ckpt`` / ``repair``)."""
    assert [r["refused"] for r in ranks] == [None, True, True, True]
