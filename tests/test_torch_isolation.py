"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
runs with both blocked, and never falls back to the CPU on its own."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples" / "torch").glob("*.py"))
              + sorted((ROOT / "scripts").glob("*_torch.py")))


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/kernels/gf_matmul.py", "src/repro_torch/core/clay.py",
                "src/repro_torch/storage/sdk.py", "src/repro_torch/kernels/sample_hash.py",
                "src/repro_torch/kernels/flash_attention.py", "src/repro_torch/models/model.py",
                "src/repro_torch/serve/engine.py", "src/repro_torch/launch/serve.py",
                "src/repro_torch/storage/repair.py", "src/repro_torch/storage/background.py",
                "src/repro_torch/storage/membership.py", "src/repro_torch/net/workloads.py",
                "src/repro_torch/core/simulation.py", "src/repro_torch/core/durability.py",
                "src/repro_torch/core/economics.py", "src/repro_torch/core/extend2d.py",
                "src/repro_torch/storage/das.py", "src/repro_torch/analysis/simsan.py",
                "src/repro_torch/analysis/simlint.py", "src/repro_torch/scenarios/serving.py",
                "src/repro_torch/scenarios/engine.py", "src/repro_torch/scenarios/sweep.py",
                "src/repro_torch/kernels/flash_attention_bwd.py",
                "src/repro_torch/train/optimizer.py", "src/repro_torch/train/step.py",
                "src/repro_torch/train/loop.py", "src/repro_torch/data/pipeline.py",
                "src/repro_torch/launch/train.py", "src/repro_torch/models/moe.py",
                "src/repro_torch/models/mamba.py", "src/repro_torch/configs/hymba.py",
                "src/repro_torch/configs/qwen3_moe.py", "src/repro_torch/configs/falcon_mamba.py",
                "src/repro_torch/configs/phi3_vision.py", "src/repro_torch/models/mla.py",
                "src/repro_torch/configs/deepseek_v2_lite.py",
                "src/repro_torch/configs/whisper_tiny.py", "src/repro_torch/launch/dryrun.py",
                "src/repro_torch/launch/shapes.py", "src/repro_torch/launch/mesh.py",
                "src/repro_torch/launch/cost_analysis.py", "src/repro_torch/distributed.py",
                "chip_smoke.py"):
        assert rel in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_round_trip_with_jax_and_reference_blocked():
    code = textwrap.dedent("""
        import json, pathlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)  # one thread, as launch/mesh.py's ranks: the host is shared
        import repro_torch
        from repro_torch.launch.cluster import build_cluster
        contract, sps, rpc, client = build_cluster(device="cpu")
        data = np.random.default_rng(1).integers(0, 256, 400_000, dtype=np.uint8).tobytes()
        meta = client.put(data)
        assert client.get(meta.blob_id) == data
        assert client.get(meta.blob_id, 250_000, 70_000) == data[250_000:320_000]
        client.settle()
        rec = contract.das[meta.blob_id]
        assert len(rec.placement) == 64 and sum(sp.stored_shares() for sp in sps.values()) == 64
        (verdict,) = client.sample_availability(epoch=0, seed=1)
        assert verdict.available and verdict.verified == 16
        client.settle()

        from repro_torch.net.events import EventLoop
        from repro_torch.storage.membership import ChurnSpec, MembershipPlane
        from repro_torch.storage.repair import RepairCoordinator
        victim = meta.placement[(0, 0)]
        sps[victim].wipe()
        reports = RepairCoordinator(contract, sps, rpc.layout).repair_all()
        assert reports and all(r.mode == "msr" and r.verified for r in reports)
        rpc._cache.clear()
        assert client.get(meta.blob_id) == data
        plane = MembershipPlane(contract, sps, rpc.layout,
                                ChurnSpec(p_crash=0.2, joins_per_epoch=1, min_active=6, seed=1),
                                repair=RepairCoordinator(contract, sps, rpc.layout),
                                fleet=client.fleet, epochs=2)
        loop = EventLoop()
        for p in plane.planes():
            p.spawn(loop)
        loop.run()
        assert len(plane.epoch_stats) == 2 and plane.lost_chunksets == 0
        rpc._cache.clear()
        assert client.get(meta.blob_id) == data

        from repro_torch.analysis import lint_paths
        from repro_torch.scenarios import REGISTRY, load_builtin, run_scenario
        load_builtin()
        assert len(REGISTRY) == 7 and lint_paths()
        import contextlib, io
        with contextlib.redirect_stdout(io.StringIO()):  # the scenario's report rows
            res = run_scenario("tune_admission", smoke=True, emit=False, device="cpu")
        assert res.slos_ok and res.digest

        import torch
        import repro_torch.models, repro_torch.serve, repro_torch.launch.serve
        from repro_torch.configs import get_smoke
        from repro_torch.core.commitments import bulk_sample_digests
        from repro_torch.models.model import build
        from repro_torch.sharding import init_params
        cfg = get_smoke("yi-9b")
        model = build(cfg)
        params = init_params(model.param_specs(), torch.Generator().manual_seed(0), device="cpu")
        cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in model.cache_specs(2, 4).items()}
        logits, _ = model.decode_step(params, cache, torch.tensor([[1], [2]]), 0)
        assert logits.shape == (2, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
        samples = np.random.default_rng(2).integers(0, 256, (3, 1024), dtype=np.uint8)
        assert bulk_sample_digests(samples, device="cpu").shape == (3,)

        from repro_torch.data.pipeline import BlobTokenDataset, write_token_corpus
        from repro_torch.train.loop import Trainer
        bid = write_token_corpus(client, np.arange(5_000, dtype=np.int32) % cfg.vocab)
        x, y = next(BlobTokenDataset(client, bid, batch=2, seq_len=8).batches(1))
        trainer = Trainer(cfg, num_microbatches=2, device="cpu")
        state, rep = trainer.run(trainer.init_state(), iter([(x, y)]), 1)
        assert int(state["step"]) == 1 and np.isfinite(rep.final_loss)

        # one train step and one decode step of each family the port builds
        for arch in ("phi-3-vision-4.2b", "qwen3-moe-30b-a3b", "falcon-mamba-7b", "hymba-1.5b",
                     "deepseek-v2-lite-16b", "whisper-tiny"):
            fcfg = get_smoke(arch)
            trainer = Trainer(fcfg, device="cpu")
            state, rep = trainer.run(trainer.init_state(), iter([(x, y)]), 1)
            assert int(state["step"]) == 1 and np.isfinite(rep.final_loss), arch
            fmodel = build(fcfg)
            cache = {k: torch.zeros(s.shape, dtype=s.dtype)
                     for k, s in fmodel.cache_specs(2, 4, long_mode=True).items()}
            logits, _ = fmodel.decode_step(state["params"], cache, torch.tensor([[1], [2]]), 0,
                                           long_mode=True)
            assert bool(torch.isfinite(logits).all()), arch

        # the dry-run: one cell of each kind through the CLI, on the meta device
        import tempfile
        from repro_torch.launch import dryrun
        with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
            for shape in ("train_4k", "decode_32k"):
                dryrun.main(["--arch", "whisper-tiny", "--shape", shape, "--out", out])
            dryrun.main(["--arch", "hymba-1.5b", "--shape", "long_500k", "--mesh", "multi",
                         "--out", out])
            recs = [json.loads(p.read_text()) for p in sorted(pathlib.Path(out).glob("*.json"))]
        assert [r["status"] for r in recs] == ["ok"] * 3
        assert all(r["memory"]["peak_bytes"] <= dryrun.H100_BUDGET_BYTES for r in recs)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.launch.cluster import build_cluster

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cluster(device="cuda")


def test_sanitizer_is_refused_until_ported():
    """The sanitizer is ported: a sanitized loop carries the port's own
    simsan, and a fault it exists to catch raises its error."""
    from repro_torch.analysis.simsan import Sanitizer, SanitizerError
    from repro_torch.net.events import Acquire, EventLoop

    loop = EventLoop(sanitize=True)
    assert isinstance(loop._san, Sanitizer)

    def leaker():
        yield Acquire(("sp", 0), 1)

    loop.spawn(leaker(), label="leaker")
    with pytest.raises(SanitizerError, match="leak"):
        loop.run()
