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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
                "chip_smoke.py"):
        assert rel in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_round_trip_with_jax_and_reference_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import repro_torch
        from repro_torch.launch.cluster import build_cluster
        contract, sps, rpc, client = build_cluster(device="cpu")
        data = np.random.default_rng(1).integers(0, 256, 400_000, dtype=np.uint8).tobytes()
        meta = client.put(data)
        assert client.get(meta.blob_id) == data
        assert client.get(meta.blob_id, 250_000, 70_000) == data[250_000:320_000]
        client.settle()

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
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
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
    from repro_torch.net.events import EventLoop

    with pytest.raises(NotImplementedError):
        EventLoop(sanitize=True)
