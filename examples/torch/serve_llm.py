"""Serve a small LM whose weights are distributed THROUGH Shelby (§6 "AI
and Data Marketplaces"), on the port: the inference node performs paid,
verified reads of the weight blob, reconstructs the checkpoint, and serves
batched requests with a KV cache — even with an SP down mid-download.

    PYTHONPATH=src python examples/torch/serve_llm.py [--device cpu]

The program of ``examples/serve_llm.py`` on ``repro_torch``: the cluster
comes from ``launch/cluster.py::build_cluster``, the weights from
``sharding.init_params`` with a ``torch.Generator`` seeded 42 (other
numbers than the reference's ``jax.random.PRNGKey(42)``, the same init
rules); the restored weights are moved to ``--device`` (the reference's
``jax.tree.map(jnp.asarray, ...)``), where the Clay path runs ``gf_matmul``
and every decode step's attention ``flash_attention``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.cluster import build_cluster
from repro_torch.models.model import build
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import init_params
from repro_torch.storage.checkpoint import CheckpointManager

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device (default: the card)")
device = resolve_device(ap.parse_args().device)

cfg = get_smoke("granite-8b")
contract, sps, rpc, client = build_cluster(num_sps=8, device=device)

# publisher: push trained weights into Shelby (drawn on the host: the same on every device)
model = build(cfg)
params = init_params(model.param_specs(), torch.Generator().manual_seed(42), device=device)
ckpt = CheckpointManager(client, num_host_shards=2)
rec = ckpt.save(step=1000, state=params)
print(f"published weights: {rec.total_bytes} bytes across blobs {rec.shard_blob_ids}")

# adversity: one SP goes down between publish and serve
victim = contract.blobs[rec.shard_blob_ids[0]].placement[(0, 0)]
sps[victim].crash()
print(f"SP {victim} crashed; weight download proceeds via k-of-n reads")

# inference node: paid verified reads -> engine -> batched generation
served_params = ckpt.restore(1000, params)  # host tensors, as read
served_params = {k: v.to(device) for k, v in served_params.items()}
engine = ServeEngine(cfg, served_params, max_len=64)

prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 8)).astype(np.int32)
out = engine.generate(prompts, num_tokens=16)
print(f"served batch: prompts {prompts.shape} -> completions {out.shape}")
assert out.shape == (4, 24) and (out[:, :8] == prompts).all()
settlement = client.settle()  # weight-download reads settle per serving node
print(f"decoded {engine.stats.decoded_tokens} tokens; weight-read payments "
      f"${settlement.total_node_income:.9f} settled; SPs realized "
      f"${sum(settlement.sp_income.values()):.6f}; cache hits {rpc.stats.cache_hits}")
