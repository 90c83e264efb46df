"""Serving driver: batched requests against weights distributed through Shelby.

The inference-node lifecycle of the paper's §6: a publisher puts the model's
weights as a checkpoint through the Shelby client, an SP may crash, the
inference node pulls the weight blobs through paid, verified k-of-n reads
and serves batched greedy generation with a KV cache.  Counterpart of the
JAX package's ``repro/launch/serve.py`` on ``launch/cluster.py``'s
deployment (which has no DAS plane), on one device:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \\
      --batch 4 --prompt-len 8 --gen 16 [--kill-sp] [--device cpu]

``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get, get_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.cluster import build_cluster
from repro_torch.models.model import build
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import init_params
from repro_torch.storage.checkpoint import CheckpointManager, CheckpointRecord


@dataclasses.dataclass
class ServeRun:
    """What one :func:`serve` run published, restored and generated."""

    outputs: np.ndarray  # (B, P + gen) int32
    prompts: np.ndarray  # (B, P) int32
    published: dict[str, torch.Tensor]
    served: dict[str, torch.Tensor]
    record: CheckpointRecord
    publish_s: float
    restore_s: float
    decode_s: float
    decoded_tokens: int


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 8, gen: int = 16,
          kill_sp: bool = False, device=None, seed: int = 7) -> ServeRun:
    dev = resolve_device(device)
    contract, sps, rpc, client = build_cluster(num_sps=8, device=dev)

    # publisher pushes weights into Shelby
    params = init_params(build(cfg).param_specs(),
                         torch.Generator(device=dev).manual_seed(seed), device=dev)
    mgr = CheckpointManager(client, num_host_shards=2)
    t0 = time.perf_counter()
    rec = mgr.save(step=0, state=params)
    publish_s = time.perf_counter() - t0
    print(f"[serve] published {rec.total_bytes} weight bytes in {publish_s:.2f}s "
          f"(blobs {rec.shard_blob_ids}, {rpc.layout.replication_overhead:.2f}x overhead)",
          flush=True)

    if kill_sp:
        victim = contract.blobs[rec.shard_blob_ids[0]].placement[(0, 0)]
        sps[victim].crash()
        print(f"[serve] SP {victim} crashed; download proceeds k-of-n", flush=True)

    t0 = time.perf_counter()
    served = {k: v.to(dev) for k, v in mgr.restore(0, params).items()}
    _synchronize(dev)
    restore_s = time.perf_counter() - t0
    print(f"[serve] weights restored+verified in {restore_s:.2f}s; "
          f"read payments ${rpc.stats.payments:.6f}", flush=True)

    engine = ServeEngine(cfg, served, max_len=prompt_len + gen + 1)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    t1 = time.perf_counter()
    out = engine.generate(prompts, num_tokens=gen)  # ends with a copy to the host
    decode_s = time.perf_counter() - t1
    tok = engine.stats.decoded_tokens
    print(f"[serve] batch {out.shape}: {tok} tokens in {decode_s:.2f}s "
          f"({tok / decode_s:.1f} tok/s on {dev})", flush=True)
    if not (out[:, :prompt_len] == prompts).all():
        raise RuntimeError("the served completions do not start with their prompts")
    return ServeRun(out, prompts, params, served, rec, publish_s, restore_s, decode_s, tok)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kill-sp", action="store_true",
                    help="crash an SP between publish and serve")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                 kill_sp=args.kill_sp, device=args.device).outputs


if __name__ == "__main__":
    main()
