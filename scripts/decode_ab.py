#!/usr/bin/env python3
"""Warm decode tok/s of the served model, for comparing two checkouts on one GPU.

    python scripts/decode_ab.py SRC_ROOT [--generations 9] [--trace]

Imports ``repro_torch`` from ``SRC_ROOT`` (a checkout's ``src``), builds the
serving path's model (yi-9b at its published widths, 2 layers, random f32
weights from a seed) on the card, and times ``--generations`` warm greedy
generations of batch 4 x (prompt 8 + 16 tokens), 92 decoded tokens each,
after one untimed generation.  Prints one JSON line; with ``--trace`` it
also traces one more generation with ``torch.profiler`` and reports the
card's busy time (the sum of kernel durations), the span from the first
kernel's start to the last one's end, and the attention kernels' share.
Decode at this size is
host-bound, so compare two checkouts in one call and in turns, each in its
own process, for example the parent unpacked with ``git archive``:

    for s in build/parent/src src build/parent/src src; do python scripts/decode_ab.py $s; done
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="the checkout's src directory")
    ap.add_argument("--generations", type=int, default=9)
    ap.add_argument("--trace", action="store_true", help="also trace one generation")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.configs import get
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import init_params

    cfg = dataclasses.replace(get("yi-9b"), num_layers=2)
    params = init_params(build(cfg).param_specs(),
                         torch.Generator(device="cuda").manual_seed(0), device="cuda")
    engine = ServeEngine(cfg, params, max_len=25)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 8)).astype(np.int32)
    engine.generate(prompts, num_tokens=16)  # builds the kernels, warms the allocator
    secs = []
    for _ in range(args.generations):
        t = time.perf_counter()
        engine.generate(prompts, num_tokens=16)  # ends with a copy to the host
        secs.append(time.perf_counter() - t)
    secs.sort()
    tokens = 4 * 23  # 23 decode steps of batch 4
    row = {"src": args.src, "device": torch.cuda.get_device_name(0),
           "tok/s median": tokens / secs[len(secs) // 2], "tok/s best": tokens / secs[0],
           "s": secs}
    if args.trace:
        row["trace"] = trace_generation(lambda: engine.generate(prompts, num_tokens=16))
    print(json.dumps(row))
    return 0


def trace_generation(fn) -> dict:
    """Kernel time of one call of ``fn`` from a ``torch.profiler`` trace (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not events:
        return {"kernels": 0}
    attention = [e for e in events if "attn_" in e["name"] or "flash_attention" in e["name"]]
    return {"kernels": len(events), "busy_ms": sum(e["dur"] for e in events) / 1e3,
            "span_ms": (max(e["ts"] + e["dur"] for e in events)
                        - min(e["ts"] for e in events)) / 1e3,
            "attention_launches": len(attention),
            "attention_ms": sum(e["dur"] for e in attention) / 1e3}


if __name__ == "__main__":
    sys.exit(main())
