#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # 1 GiB blob at the production layout
    python3 chip_smoke.py --blob-mib 256   # a smaller blob

Phases, each ended by ``torch.cuda.synchronize()`` so a kernel fault shows in
the phase that caused it; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``); build every CUDA kernel
   of the port from the checkout's sources, one ``nvcc`` each, in parallel;
2. every kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (``gf_matmul`` also at the serving path's Clay (4,2)
   encode and at an N = 8 (mod 16) decode, with its ptxas lines printed in
   phase 1): ``gf_matmul`` and ``sample_hash`` with exact
   equality (their arithmetic is exact), ``flash_attention`` within the
   tolerance stated at ``ATTN_TOL``; kernel and plain version timed in turns
   with CUDA events beside the least time the card could take; ``gf_matmul``
   and attention also by their device time from a ``torch.profiler`` trace
   (the ``ms`` they report), attention in turns with
   its earlier CUDA-core kernel and ``scaled_dot_product_attention`` (a
   yardstick the port never calls), with the kernel the dispatch rule picked;
3. the storage path at production size: a (10,6) Clay / 10 MiB-chunkset
   cluster of 24 SPs in 5 DCs, put a seeded blob, read it whole and at 3
   ranges across chunksets, crash 2 SPs and read again, mark one SP
   corrupt and read again, settle; bytes compared with the input, kernel
   launches counted per phase (each must be > 0);
4. the audit path: the bulk digests of every 1 KiB sample of every chunk
   the put stored, checked against the plain version on the CPU;
5. a device encode/decode against the CPU plain path on one chunkset;
6. the put's and a read's steps timed alone (partition, device encode,
   device-to-host copy, host SHA-256 Merkle commitments, decode);
7. the device's busy and idle share over a put and a whole read of the same
   blob on a fresh cluster, from a ``torch.profiler`` trace of the card
   (kernels, copies and memsets, overlaps merged), and the device ms of all
   ``gf_matmul`` launches in each (kernel events by name);
8. the serving path at yi-9b's published widths, depth cut to 2 layers:
   publish the weights through Shelby, crash an SP, restore them by paid
   k-of-n reads, serve batch 4 x (prompt 8 + 16 generated tokens); the
   served model teacher-forced for two steps on the card and on the CPU
   plain path; decode tok/s as the median of nine warm generations;
9. the card again, one JSON line per kernel, then the result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, the nearest listed integer rate
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
H100_FP32_OPS_PER_S = 67e12  # 32-bit CUDA-core peak (fp32), the rate of sample_hash's u32 ops
KERNELS = {  # name -> (source, the Pallas kernel it replaces)
    "gf_matmul": ("src/repro_torch/kernels/csrc/gf_matmul.cu",
                  "src/repro/kernels/gf_matmul.py:68"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
    "sample_hash": ("src/repro_torch/kernels/csrc/sample_hash.cu",
                    "src/repro/kernels/sample_hash.py:49"),
}
# flash_attention against its plain version: f32 to summation order; bf16
# outputs are the same f32 result rounded, so within one rounding step
ATTN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2**-7, 2**-7)}  # (atol, rtol)
SERVE_ARCH, SERVE_LAYERS = "yi-9b", 2  # published widths; depth cut from 48 (host-bound publish)
# warm decode is host-bound and single generations swing by a third: the median of nine
WARM_GENERATIONS = 9


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def _time_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gf_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for C = A (x) B: each input byte read once, each output
    byte written once, or 2*M*K*N operations at the int8 peak."""
    bytes_ms = (m * k + k * n + m * n) / H100_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m * k * n / H100_INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def gf_shapes(blob_mib: int) -> dict[str, tuple[int, int, int]]:
    """The (M, K, N) shapes at which phase 2 times ``gf_matmul``, by name:
    Clay (10,6) at the production layout (M 6; K 12 known flats per plane,
    10 data + 2 virtual) for a blob of ``blob_mib`` MiB, and the serving
    path's Clay (4,2) encode."""
    from repro_torch.configs.shelby import CONFIG
    from repro_torch.launch.cluster import build_cluster

    lay = CONFIG.layout
    alpha, w, m, kk = lay.code.alpha, lay.w, lay.m, lay.code.N - lay.m
    n_cs = -(-blob_mib * 2**20 // lay.chunkset_bytes)
    serve = build_cluster(device="cuda")[2].layout
    shapes = {"encode_one_chunkset": (m, kk, alpha * w),
              "ragged_byte_path": (m, kk, 3 * alpha * w + 17)}
    shapes.update({f"decode_{g}_planes": (m, kk, g * w * n_cs) for g in (6, 48, 60, 102)})
    shapes["encode_blob"] = (m, kk, alpha * w * n_cs)  # the put's encode of the whole blob
    # an odd plane group x an odd chunkset count: N = 8 (mod 16), the 8-byte path
    shapes["decode_5_planes_8byte_path"] = (m, kk, 5 * w * (n_cs | 1))
    # as many chunksets as one solve stacks
    shapes["serve_encode_clay_4_2"] = (
        serve.m, serve.code.N - serve.m,
        serve.code.alpha * serve.w * serve.code.stack_limit(serve.w))
    return shapes


def _traced(fn) -> tuple[float, list[dict]]:
    """Run ``fn`` under ``torch.profiler`` with CUDA activity only; return
    its wall seconds and the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return wall, json.load(f)["traceEvents"]


PROFILER_TRIES = 3  # a trace now and then comes back without its kernel events


def _device_ms(fn, iters: int) -> tuple[float, int]:
    """Device time per call of ``fn``: the durations of the CUDA kernels in a
    ``torch.profiler`` trace of ``iters`` calls (after one untraced call),
    summed and divided by ``iters``; and the number of traces it took.  Host
    time between launches is left out.  A trace without kernel events is
    taken again, up to ``PROFILER_TRIES`` times."""
    import torch

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILER_TRIES + 1):
        _, events = _traced(lambda: [fn() for _ in range(iters)])
        kernels = [float(e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if kernels:
            return sum(kernels) / iters / 1e3, tries  # trace times are microseconds
    raise SystemExit(f"{PROFILER_TRIES} profiler traces show no kernel on the card")


def device_busy(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``; return its wall seconds and the
    seconds the card spent in kernels, copies or memsets (the union of their
    intervals from the trace)."""
    wall, events = _traced(fn)
    spans = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in spans:
            spans[e["cat"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def union_s(intervals) -> float:
        busy, end = 0.0, float("-inf")
        for a, b in sorted(intervals):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6  # trace times are microseconds

    every = [iv for ivs in spans.values() for iv in ivs]
    busy = union_s(every)
    gf = [float(e["dur"]) for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
          and "gf_matmul" in e.get("name", "")]
    return {"wall_s": wall, "device_busy_s": busy if every else None,
            "kernel_s": union_s(spans["kernel"]), "copy_s": union_s(spans["gpu_memcpy"]),
            "device_events": len(every),
            "idle_share": 1.0 - busy / wall if every else None,
            "gf_matmul_kernels": len(gf), "gf_matmul_device_ms": sum(gf) / 1e3}


def check_gf_matmul(shapes, gen, timed: set) -> list[dict]:
    import torch

    from repro_torch.kernels import gf_matmul as gk

    rows = []
    for m, k, n in shapes:
        a = torch.randint(0, 256, (m, k), dtype=torch.uint8, device="cuda", generator=gen)
        if m > 1:
            a[m // 2] = 0  # an all-zero coefficient row
        b = torch.randint(0, 256, (k, n), dtype=torch.uint8, device="cuda", generator=gen)
        out = gk.gf_matmul(a, b)
        ref = gk.gf_matmul_ref(a, b)
        torch.cuda.synchronize()
        mismatches = int((out != ref).sum())
        max_err = int((out.int() - ref.int()).abs().max())
        row = {"m": m, "k": k, "n": n, "mismatches": mismatches, "max_abs_err": max_err}
        if (m, k, n) in timed:
            iters = 10 if n > 10**7 else 50
            plain_a = _time_ms(lambda: gk.gf_matmul_ref(a, b), 2)
            kern_a = _time_ms(lambda: gk.gf_matmul(a, b), iters)
            kern_b = _time_ms(lambda: gk.gf_matmul(a, b), iters)
            plain_b = _time_ms(lambda: gk.gf_matmul_ref(a, b), 2)
            # device time from a profiler trace: at small N the wrapper's host
            # time per call exceeds the kernel's, and CUDA events around a
            # loop of calls measure the host
            dev, traces = _device_ms(lambda: gk.gf_matmul(a, b), iters)
            bound, by = gf_bound_ms(m, k, n)
            row.update(ms=dev, host_ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
                       bound_ms=bound, bound_by=by, traces=traces)
        print(json.dumps({"gf_matmul_check": row}), flush=True)
        if mismatches:
            raise SystemExit(f"gf_matmul disagrees with its plain version at {(m, k, n)}")
        rows.append(row)
        del a, b, out, ref
    torch.cuda.synchronize()
    return rows


def sample_hash_bound_ms(leaves: int, words: int) -> tuple[float, str]:
    """Least time for the digests: each word read once, each digest written
    once, or 4 u32 operations per word plus 8 per digest at the 32-bit rate."""
    bytes_ms = 4 * leaves * (words + 1) / H100_BYTES_PER_S * 1e3
    ops_ms = leaves * (4 * words + 8) / H100_FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_sample_hash(cases, gen, timed: set) -> list[dict]:
    import torch

    from repro_torch.kernels import sample_hash as sh

    rows = []
    for leaves, words, seed in cases:
        w = torch.randint(-2**31, 2**31, (leaves, words), dtype=torch.int32, device="cuda",
                          generator=gen).view(torch.uint32)
        out = sh.sample_hash(w, seed=seed).view(torch.int32)
        ref = sh.sample_hash_ref(w, seed=seed).view(torch.int32)
        torch.cuda.synchronize()
        mismatches = int((out != ref).sum())
        row = {"leaves": leaves, "words": words, "seed": seed, "mismatches": mismatches,
               "max_abs_err": int((out.long() - ref.long()).abs().max())}
        if (leaves, words, seed) in timed:
            plain_a = _time_ms(lambda: sh.sample_hash_ref(w, seed=seed), 2)
            kern_a = _time_ms(lambda: sh.sample_hash(w, seed=seed), 20)
            kern_b = _time_ms(lambda: sh.sample_hash(w, seed=seed), 20)
            plain_b = _time_ms(lambda: sh.sample_hash_ref(w, seed=seed), 2)
            bound, by = sample_hash_bound_ms(leaves, words)
            row.update(ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
                       bound_ms=bound, bound_by=by, library_ms=None)
        print(json.dumps({"sample_hash_check": row}), flush=True)
        if mismatches:
            raise SystemExit(f"sample_hash disagrees with its plain version at {(leaves, words)}")
        rows.append(row)
        del w, out, ref
    torch.cuda.synchronize()
    return rows


def attention_bound_ms(q, k, vis) -> tuple[float, str]:
    """Least time for attention with the (Sq, Sk) visibility ``vis``: 4 * hd
    operations per visible (query, key) pair and query head at the bf16 peak,
    or Q and O moved once, K and V once for each slot some query sees (a
    slot no query sees need not be read) and both position arrays once."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    ops_ms = 4.0 * hd * int(vis.sum()) * b * h / H100_BF16_FLOPS * 1e3
    kv_bytes = 2 * b * int(vis.any(0).sum()) * hkv * hd * k.element_size()
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + 4 * (sq + sk)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_flash_attention(cases, gen) -> list[dict]:
    """cases: (name, b, sq, sk, h, hkv, hd, causal, window, q_positions, k_positions).

    Each case: the kernel the wrapper's rule picks against the plain version
    within ``ATTN_TOL``; then timed in turns with the earlier CUDA-core
    kernel (the "general" kernel, ``previous``) and with ``scaled_dot_product_attention``
    (``library``): CUDA events around a loop of calls give the host-inclusive
    time per call (``*host_ms``); a ``torch.profiler`` trace of the same calls
    gives the device time per call (``ms``, ``previous_ms``, ``library_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    rows = []
    for name, b, sq, sk, h, hkv, hd, causal, window, qpos, kpos in cases:
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda").bfloat16()
        kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
        before = dict(fa.flash_attention.variant_launches)
        out = fa.flash_attention(q, k, v, **kw)
        variant = next(n for n, c in fa.flash_attention.variant_launches.items() if c > before[n])
        ref = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        atol, rtol = ATTN_TOL["bfloat16"]
        bad = int((err > atol + rtol * ref.float().abs()).sum())
        vis = fa.visible(qpos, kpos, causal, window)
        # the library yardstick: SDPA on (B, H, S, hd) views; its boolean mask is "may attend"
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        arange = sq == sk and torch.equal(qpos, torch.arange(sk, dtype=qpos.dtype, device="cuda"))
        mask = None if (causal and not window and arange) else vis
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=mask is None, enable_gqa=True)

        seen = vis.any(1)  # SDPA gives NaN for a row that sees no key
        lib_err = float((lib().transpose(1, 2).float() - ref.float())[:, seen].abs().max())
        def kern():
            return fa.flash_attention(q, k, v, **kw)

        def prev():
            return fa.flash_attention_variant("general", q, k, v, **kw)

        iters = 20 if sq * sk < 10**6 else 5
        plain_a = _time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), 3)
        host = {"previous": [_time_ms(prev, iters)], "kernel": [_time_ms(kern, iters)]}
        host["library"] = [_time_ms(lib, iters)]
        host["kernel"].append(_time_ms(kern, iters))
        host["previous"].append(_time_ms(prev, iters))
        plain_b = _time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), 3)
        dev, traces = {}, 0
        for what, fn in (("kernel", kern), ("previous", prev), ("library", lib)):
            dev[what], tries = _device_ms(fn, iters)
            traces += tries
        bound, by = attention_bound_ms(q, k, vis)
        row = {"case": name, "shape": [b, sq, sk, h, hkv, hd], "causal": causal,
               "window": window, "dtype": "bfloat16", "variant": variant, "violations": bad,
               "max_abs_err": float(err.max()), "library_max_abs_err": lib_err,
               "ms": dev["kernel"], "host_ms": min(host["kernel"]),
               "previous_ms": dev["previous"], "previous_host_ms": min(host["previous"]),
               "library_ms": dev["library"], "library_host_ms": host["library"][0],
               "plain_ms": min(plain_a, plain_b), "bound_ms": bound, "bound_by": by,
               "faster_than_previous": dev["kernel"] < dev["previous"], "traces": traces}
        print(json.dumps({"flash_attention_check": row}), flush=True)
        if bad:
            raise SystemExit(f"flash_attention disagrees with its plain version in case {name}")
        rows.append(row)
        del q, k, v, out, ref
    # f32 inputs too, at one shape of each kind: the "general" kernel
    for b, sq, sk, h, hkv, hd, causal, window in [(2, 300, 300, 32, 4, 128, True, 0),
                                                   (4, 1, 25, 32, 4, 128, True, 0),
                                                   (2, 37, 91, 6, 3, 64, False, 7)]:
        q = torch.randn((b, sq, h, hd), generator=gen, device="cuda")
        k = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda")
        v = torch.randn((b, sk, hkv, hd), generator=gen, device="cuda")
        kw = dict(q_positions=torch.arange(sk - sq, sk, device="cuda"), causal=causal,
                  window=window)
        general = fa.flash_attention.variant_launches["general"]
        out, ref = fa.flash_attention(q, k, v, **kw), fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL["float32"]
        bad = int(((out - ref).abs() > atol + rtol * ref.abs()).sum())
        print(json.dumps({"flash_attention_check": {
            "shape": [b, sq, sk, h, hkv, hd], "causal": causal, "window": window,
            "dtype": "float32", "variant": "general", "violations": bad,
            "max_abs_err": float((out - ref).abs().max())}}), flush=True)
        if bad:
            raise SystemExit(f"flash_attention disagrees with its plain version in f32 at {b, sq, sk}")
        if fa.flash_attention.variant_launches["general"] != general + 1:
            raise SystemExit("f32 attention did not go to the general kernel")
    torch.cuda.synchronize()
    return rows


def audit_samples(sps, meta, chunk_bytes: int) -> np.ndarray:
    """Every 1 KiB sample of every chunk the put stored, as (L, 1024) uint8,
    each chunk zero-padded to whole samples as ``commitments.chunk_samples`` does."""
    from repro_torch.core.commitments import SAMPLE_BYTES

    per = -(-chunk_bytes // SAMPLE_BYTES)
    keys = sorted(meta.placement)
    out = np.zeros((len(keys), per * SAMPLE_BYTES), np.uint8)
    for row, (cs, c) in enumerate(keys):
        chunk, _ = sps[meta.placement[(cs, c)]].serve_chunk(meta.blob_id, cs, c)
        out[row, :chunk_bytes] = chunk.reshape(-1)
    return out.reshape(-1, SAMPLE_BYTES)


SERVE_LOGIT_ATOL = 0.15  # bf16 logits, card vs CPU: the two round products differently


def serve_card_vs_cpu(cfg, run, steps: int = 2) -> dict:
    """The served model, teacher-forced on the first ``steps`` tokens of its
    own outputs, decoded on the card and on the CPU plain path from the same
    restored weights: bf16 logits within ``SERVE_LOGIT_ATOL``."""
    import torch

    from repro_torch.models.model import build

    model = build(cfg)
    weights = {"cuda": run.served, "cpu": {k: t.cpu() for k, t in run.served.items()}}
    caches = {dev: {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                    for k, s in model.cache_specs(run.outputs.shape[0], steps).items()}
              for dev in weights}
    toks = torch.as_tensor(run.outputs[:, :steps], dtype=torch.int64)
    worst = scale = 0.0
    with torch.inference_mode():
        for pos in range(steps):
            logits = {}
            for dev, params in weights.items():
                out, caches[dev] = model.decode_step(params, caches[dev],
                                                     toks[:, pos:pos + 1].to(dev), pos)
                logits[dev] = out.float().cpu()
            if not torch.isfinite(logits["cuda"]).all():
                raise SystemExit("non-finite logits on the card")
            worst = max(worst, float((logits["cuda"] - logits["cpu"]).abs().max()))
            scale = max(scale, float(logits["cpu"].abs().max()))
    row = {"arch": cfg.name, "layers": cfg.num_layers, "steps": steps,
           "max_abs_logit_err": worst, "max_abs_logit": scale, "atol": SERVE_LOGIT_ATOL}
    print(json.dumps({"serve_card_vs_cpu": row}), flush=True)
    if worst > SERVE_LOGIT_ATOL:
        raise SystemExit("the served model's decode on the card disagrees with the CPU plain path")
    del weights
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blob-mib", type=int, default=1024, help="blob size in MiB (default 1024)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.shelby import CONFIG
    from repro_torch.core import commitments as cm
    from repro_torch.core.clay import ClayCode
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf_matmul as gk
    from repro_torch.kernels import sample_hash as sh
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.models.attention import ring_positions

    wrappers = {"gf_matmul": gk.gf_matmul, "flash_attention": fa.flash_attention,
                "sample_hash": sh.sample_hash}
    path_launches: dict[str, dict[str, int]] = {}  # path -> kernel -> launches

    variant_launches: dict[str, dict[str, int]] = {}  # path -> attention kernel -> launches

    def zero_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0
        fa.reset_launches()

    def read_counts(path: str) -> dict[str, int]:
        path_launches[path] = {name: fn.launches for name, fn in wrappers.items()}
        variant_launches[path] = dict(fa.flash_attention.variant_launches)
        print(json.dumps({"path": path, "launches": path_launches[path],
                          "flash_attention_variants": variant_launches[path]}), flush=True)
        return path_launches[path]

    # -- 1. card, build ------------------------------------------------------------
    _phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    t0 = time.perf_counter()
    # one nvcc per csrc/<name>.cu, all started together (each waits in its own thread)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda lib: lib(), (gk._lib, sh._lib, fa._lib)))
    print(f"kernel build+load ({', '.join(KERNELS)}): {time.perf_counter() - t0:.3f} s",
          flush=True)
    from repro_torch.kernels import _build

    ptxas = {name: _build.ptxas_report(name) for name in ("gf_matmul", "flash_attention")}
    for name, lines in ptxas.items():  # registers, spills, shared memory
        for line in lines:
            print(f"ptxas {name}: {line}", flush=True)
    print(json.dumps({"gf_matmul_ptxas": {
        "kernels": sum("Compiling entry" in ln for ln in ptxas["gf_matmul"]),
        "spill_bytes": sum(int(x) for ln in ptxas["gf_matmul"]
                           for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))}}),
          flush=True)

    # -- 2. kernels against their plain versions --------------------------------------
    _phase("gf_matmul vs plain")
    lay = CONFIG.layout
    alpha, w, k, m = ClayCode(lay.k, lay.m, device="cuda").alpha, lay.w, lay.k, lay.m
    n_cs = -(-args.blob_mib * 2**20 // lay.chunkset_bytes)
    timed_shapes = gf_shapes(args.blob_mib)
    enc_blob = timed_shapes["encode_blob"]
    shapes = [*timed_shapes.values(), (4, 4, 65536), (1, 4, 65536), (1, 1, 1_000_003),
              (1, 17, alpha * w), (32, 32, 100_003)]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    checks = check_gf_matmul(shapes, gen, timed=set(timed_shapes.values()))
    max_err = max(r["max_abs_err"] for r in checks)
    mismatches = sum(r["mismatches"] for r in checks)

    _phase("sample_hash vs plain")
    chunk_samples = -(-lay.chunk_bytes // cm.SAMPLE_BYTES)
    audit_shape = (n_cs * lay.n * chunk_samples, cm.SAMPLE_BYTES // 4, 0)  # the audit path's
    sh_checks = check_sample_hash(
        [audit_shape, audit_shape[:2] + (1,), (1_000_003, 256, 0), (4097, 3, 1), (1, 4, 0)],
        gen, timed={audit_shape})

    _phase("flash_attention vs plain (bf16, yi-9b widths: H 32, Hkv 4, hd 128)")
    serve_batch, serve_prompt, serve_gen = 4, 8, 16
    serve_slots = serve_prompt + serve_gen + 1
    def ar(n, start=0):  # int32, as the serving path passes positions: no cast in the call
        return torch.arange(start, start + n, dtype=torch.int32, device="cuda")

    attn_cases = [
        ("pallas_contract_causal", 1, 2048, 2048, 32, 4, 128, True, 0, ar(2048), ar(2048)),
        ("decode_4096_slots", 16, 1, 4096, 32, 4, 128, True, 0, ar(1, 2047), ar(4096)),
        ("serve_decode", serve_batch, 1, serve_slots, 32, 4, 128, True, 0,
         ar(1, serve_prompt + serve_gen - 2), ar(serve_slots)),
        ("ragged_noncausal_mha", 2, 1000, 1537, 8, 8, 128, False, 0, ar(1000), ar(1537)),
        ("ring_buffer_window", 8, 1, 1024, 32, 4, 128, True, 1024, ar(1, 5000),
         ring_positions(5000, 1024, "cuda")),
        # split decode whose last splits are wholly hidden (slots past pos 1000)
        ("decode_4096_pos1000", 16, 1, 4096, 32, 4, 128, True, 0, ar(1, 1000), ar(4096)),
        # queries -128..127: the first 128 see no key while tiles past 127 are skipped
        ("row_sees_no_key", 1, 256, 512, 32, 4, 128, True, 0, ar(256, -128), ar(512)),
    ]
    attn_checks = check_flash_attention(attn_cases, gen)

    # -- 3. the main path at production size -------------------------------------------
    _phase(f"slice: put/read a {args.blob_mib} MiB blob at (10,6), 10 MiB chunksets")
    contract, sps, rpc, client = build_cluster(
        num_sps=CONFIG.num_sps, layout=CONFIG.layout, device="cuda",
        num_dcs=CONFIG.num_dcs, racks_per_dc=CONFIG.racks_per_dc,
    )
    data = np.random.default_rng(args.seed).bytes(args.blob_mib * 2**20)
    cs_bytes = client.layout.chunkset_bytes
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    phases: dict[str, dict] = {}
    zero_counts()  # count the storage path only
    seen = 0

    def run_phase(name, fn, nbytes):
        nonlocal seen
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = gk.gf_matmul.launches - seen
        seen = gk.gf_matmul.launches
        phases[name] = {"s": dt, "GB/s": nbytes / dt / 1e9, "gf_matmul_launches": launches}
        print(json.dumps({"phase": name, **phases[name]}), flush=True)
        if launches == 0:
            raise SystemExit(f"phase {name!r} made no gf_matmul launch")
        return out

    def clear_caches():
        for node in client.fleet.rpcs:
            node._cache.clear()

    meta = run_phase("put", lambda: client.put(data), len(data))
    got = run_phase("read_whole", lambda: client.get(meta.blob_id), len(data))
    assert got == data, "whole read differs from the blob"
    last = meta.num_chunksets - 1
    ranges = [(cs_bytes - 1000, 5000),
              (cs_bytes * (meta.num_chunksets // 2) - 777, cs_bytes + 1554),
              (cs_bytes * last - 12345, None)]
    for i, (off, ln) in enumerate(ranges):
        clear_caches()
        got = run_phase(f"read_range{i}", lambda: client.get(meta.blob_id, off, ln),
                        ln or len(data) - off)
        assert got == data[off: None if ln is None else off + ln], f"range {i} differs"
    crashed = [meta.placement[(0, 0)], meta.placement[(0, 1)]]
    for sp_id in crashed:
        sps[sp_id].crash()
    clear_caches()
    got = run_phase("read_degraded", lambda: client.get(meta.blob_id), len(data))
    assert got == data, "degraded read differs from the blob"
    corrupt = next(meta.placement[(0, c)] for c in range(2, lay.n)
                   if meta.placement[(0, c)] not in crashed)
    sps[corrupt].behavior.corrupt = True
    bad0 = rpc.stats.chunks_bad
    clear_caches()
    got = run_phase("read_corrupt", lambda: client.get(meta.blob_id), len(data))
    assert got == data, "read with a corrupt SP differs from the blob"
    assert rpc.stats.chunks_bad > bad0, "corrupt chunks were not detected"
    read_counts("storage")
    settlement = client.settle()
    dep = settlement.total_deposited
    out = settlement.total_refunded + settlement.total_node_income
    assert abs(dep - out) <= 1e-6 * max(dep, 1.0), (dep, out)
    print(json.dumps({
        "blob_bytes": len(data), "chunksets": meta.num_chunksets,
        "crashed_sps": crashed, "corrupt_sp": corrupt,
        "chunks_requested": rpc.stats.chunks_requested, "chunks_bad": rpc.stats.chunks_bad,
        "deposited": dep, "refunded_plus_income": out,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }), flush=True)

    # -- 4. the audit path: bulk digests of every stored sample ----------------------
    _phase("audit: bulk digests of every 1 KiB sample the put stored")
    for sp_id in crashed:
        sps[sp_id].recover()
    sps[corrupt].behavior.corrupt = False
    samples = audit_samples(sps, meta, lay.chunk_bytes)
    zero_counts()  # count the audit path only
    t = time.perf_counter()
    digests = cm.bulk_sample_digests(samples, seed=args.seed, device="cuda")
    audit_s = time.perf_counter() - t
    read_counts("audit")
    head = 50_000  # the CPU plain version on the first samples
    assert np.array_equal(digests[:head], cm.bulk_sample_digests(samples[:head], seed=args.seed,
                                                                 device="cpu")), \
        "audit digests on the card differ from the CPU plain path"
    assert digests.shape == (samples.shape[0],) and digests.dtype == np.uint32
    print(json.dumps({"audit": {"samples": samples.shape[0], "bytes": samples.nbytes,
                                "s": audit_s, "GB/s": samples.nbytes / audit_s / 1e9,
                                "distinct_digests": int(np.unique(digests).size)}}), flush=True)
    del samples, digests

    # -- 5. device against the CPU plain path on one chunkset -------------------------
    _phase("encode/decode: card vs CPU plain path, one production chunkset")
    plain = np.frombuffer(data[:cs_bytes], np.uint8).reshape(k, alpha, w).copy()
    dev_code, cpu_code = ClayCode(k, m, device="cuda"), ClayCode(k, m, device="cpu")
    coded = dev_code.encode(plain).cpu()
    assert torch.equal(coded, cpu_code.encode(plain)), "device encode differs from CPU"
    shards = {i: coded[i].numpy() for i in range(k + m) if i not in (0, 3, 7, 11, 12, 15)}
    assert torch.equal(dev_code.decode(shards).cpu(), coded), "device decode differs"
    torch.cuda.synchronize()
    print("card == CPU plain path: ok", flush=True)

    # -- 6. where the put's and a read's time goes: each step timed alone ------------
    _phase("breakdown: steps of the put and of a read, timed alone")

    def timed_step(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    blob_lay = client.layout
    parts, t_part = timed_step(lambda: blob_lay.partition(data))
    coded_dev, t_enc = timed_step(lambda: blob_lay.code.encode_batch(parts))
    coded_host, t_d2h = timed_step(lambda: coded_dev.cpu().numpy())
    del parts, coded_dev
    _, t_hash = timed_step(lambda: [cm.commit_chunk(c) for cw in coded_host for c in cw])
    first_k = [{i: cw[i] for i in range(k)} for cw in coded_host]
    _, t_dec = timed_step(lambda: blob_lay.code.reconstruct_data_batch(first_k))
    print(json.dumps({"breakdown_s": {
        "partition_h2d": t_part, "encode_device": t_enc, "coded_d2h": t_d2h,
        "sha256_merkle_all_chunks": t_hash, "chunks": int(coded_host.shape[0] * (k + m)),
        "h2d_decode_first_k": t_dec,
    }}), flush=True)
    del coded_host, first_k

    # -- 7. how much of a put and a read the card is busy ----------------------------
    _phase("device busy share: put and whole read on a fresh cluster, profiled")
    _, _, _, client2 = build_cluster(
        num_sps=CONFIG.num_sps, layout=CONFIG.layout, device="cuda",
        num_dcs=CONFIG.num_dcs, racks_per_dc=CONFIG.racks_per_dc,
    )
    held = {}
    busy = {"put": device_busy(lambda: held.update(meta=client2.put(data)))}
    busy["read_whole"] = device_busy(lambda: held.update(got=client2.get(held["meta"].blob_id)))
    assert held["got"] == data, "profiled read differs from the blob"
    client2.settle()
    print(json.dumps({"device_busy": busy}), flush=True)
    del client2, held

    # -- 8. the serving path at yi-9b width ---------------------------------------------
    _phase(f"serve: {SERVE_ARCH} at published widths, {SERVE_LAYERS} layers, through Shelby")
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get(SERVE_ARCH), num_layers=SERVE_LAYERS)
    print(json.dumps({"serve_config": {
        "arch": cfg.name, "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab, "norm": cfg.norm, "mlp": cfg.mlp,
        "layers": f"{cfg.num_layers} (cut from {get(SERVE_ARCH).num_layers}: host-bound publish)",
        "params": build(cfg).param_count()}}), flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # count the serving path only
    run = serve(cfg, batch=serve_batch, prompt_len=serve_prompt, gen=serve_gen, kill_sp=True,
                device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    counts = read_counts("serve")
    steps = serve_prompt + serve_gen - 1
    if (counts["gf_matmul"] == 0 or counts["flash_attention"] != steps * SERVE_LAYERS
            or variant_launches["serve"]["split"] != steps * SERVE_LAYERS):
        raise SystemExit(f"the serving path's launches are off: {counts}, "
                         f"attention {variant_launches['serve']}")
    if not all(torch.equal(run.served[k_], run.published[k_]) for k_ in run.published):
        raise SystemExit("restored weights differ from the published ones")
    if not ((run.outputs >= 0) & (run.outputs < cfg.vocab)).all():
        raise SystemExit("generated token ids out of the vocabulary")
    mem = torch.cuda.max_memory_allocated()
    serve_card_vs_cpu(cfg, run)
    # decode again on the same weights, warm: the counted run's decode pays one-time costs
    engine = ServeEngine(cfg, run.served, max_len=serve_prompt + serve_gen + 1)
    warm_s = []
    for _ in range(WARM_GENERATIONS):
        t = time.perf_counter()
        engine.generate(run.prompts, num_tokens=serve_gen)  # ends with a copy to the host
        warm_s.append(time.perf_counter() - t)
    warm_median = sorted(warm_s)[WARM_GENERATIONS // 2]
    nbytes = run.record.total_bytes
    print(json.dumps({"serve": {
        "weight_bytes": nbytes, "publish_s": run.publish_s, "publish_GB/s": nbytes / run.publish_s / 1e9,
        "restore_s": run.restore_s, "restore_GB/s": nbytes / run.restore_s / 1e9,
        "restored_equal": True, "outputs_shape": list(run.outputs.shape),
        "decoded_tokens": run.decoded_tokens, "first_decode_s": run.decode_s,
        "warm_decode_s": warm_s, "decode_tok/s": run.decoded_tokens / warm_median,
        "gf_matmul_launches": counts["gf_matmul"], "attention_launches": counts["flash_attention"],
        "max_memory_allocated": mem,
    }}), flush=True)
    del run, engine

    # -- 9. the kernels line and the result ----------------------------------------------
    timed = {
        "gf_matmul": next(r for r in checks if (r["m"], r["k"], r["n"]) == enc_blob),
        "sample_hash": next(r for r in sh_checks if "ms" in r),
        "flash_attention": next(r for r in attn_checks if r["case"] == "serve_decode"),
    }
    errs = {"gf_matmul": max_err, "sample_hash": max(r["max_abs_err"] for r in sh_checks),
            "flash_attention": max(r["max_abs_err"] for r in attn_checks)}
    line = []
    for name, (source, replaces) in KERNELS.items():
        row = timed[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[name] for c in path_launches.values()),
            "launches_by_path": {path: c[name] for path, c in path_launches.items()},
            "max_abs_err": errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
        if name == "flash_attention":  # device ms above; its kernels and the other cases
            line[-1].update(
                host_ms=row["host_ms"], previous_ms=row["previous_ms"],
                previous_host_ms=row["previous_host_ms"],
                library_host_ms=row["library_host_ms"], variant=row["variant"],
                variant_launches_by_path=variant_launches,
                cases={r["case"]: {key: r[key] for key in (
                    "variant", "ms", "host_ms", "previous_ms", "library_ms", "bound_ms",
                    "bound_by")} for r in attn_checks})
        if line[-1]["launches"] == 0:
            raise SystemExit(f"{name} was launched on no path")
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
