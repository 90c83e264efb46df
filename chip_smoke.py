#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # 1 GiB blob at the production layout
    python3 chip_smoke.py --blob-mib 256   # a smaller blob
    python3 chip_smoke.py --das-blobs 1024 # fewer blobs in the DAS phase

Phases, each ended by ``torch.cuda.synchronize()`` so a kernel fault shows in
the phase that caused it; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``); build every CUDA kernel
   of the port from the checkout's sources, one ``nvcc`` each, in parallel;
2. every kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (``gf_matmul`` also at the serving path's Clay (4,2)
   encode and repair, at the production (10,6) repair, at an N = 8
   (mod 16) decode and at the DAS extension's small-and-wide shapes (one
   put's column and row stages, the batched extension of every blob of
   phase 7, a 1 x k recovery), at the decode of one Clay (4,2) 64 KiB
   chunkset of phases 12-14 and at phase 14's Clay (4,2) MSR repair and DAS
   extension of six blobs, with its ptxas lines printed in phase 1):
   ``gf_matmul`` and ``sample_hash`` with exact equality (their
   arithmetic is exact), ``flash_attention`` within the
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
   launches counted per phase (each must be > 0); the put also extends the
   blob's DAS square (two more launches) and places its 64 shares; the RPC
   node's synchronous ``read_range`` across a chunkset boundary and
   ``read_blob`` of the whole blob;
4. the audit path: the bulk digests of every 1 KiB sample of every chunk
   the put stored, checked against the plain version on the CPU;
5. Clay MSR repair on the same cluster (``RepairCoordinator.repair_all``):
   an SP that lost every chunk (timed, then wiped and repaired again under
   the profiler for device ms and idle share), a crashed SP whose chunks move to new SPs, and two chunks of one chunkset
   (the first through the MDS fallback); every report verified, every MSR repair one
   ``gf_matmul`` launch reading the MSR optimum of helper bytes; then the
   whole blob read back from a cold cache;
6. membership churn on the same cluster (``MembershipPlane``): three epochs
   of seeded crashes, departures and joins above a floor of 21 live SPs,
   the re-dispersal backlog repaired on the card while paid Zipf reads
   replay on the same event loop; no chunkset lost, every read right;
7. data-availability sampling on a fresh ``build_cluster`` (8 SPs, Clay
   (4,2), ``CONFIG.das()``): put ``--das-blobs`` seeded blobs of one square
   each (8 KiB), each put extending its square on the card; one batched
   extension of every blob in exactly two ``gf_matmul`` launches, equal to
   the puts' records (timed, then profiled for device ms and idle share);
   a paid sampling round over every blob (all verified, settlement
   conserves); 5% of the shares of half the blobs withheld, then a round
   whose detection rate must lie within 0.05 of ``1-(1-3/64)^16`` with no
   false detection; a 20,000-sample storm replayed with one SP crashed
   (detections equal the withheld or crashed coordinates drawn); 64
   squares rebuilt on the card from k rows and from k columns;
8. a device encode/decode against the CPU plain path on one chunkset;
9. the put's and a read's steps timed alone (partition, device encode,
   device-to-host copy, host SHA-256 Merkle commitments, decode);
10. the device's busy and idle share over a put and a whole read of the same
   blob on a fresh cluster, from a ``torch.profiler`` trace of the card
   (kernels, copies and memsets, overlaps merged), and the device ms of all
   ``gf_matmul`` launches in each (kernel events by name);
11. the serving path at yi-9b's published widths, depth cut to 2 layers:
   publish the weights through Shelby, crash an SP, restore them by paid
   k-of-n reads, serve batch 4 x (prompt 8 + 16 generated tokens); the
   served model teacher-forced for two steps on the card and on the CPU
   plain path; decode tok/s as the median of nine warm generations;
12. the cohort fast path in the ``engine`` scenario's world and fleets
   (``repro_torch.scenarios.engine``): 500 SPs,
   50 RPC nodes, 192 single-chunkset blobs at Clay (4,2); Zipf storms of
   10k, 100k and 1M requests through ``session.replay(batch)`` on fresh
   fleets, each under the profiler (wall, requests/s, the cohort split,
   sim p50/p99, goodput, ``gf_matmul`` launches of the de-opted decodes,
   device busy share); no fallback; the 10k digest equal to a heap
   task-per-request replay and to the JAX package's, which also times the
   100k rung for the events/s speedup; settlement conserves;
13. overload control in the ``concurrent`` scenario's world and fleets
   (``repro_torch.scenarios.serving``): 12 SPs
   (a 250 ms straggler, a crashed SP), 3 RPC nodes with 10 Gbps NICs, 400
   Poisson Zipf reads at 200/1000/5000 rps, free-running and with a fetch
   budget of 6; digest, sheds 0/3/26, coalesced legs and both p99s at 5000
   rps equal to the JAX package's, every read's bytes right;
14. the registered scenarios on the card (``repro_torch.scenarios``):
   ``serve_grid``, ``concurrent``, ``background``, ``churn``, ``das`` and
   ``tune_admission`` at full size through ``run_scenario(..., device=
   "cuda")``, each under the profiler, every declared SLO a gate; digests
   and headline numbers equal to live CPU runs of the JAX package; then
   ``engine`` with its events/s SLO reported, not raised (the one open
   finding: its 100k speedup), every other number gated; ``churn`` again
   under ``SHELBY_SIMSAN=1`` (same digest) and a sanitized one-epoch
   ``run_sim`` equal to the CPU's; a 3-point sweep of ``tune_admission``'s
   fetch budget whose digests and argmax equal the JAX package's;
15. the card again, one JSON line per kernel, then the result line.
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
                  "src/repro/kernels/gf_matmul.py:69"),
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
CHURN_EPOCHS = 3
CHURN_READS = 300  # paid Zipf reads replayed beside the churned epochs
# the largest batch of the JAX package's DAS sweep (benchmarks/gf_kernel.py)
DAS_BLOBS = 4096
DAS_WITHHOLD = 0.05  # of a square's 64 shares: exactly 3 withheld
DAS_STORM = 20_000  # samples in the replayed storm
DAS_STORM_GAP_MS = 0.05
DAS_REBUILT = 64  # squares reconstructed on the card
DAS_RATE_TOL = 0.05  # detection rate vs 1-(1-q)^s over 2,048 trials: ~4.5 sigma
# the `engine` scenario's ramp (repro_torch/scenarios/engine.py, as the JAX package's)
ENGINE_HEAP_RUNGS = (10_000, 100_000)  # rungs also replayed task-per-request on the heap
ENGINE_DIGEST_10K = "5cb923036ace9559"  # a live run of the JAX package on the CPU
# the `concurrent` scenario (repro_torch/scenarios/serving.py): 400 Poisson Zipf reads
# through 3 nodes with 10 Gbps NICs, free-running and with a fetch budget of 6
OVERLOAD_RATES = (200, 1000, 5000)
OVERLOAD_REQUESTS = 400
OVERLOAD_DIGEST_200 = "f691cbe9e5a3bbdf"  # live JAX package runs on the CPU, as these:
OVERLOAD_SHED = {200: 0, 1000: 3, 5000: 26}  # admitted sheds per rate
OVERLOAD_COALESCED_5000 = 313
OVERLOAD_P99_5000 = {"free": 1894.4, "admitted": 67.0}  # ms, to 0.1
# phase 14: the registered scenarios at full size; digests and headline numbers
# from live runs of the JAX package on the CPU (`concurrent` prints its digest)
SCENARIOS = ("serve_grid", "concurrent", "background", "churn", "das", "tune_admission")
SCENARIO_DIGESTS = {"concurrent": "f691cbe9e5a3bbdf", "churn": "1bc184e8531f028f",
                    "das": "85ab3ef5108a7122", "tune_admission": "c1556c3dd6076921"}
SCENARIO_HEADLINES = {
    "serve_grid": {"affinity_zipf.goodput_mbps": 963.7652444759353,
                   "affinity_zipf.p99_ms": 67.34528218908011,
                   "affinity_zipf.cache_hit_rate": 0.944},
    "concurrent": {"5000rps.admitted.p99_ms": 66.9937597276077,
                   "5000rps.free.p99_ms": 1894.3813484713874,
                   "5000rps.admitted.shed_rate": 0.065,
                   "5000rps.admitted.goodput_mbps": 1450.6629631907954},
    "background": {"p99_inflation": 1.025824167285706, "audit_ops": 168, "repairs_ok": 20,
                   "background_bytes": 1706608},
    "churn": {"p99_inflation": 1.1296410686942202, "lost_chunksets": 0, "sps_departed": 4,
              "repairs_enqueued": 65},
    "das": {"bytes_to_detect": 2694.289303289303, "storm.detections": 33,
            "streaming.cache_hit_under_storm": 0.8466666666666667,
            "streaming.p99_under_storm_ms": 80.71843664552334},
    "tune_admission": {"goodput_mbps": 1275.2513420433397, "p99_ms": 67.77299059450574,
                       "shed_rate": 0.14, "digest": "c1556c3dd6076921"},
}
# the `engine` SLO the card does not meet (events/s speedup at 100k, ROADMAP Queue 2
# item 4): reported with its value, never raised; every other SLO stays a gate
ENGINE_OPEN_SLO = "speedup_events_per_sec_100k"
# a sweep of tune_admission's fetch budget: each point's digest, as the JAX package's
SWEEP_FETCHES = (3, 6, 12)
SWEEP_DIGESTS = {None: "c1556c3dd6076921", 3: "c3f6770a6d6255d4", 6: "c1556c3dd6076921",
                 12: "875830cd51af074f"}  # None: the baseline, the registered budget of 6
SWEEP_BEST = 12


_STARTED = time.perf_counter()


def _phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _STARTED:.1f} s)", flush=True)


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


def gf_shapes(blob_mib: int, das_blobs: int) -> dict[str, tuple[int, int, int]]:
    """The (M, K, N) shapes at which phase 2 times ``gf_matmul``, by name:
    Clay (10,6) at the production layout (M 6; K 12 known flats per plane,
    10 data + 2 virtual) for a blob of ``blob_mib`` MiB, one MSR repair at
    (10,6) (6 column nodes from 12 known flats over alpha/q = 36 repair
    planes), the serving path's Clay (4,2) encode and repair, and the DAS
    extension (``CONFIG.das()``: k parity lines from k data lines per axis)
    of one put and of ``das_blobs`` squares at once, one line of each of
    ``das_blobs`` squares rebuilt from k, the engine, overload and scenario
    phases' decode of one Clay (4,2) 64 KiB chunkset, and the scenario
    phase's MSR repair at that layout and DAS extension of its six blobs."""
    from repro_torch.configs.shelby import CONFIG
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.storage.blob import BlobLayout

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
    # one MSR repair: q unknown column nodes from N - q known flats, every repair plane
    shapes["repair_10_6"] = (m, kk, alpha // m * w)
    shapes["serve_repair_clay_4_2"] = (serve.m, serve.code.N - serve.m,
                                       serve.code.alpha // serve.m * serve.w)
    dk, ds = CONFIG.das().k, CONFIG.das().share_bytes
    shapes["das_put_col"] = (dk, dk, dk * ds)  # columns: (k, B*k*S), B = 1
    shapes["das_put_row"] = (dk, dk, 2 * dk * ds)  # rows: (k, B*2k*S)
    shapes["das_batch_col"] = (dk, dk, das_blobs * dk * ds)
    shapes["das_batch_row"] = (dk, dk, das_blobs * 2 * dk * ds)
    shapes["das_recover_1xk"] = (1, dk, das_blobs * ds)
    # the engine and overload phases: one Clay (4,2) 64 KiB chunkset decoded from
    # its k data chunks (both parities unknown: one product over every plane)
    eng = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, device="cuda")
    shapes["engine_decode_clay_4_2"] = (eng.m, eng.code.N - eng.m, eng.code.alpha * eng.w)
    shapes["scenario_repair_clay_4_2"] = (eng.m, eng.code.N - eng.m,
                                          eng.code.alpha // eng.m * eng.w)
    shapes["scenario_das_col"] = (dk, dk, 6 * dk * ds)  # background/das: six blobs at once
    shapes["scenario_das_row"] = (dk, dk, 6 * 2 * dk * ds)
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


def repair_phase(contract, sps, client, meta, gk) -> dict:
    """Clay MSR repair at the production layout on the card, three ways:
    an SP that lost every chunk (restored in place: timed, then wiped again
    and repaired under the profiler for device ms and idle share), a crashed
    SP (its chunks move to new SPs), and two chunks of one chunkset gone (the
    first rebuilt through the MDS fallback, the second by MSR once the first
    is back).  Every report must be verified, every MSR repair must read the
    MSR optimum of helper bytes and make exactly one ``gf_matmul`` launch;
    then the whole blob is read back from a cold cache."""
    import torch

    from repro_torch.storage.repair import RepairCoordinator

    lay = client.layout
    msr_bytes = lay.code.repair_bandwidth_bytes(lay.chunk_bytes)
    rc = RepairCoordinator(contract, sps, lay)

    def step(name, fn, profile=False):
        seen, first = gk.gf_matmul.launches, len(rc.reports)
        if profile:  # its wall time carries the profiler's cost: no GB/s from it
            busy = device_busy(fn)
        else:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            busy = {"wall_s": time.perf_counter() - t}
        reports = rc.reports[first:]
        launches = gk.gf_matmul.launches - seen
        msr = [r for r in reports if r.mode == "msr"]
        rebuilt = lay.chunk_bytes * len(reports)
        row = {"step": name, "profiled": profile, "repairs": len(reports), "msr": len(msr),
               "mds": len(reports) - len(msr), "bytes_rebuilt": rebuilt,
               "helper_bytes_read": sum(r.helper_bytes_read for r in reports),
               "helper_bytes_per_msr_repair": sorted({r.helper_bytes_read for r in msr}),
               "helper_bytes_per_mds_repair": sorted(
                   {r.helper_bytes_read for r in reports if r.mode == "mds"}),
               "gf_matmul_launches": launches,
               "GB/s": None if profile else rebuilt / busy["wall_s"] / 1e9,
               "failures": len(rc.failures), **busy}
        print(json.dumps({"repair": row}), flush=True)
        if not reports or rc.failures or not all(r.verified for r in reports):
            raise SystemExit(f"repair step {name!r}: {len(reports)} reports, "
                             f"failures {rc.failures}")
        if any(r.helper_bytes_read != msr_bytes for r in msr):
            raise SystemExit(f"an MSR repair read other than {msr_bytes} helper bytes")
        return row, reports, launches

    # an SP that lost its disk: recovered, then wiped (examples/quickstart.py step 4)
    victim = meta.placement[(0, 0)]
    sps[victim].recover()
    wiped = []
    for profile in (False, True):  # timed, then wiped again for the trace
        sps[victim].wipe()
        row, reports, launches = step("wipe_one_sp", rc.repair_all, profile=profile)
        if row["mds"] or launches != row["msr"] or any(r.new_sp != victim for r in reports):
            raise SystemExit(f"wiped-SP repair: {row['msr']} MSR repairs, {launches} launches")
        wiped.append(row)
    # a crashed SP: its chunks are rebuilt on SPs the contract picks
    crashed = next(sp for sp in meta.placement.values() if sp != victim)
    sps[crashed].crash()
    moved, reports, launches = step("crash_one_sp", rc.repair_all)
    if moved["mds"] or launches != moved["msr"] or any(r.new_sp == crashed for r in reports):
        raise SystemExit(f"crashed-SP repair: {moved['msr']} MSR repairs, {launches} launches")
    # two chunks of one chunkset gone: the first has no MSR pattern (k verified
    # helpers decoded); once it is back, the second is an MSR repair again
    cs = meta.num_chunksets // 2
    for ck in (1, 2):
        sps[meta.placement[(cs, ck)]]._chunks.pop((meta.blob_id, cs, ck))
    mds, reports, launches = step("two_of_one_chunkset", rc.repair_all)
    if [r.mode for r in reports] != ["mds", "msr"] or launches <= 1:
        raise SystemExit(f"MDS fallback: modes {[r.mode for r in reports]}, {launches} launches")
    return {"steps": [*wiped, moved, mds], "wiped_sp": victim, "crashed_sp": crashed}


def churn_phase(contract, sps, client, meta, data, gk, seed: int, reads: int) -> dict:
    """Three churned epochs (crashes, departures, one join each, a floor of
    21 live SPs) with their re-dispersal backlog repaired on the card,
    while paid Zipf reads of the blob replay on the same event loop."""
    import torch

    from repro_torch.net.workloads import zipf_hotset
    from repro_torch.storage.membership import ChurnSpec, MembershipPlane
    from repro_torch.storage.repair import RepairCoordinator

    lay = client.layout
    rc = RepairCoordinator(contract, sps, lay)
    plane = MembershipPlane(
        contract, sps, lay,
        ChurnSpec(p_crash=0.05, p_leave=0.05, joins_per_epoch=1, min_active=21, seed=seed),
        repair=rc, fleet=client.fleet, epochs=CHURN_EPOCHS)
    # the reads spread over the churned epochs (250 ms of simulated time each)
    reqs = zipf_hotset([meta], clients=["reader"], num_requests=reads,
                       interarrival_ms=plane.epoch_ms * CHURN_EPOCHS / reads, seed=seed,
                       arrival="poisson")
    # every MSR attempt must be taken: a rebuilt chunk that failed its
    # commitment would fall back to MDS unseen, so count the attempts on
    # this layout's code (an instance attribute on the frozen dataclass,
    # removed after the run; other ClayCode objects are untouched)
    attempts = []
    code = lay.code
    object.__setattr__(code, "repair", lambda failed, helpers: (
        attempts.append(failed) or type(code).repair(code, failed, helpers)))
    seen = gk.gf_matmul.launches
    t = time.perf_counter()
    try:
        with client.session() as session:
            receipts, result = session.replay(reqs, background=plane.planes())
        torch.cuda.synchronize()
    finally:
        object.__delattr__(code, "repair")
    wall = time.perf_counter() - t
    served = [(q, r) for q, r in zip(reqs, receipts) if r is not None]
    wrong = sum(r.data != data[q.offset:q.offset + q.length] for q, r in served)
    msr = sum(r.mode == "msr" for r in rc.reports)
    row = {
        "epochs": CHURN_EPOCHS, "wall_s": wall,
        "events": [[e.kind, e.epoch, e.t_ms, e.sp_id] for e in plane.events],
        "epoch_stats": [{"epoch": st.epoch, "joins": st.joins, "crashes": st.crashes,
                         "departures": st.departures, "slashes": st.slashes,
                         "reassigned": st.reassigned, "backlog": st.enqueued,
                         "lost_new": st.lost_new, "drain_ms": st.drain_ms()}
                        for st in plane.epoch_stats],
        "lost_chunksets": plane.lost_chunksets, "repairs_msr": msr, "msr_attempts": len(attempts),
        "repairs_mds": len(rc.reports) - msr, "repair_failures": len(plane.repair.failures),
        "backlog_left": plane.repair.backlog(), "reads": len(reqs),
        "reads_served": len(served), "reads_failed": result.dropped, "reads_wrong": wrong,
        "read_p99_ms": result.percentile(99.0), "gf_matmul_launches": gk.gf_matmul.launches - seen,
        "digest": result.digest(),
    }
    print(json.dumps({"churn": row}), flush=True)
    if plane.lost_chunksets or wrong or result.dropped:
        raise SystemExit(f"churn: {plane.lost_chunksets} chunksets lost, {wrong} wrong reads, "
                         f"{result.dropped} failed reads")
    if len(attempts) != msr:
        raise SystemExit(f"churn: {len(attempts) - msr} MSR repairs failed their commitment")
    if plane.repair.failures or plane.repair.backlog() or not plane.events:
        raise SystemExit("churn: the re-dispersal backlog did not drain, or nothing churned")
    return row


def das_phase(gk, seed: int, num_blobs: int, device: str = "cuda") -> dict:
    """Data-availability sampling at the JAX package's ``build_cluster``
    deployment: ``num_blobs`` puts of one DAS square each, one batched
    extension of them all, a paid sampling round, a withholding adversary
    on half the blobs and a round that must catch it at the analytic rate,
    a replayed sample storm, and squares rebuilt on the card."""
    import torch

    from repro_torch.configs.shelby import CONFIG
    from repro_torch.core.extend2d import commit_square, detection_probability
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.net.workloads import das_storm
    from repro_torch.storage import das

    spec = CONFIG.das()
    lay, side = spec.layout(), spec.side
    contract, sps, rpc, client = build_cluster(device=device)
    nbytes = spec.k * spec.k * spec.share_bytes  # one square: no byte of a blob outside it
    bulk = np.random.default_rng(seed).bytes(nbytes * num_blobs)
    datas = [bulk[i * nbytes:(i + 1) * nbytes] for i in range(num_blobs)]
    row: dict = {"blobs": num_blobs, "blob_bytes": nbytes, "k": spec.k,
                 "share_bytes": spec.share_bytes, "samples_per_epoch": spec.samples_per_epoch,
                 "sps": len(sps), "layout": [rpc.layout.k, rpc.layout.m]}

    def launched(fn):
        seen = gk.gf_matmul.launches
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, gk.gf_matmul.launches - seen

    # 1. every put extends its own square on the card
    metas, row["put_s"], row["put_launches"] = launched(lambda: [client.put(d) for d in datas])
    row["put_ms_per_blob"] = row["put_s"] / num_blobs * 1e3
    singles = {m.blob_id: contract.das[m.blob_id] for m in metas}
    if any(len(r.placement) != side * side for r in singles.values()):
        raise SystemExit("das: a put did not place every share of its square")
    blobs = [(m.blob_id, d) for m, d in zip(metas, datas)]

    # 2. every blob at once: two launches, the same records as the puts'
    def batch():
        return das.extend_and_disperse_many(contract, sps, blobs, spec, device=device)

    def same_as_puts(records):
        return all((r.das_root, r.placement, r.proof_bytes) == (
            singles[r.blob_id].das_root, singles[r.blob_id].placement,
            singles[r.blob_id].proof_bytes) for r in records) and len(records) == num_blobs

    records, row["batch_s"], launches = launched(batch)
    if launches != 2 or not same_as_puts(records):
        raise SystemExit(f"das: the batched extension made {launches} launches "
                         f"or differs from the puts' records")
    held = {}
    seen = gk.gf_matmul.launches
    busy = device_busy(lambda: held.update(records=batch()))
    if gk.gf_matmul.launches - seen != 2 or not same_as_puts(held["records"]):
        raise SystemExit("das: the profiled batched extension differs")
    row["batch_profiled"] = busy

    # 3. a paid sampling round over every blob
    verdicts, row["round_s"], _ = launched(
        lambda: client.sample_availability(epoch=0, seed=seed))
    samples = sum(v.verified + v.failures for v in verdicts)
    row.update(round_samples=samples, round_samples_per_s=samples / row["round_s"],
               round_verified=sum(v.verified for v in verdicts),
               round_failures=sum(v.failures for v in verdicts))
    if (len(verdicts) != num_blobs or samples != num_blobs * spec.samples_per_epoch
            or not all(v.available and v.verified == spec.samples_per_epoch for v in verdicts)):
        raise SystemExit("das: an honest sampling round did not verify every sample")
    settlement = client.settle()  # raises unless deposits = refunds + income = receipts
    row["round_paid"] = settlement.total_node_income

    # 4. withhold 3 of 64 shares of half the blobs: caught at 1-(1-q)^s
    half = {m.blob_id for m in metas[:num_blobs // 2]}
    withheld = {das.seed_withholding(contract, sps, b, DAS_WITHHOLD, seed=seed * 1013 + b)
                for b in sorted(half)}
    q = next(iter(withheld)) / (side * side)
    verdicts = client.sample_availability(epoch=1, seed=seed)
    client.settle()
    caught = sum(not v.available for v in verdicts if v.blob_id in half)
    false = sum(not v.available for v in verdicts if v.blob_id not in half)
    rate, analytic = caught / len(half), detection_probability(q, spec.samples_per_epoch)
    row.update(withheld_per_blob=sorted(withheld), q=q, detected=caught,
               detection_rate=rate, analytic=analytic, false_detections=false)
    if withheld != {3} or abs(rate - analytic) > DAS_RATE_TOL or false:
        raise SystemExit(f"das: detection rate {rate} vs {analytic}, {false} false detections")

    # 5. a storm of single samples replayed, one SP crashed
    crashed = 3
    sps[crashed].crash()
    reqs = das_storm(list(contract.das.values()), clients=["light"], num_requests=DAS_STORM,
                     interarrival_ms=DAS_STORM_GAP_MS, seed=seed, cache_bypass=True)

    def hit(r):
        holder = sps[contract.das[r.blob_id].placement[(r.row, r.col)]]
        return holder.behavior.crashed or (r.blob_id, r.row, r.col) in holder._das_withheld

    expected = sum(hit(r) for r in reqs)
    (receipts, result), row["storm_s"], _ = launched(lambda: client.replay(reqs))
    client.settle()
    sps[crashed].recover()
    row.update(storm_samples=result.das_samples, storm_detections=result.das_detections,
               storm_expected=expected, storm_samples_per_s=len(reqs) / row["storm_s"],
               storm_p99_ms=result.percentile(99.0, kind="das"), storm_digest=result.digest(),
               storm_paid_receipts=sum(r is not None for r in receipts))
    if result.das_samples != DAS_STORM or result.das_detections != expected:
        raise SystemExit(f"das: storm {result.das_samples} samples, "
                         f"{result.das_detections} detections, {expected} expected")

    # 6. squares rebuilt on the card from k rows and from k columns
    rng = np.random.default_rng(seed + 1)
    pick = sorted(int(i) for i in rng.choice(num_blobs, size=min(DAS_REBUILT, num_blobs),
                                             replace=False))
    ext = lay.extend_batch([lay.pad_square(datas[i], spec.share_bytes) for i in pick],
                           device=device)
    rebuilt = 0
    for j, i in enumerate(pick):
        if commit_square(ext[j]).commitment.das_root != contract.das[metas[i].blob_id].das_root:
            raise SystemExit("das: a square extended on the card has another DAS root")
        rows = sorted(int(r) for r in rng.choice(side, size=spec.k, replace=False))
        cols = sorted(int(c) for c in rng.choice(side, size=spec.k, replace=False))
        by_rows = lay.reconstruct_from_rows({r: ext[j, r] for r in rows}, device=device)
        by_cols = lay.reconstruct_from_cols({c: ext[j, :, c] for c in cols}, device=device)
        rebuilt += torch.equal(by_rows, ext[j]) and torch.equal(by_cols, ext[j])
    row["rebuilt_equal"] = f"{rebuilt}/{len(pick)}"
    print(json.dumps({"das": row}), flush=True)
    if rebuilt != len(pick):
        raise SystemExit(f"das: {len(pick) - rebuilt} squares rebuilt wrong")
    return row


def engine_phase(gk, device: str = "cuda") -> dict:
    """The `engine` ramp in that scenario's world, fleets and batches
    (``repro_torch.scenarios.engine``): a Zipf storm of 10k, 100k and 1M
    requests through ``session.replay(batch)`` (the cohort fast path) on
    fresh fleets, each rung under the profiler; the cold-key leaders de-opt
    to real tasks and decode on the card (one cold-key leader per blob).
    The 10k digest must equal a task-per-request replay on the heap engine
    and the JAX package's; ``ENGINE_HEAP_RUNGS`` also time that baseline
    for the events/s speedup."""
    import torch

    from repro_torch.configs.shelby import CONFIG
    from repro_torch.net.workloads import replay_open_loop
    from repro_torch.scenarios import engine as eng
    from repro_torch.storage.sdk import ShelbyClient

    t = time.perf_counter()
    layout, contract, bb, sps, metas = eng._world(device)
    torch.cuda.synchronize()
    rows = {"world": {"sps": eng.NUM_SPS, "rpcs": eng.NUM_RPCS, "blobs": eng.NUM_BLOBS,
                      "cache_chunksets": eng.CACHE_CHUNKSETS, "build_s": time.perf_counter() - t}}
    print(json.dumps({"engine_world": rows["world"]}), flush=True)
    for n in eng.RAMP:
        batch = eng._batch(metas, n)
        reader = ShelbyClient(contract, eng._fleet(CONFIG, layout, contract, bb, sps),
                              deposit=1e9)
        held = {}

        def replay():
            with reader.session(deposit_per_node=1e6) as session:
                held["rb"], held["fast"] = session.replay(batch)
            held["session"] = session

        seen = gk.gf_matmul.launches
        busy = device_busy(replay)
        fast, rb, session = held["fast"], held["rb"], held["session"]
        co = fast.cohort
        row = {"requests": n, "wall_s": busy["wall_s"], "requests_per_s": n / busy["wall_s"],
               "events_per_s": fast.engine_events_per_sec,
               "vec_requests": co.vec_requests, "deopt_requests": co.deopt_requests,
               "coalesced_legs": co.coalesced, "fallback_reason": co.fallback_reason,
               "p50_ms": fast.percentile(50.0), "p99_ms": fast.percentile(99.0),
               "goodput_mbps": fast.goodput_mbps, "digest": fast.digest()[:16],
               "gf_matmul_launches": gk.gf_matmul.launches - seen,
               "device_busy_s": busy["device_busy_s"], "idle_share": busy["idle_share"],
               "gf_matmul_device_ms": busy["gf_matmul_device_ms"]}
        if co.fallback_reason is not None or row["gf_matmul_launches"] == 0:
            raise SystemExit(f"engine {n}: fell back ({co.fallback_reason}) "
                             f"or made no gf_matmul launch")
        paid = rb.total_paid + sum(r.total_paid for r in session.receipts)
        if abs(session.settlement.total_node_income - paid) >= 1e-6:
            raise SystemExit(f"engine {n}: settlement does not conserve")
        if n in ENGINE_HEAP_RUNGS:
            t = time.perf_counter()
            base = replay_open_loop(eng._fleet(CONFIG, layout, contract, bb, sps),
                                    batch.to_requests(), engine="heap")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            row["heap"] = {"wall_s": wall, "requests_per_s": n / wall,
                           "events_per_s": base.engine_events_per_sec,
                           "digest": base.digest()[:16]}
            row["speedup_events_per_s"] = (fast.engine_events_per_sec
                                           / base.engine_events_per_sec)
            if n == eng.RAMP[0] and not (fast.digest() == base.digest()
                                         and row["digest"] == ENGINE_DIGEST_10K
                                         and co.deopt_requests == eng.NUM_BLOBS):
                raise SystemExit(f"engine 10k: digest {row['digest']} (heap "
                                 f"{row['heap']['digest']}, JAX package {ENGINE_DIGEST_10K}), "
                                 f"{co.deopt_requests} de-opts")
        print(json.dumps({"engine": row}), flush=True)
        rows[str(n)] = row
    return rows


def overload_phase(gk, device: str = "cuda") -> dict:
    """The `concurrent` ramp in that scenario's world and fleets
    (``repro_torch.scenarios.serving``): 400 Poisson Zipf reads at 200, 1000
    and 5000 rps, each free-running (no admission, no single-flight) and
    admitted (the scenario's fetch budget of 6); every read decodes on the
    card.  Digest, sheds, coalesced legs and both p99s at 5000 rps must
    equal the JAX package's; settlement conserves; every read's bytes are
    the written ones."""
    import torch

    from repro_torch.net.workloads import zipf_hotset
    from repro_torch.scenarios import REGISTRY, load_builtin, serving
    from repro_torch.storage.sdk import ShelbyClient

    load_builtin()
    cfg = REGISTRY.get("concurrent").config()
    nic = cfg.nic()
    layout, contract, bb, sps, metas, written = serving._world(cfg, False, nic=nic, sp_slots=2,
                                                               device=device)
    datas = {meta.blob_id: data for meta, data in zip(metas, written)}

    def one_run(rate, admission=None, single_flight=True):
        fleet = serving._fresh_fleet(cfg, layout, contract, bb, sps, nic=nic, cache_chunksets=8,
                                     admission=admission, single_flight=single_flight)
        reqs = zipf_hotset(metas, clients=["client0", "client1", "client2"],
                           num_requests=OVERLOAD_REQUESTS, interarrival_ms=1000.0 / rate,
                           seed=11, arrival="poisson")
        seen = gk.gf_matmul.launches
        t = time.perf_counter()
        with ShelbyClient(contract, fleet, deposit=1e9).session() as session:
            receipts, result = session.replay(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        paid = sum(r.total_paid for r in session.receipts)
        if abs(session.settlement.total_node_income - paid) >= 1e-3:
            raise SystemExit(f"overload {rate} rps: settlement does not conserve")
        wrong = sum(r.data != datas[q.blob_id][q.offset:q.offset + q.length]
                    for q, r in zip(reqs, receipts) if r is not None and not r.shed)
        return fleet, result, {
            "wall_s": wall, "goodput_mbps": result.goodput_mbps,
            "p50_ms": result.percentile(50.0), "p99_ms": result.percentile(99.0),
            "shed": result.shed, "dropped": result.dropped, "wrong_bytes": wrong,
            "hedges_launched": fleet.hedges_launched(), "hedged_wasted": fleet.hedged_wasted(),
            "coalesced": fleet.coalesced(), "retried_legs": fleet.retried_legs,
            "gf_matmul_launches": gk.gf_matmul.launches - seen}

    _, a, _ = one_run(OVERLOAD_RATES[0])
    _, b, _ = one_run(OVERLOAD_RATES[0])
    rows = {"digest_200rps": a.digest()[:16]}
    if a.digest() != b.digest() or rows["digest_200rps"] != OVERLOAD_DIGEST_200:
        raise SystemExit(f"overload: digest {a.digest()[:16]} / {b.digest()[:16]}, "
                         f"JAX package {OVERLOAD_DIGEST_200}")
    for rate in OVERLOAD_RATES:
        for mode, admission, single_flight in (("free", None, False),
                                               ("admitted", cfg.admission(), True)):
            _, _, row = one_run(rate, admission, single_flight)
            print(json.dumps({"overload": {"rate_rps": rate, "mode": mode, **row}}), flush=True)
            rows[f"{rate}rps_{mode}"] = row
            if row["gf_matmul_launches"] == 0 or row["wrong_bytes"] or row["dropped"]:
                raise SystemExit(f"overload {rate} rps {mode}: {row}")
        if rows[f"{rate}rps_admitted"]["shed"] != OVERLOAD_SHED[rate]:
            raise SystemExit(f"overload {rate} rps: admitted shed "
                             f"{rows[f'{rate}rps_admitted']['shed']}, not {OVERLOAD_SHED[rate]}")
    top = OVERLOAD_RATES[-1]
    p99 = {mode: round(rows[f"{top}rps_{mode}"]["p99_ms"], 1) for mode in OVERLOAD_P99_5000}
    if (p99 != OVERLOAD_P99_5000
            or rows[f"{top}rps_admitted"]["coalesced"] != OVERLOAD_COALESCED_5000):
        raise SystemExit(f"overload {top} rps: p99 {p99}, coalesced "
                         f"{rows[f'{top}rps_admitted']['coalesced']}")
    return rows


def _run_scenario_profiled(name: str, profiled: bool = True, **kw) -> tuple:
    """``run_scenario(name, emit=False, **kw)``, under the profiler unless
    ``profiled`` is false: its result, the device-busy row (wall only when
    not profiled; ``with_trace_s`` adds the trace's processing) and
    everything it printed (shown as well)."""
    import contextlib
    import io

    import torch

    from repro_torch.scenarios import run_scenario

    held, out = {}, io.StringIO()

    def run():
        held["res"] = run_scenario(name, emit=False, **kw)
        torch.cuda.synchronize()

    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        if profiled:
            busy = device_busy(run)
        else:
            run()
            busy = {"wall_s": time.perf_counter() - t, "device_busy_s": None,
                    "idle_share": None, "gf_matmul_device_ms": None}
    busy["with_trace_s"] = time.perf_counter() - t
    print(out.getvalue(), end="", flush=True)
    return held["res"], busy, out.getvalue()


def scenario_phase(gk, device: str = "cuda") -> dict:
    """The registered scenarios at full size on ``device``: each of
    ``SCENARIOS`` through ``run_scenario`` under the profiler (a declared
    SLO that fails raises), its digest and headline numbers held to the JAX
    package's; ``engine`` with ``raise_on_violation=False``, every SLO but
    ``ENGINE_OPEN_SLO`` a gate; ``churn`` again under ``SHELBY_SIMSAN=1``
    (these two timed without the profiler);
    a sanitized one-epoch ``run_sim`` against the CPU's; a sweep of
    ``tune_admission``'s fetch budget."""
    from repro_torch.core.simulation import honest_population, run_sim
    from repro_torch.scenarios import KnobAxis, ScenarioProblem, load_builtin
    from repro_torch.scenarios.report import metric_path

    load_builtin()
    rows = {}

    def scenario_row(name, res, busy, printed, launches, digest=None):
        digest = digest or res.digest or next(iter(re.findall(
            rf"# {name} determinism digest: ([0-9a-f]{{16}}) OK", printed)), None)
        row = {"scenario": name, "wall_s": busy["wall_s"], "with_trace_s": busy["with_trace_s"],
               "device_busy_s": busy["device_busy_s"], "idle_share": busy["idle_share"],
               "gf_matmul_launches": launches,
               "gf_matmul_device_ms": busy["gf_matmul_device_ms"], "digest": digest,
               "slos": {r.slo.metric: r.value for r in res.slo_results},
               "slos_ok": {r.slo.metric: r.ok for r in res.slo_results},
               "headline": {p: metric_path(res.payload, p) for p in res.scenario.headline}}
        print(json.dumps({"scenario": row}), flush=True)
        if launches == 0:
            raise SystemExit(f"scenario {name} made no gf_matmul launch")
        return row

    for name in SCENARIOS:
        seen = gk.gf_matmul.launches
        res, busy, printed = _run_scenario_profiled(name, smoke=False, device=device)
        row = rows[name] = scenario_row(name, res, busy, printed, gk.gf_matmul.launches - seen)
        if name in SCENARIO_DIGESTS and row["digest"] != SCENARIO_DIGESTS[name]:
            raise SystemExit(f"scenario {name}: digest {row['digest']}, "
                             f"JAX package {SCENARIO_DIGESTS[name]}")
        if row["headline"] != SCENARIO_HEADLINES[name]:
            raise SystemExit(f"scenario {name}: headline {row['headline']}, "
                             f"JAX package {SCENARIO_HEADLINES[name]}")

    # engine: the run asserts no fallback, fast == heap at 10k, determinism and
    # settlement conservation itself; its events/s SLO is the open finding.
    # Not profiled: phase 12 profiles each rung of the same ramp
    seen = gk.gf_matmul.launches
    res, busy, printed = _run_scenario_profiled("engine", profiled=False, device=device,
                                                raise_on_violation=False)
    row = rows["engine"] = scenario_row("engine", res, busy, printed,
                                        gk.gf_matmul.launches - seen,
                                        digest=res.payload["digest_10k"])
    for r in res.slo_results:
        if r.slo.metric == ENGINE_OPEN_SLO:
            print(f"engine SLO (open finding, reported not raised): {r.message()}", flush=True)
        elif not r.ok:
            raise SystemExit(f"scenario engine: {r.message()}")
    if row["digest"] != ENGINE_DIGEST_10K:
        raise SystemExit(f"scenario engine: 10k digest {row['digest']}, "
                         f"JAX package {ENGINE_DIGEST_10K}")

    # simsan on the card: observes, never moves an event
    os.environ["SHELBY_SIMSAN"] = "1"
    try:
        seen = gk.gf_matmul.launches
        res, busy, printed = _run_scenario_profiled("churn", profiled=False, smoke=False,
                                                    device=device)
        san = rows["churn_sanitized"] = scenario_row("churn", res, busy, printed,
                                                     gk.gf_matmul.launches - seen)
    finally:
        del os.environ["SHELBY_SIMSAN"]
    if san["digest"] != rows["churn"]["digest"]:
        raise SystemExit(f"sanitized churn: digest {san['digest']}, "
                         f"unsanitized {rows['churn']['digest']}")
    seen = gk.gf_matmul.launches
    sims = {dev: dataclasses.asdict(run_sim(honest_population(6), epochs=1, seed=5,
                                            read_requests_per_epoch=20, device=dev,
                                            sanitize=True))
            for dev in (device, "cpu")}
    rows["run_sim_sanitized"] = {"equal_to_cpu": sims[device] == sims["cpu"],
                                 "gf_matmul_launches": gk.gf_matmul.launches - seen}
    print(json.dumps({"run_sim_sanitized": rows["run_sim_sanitized"]}), flush=True)
    if not rows["run_sim_sanitized"]["equal_to_cpu"]:
        raise SystemExit("sanitized run_sim on the card differs from the CPU's")

    # the optimiser's objective: each swept point reproduces the JAX package's
    seen = gk.gf_matmul.launches
    t = time.perf_counter()
    prob = ScenarioProblem("tune_admission",
                           (KnobAxis("rpc_max_inflight_fetches", SWEEP_FETCHES),),
                           "goodput_mbps", smoke=False, verbose=False, device=device)
    tuned = prob.sweep()
    digests = {p.knobs.get("rpc_max_inflight_fetches"): p.digest for p in tuned.history}
    rows["sweep"] = {"wall_s": time.perf_counter() - t, "digests": digests,
                     "values": {str(p.knobs.get("rpc_max_inflight_fetches")): p.value
                                for p in tuned.history},
                     "best": tuned.best.knobs, "gf_matmul_launches": gk.gf_matmul.launches - seen}
    print(json.dumps({"sweep": {**rows["sweep"], "digests": {str(k): v for k, v in
                                                              digests.items()}}}), flush=True)
    if digests != SWEEP_DIGESTS or tuned.best.knobs != {"rpc_max_inflight_fetches": SWEEP_BEST}:
        raise SystemExit(f"sweep: digests {digests}, best {tuned.best.knobs}")
    return rows


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
    ap.add_argument("--das-blobs", type=int, default=DAS_BLOBS,
                    help=f"blobs in the DAS phase (default {DAS_BLOBS})")
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
    timed_shapes = gf_shapes(args.blob_mib, args.das_blobs)
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
    # the put also extends the blob's DAS square: two launches beside the encode's one
    das_rec = contract.das.get(meta.blob_id)
    if das_rec is None or len(das_rec.placement) != das_rec.side ** 2 or sum(
            sp.stored_shares() for sp in sps.values()) != das_rec.side ** 2:
        raise SystemExit("the put registered no DAS square or did not place its shares")
    if phases["put"]["gf_matmul_launches"] != 3:
        raise SystemExit(f"the put made {phases['put']['gf_matmul_launches']} launches, not 3")
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
    # the RPC node's synchronous reads: a range across a chunkset boundary, the whole blob
    clear_caches()
    off, ln = cs_bytes - 4321, 10_000
    got = run_phase("rpc_read_range", lambda: rpc.read_range(meta.blob_id, off, ln), ln)
    assert got == data[off:off + ln], "the RPC node's read_range differs from the blob"
    clear_caches()
    got = run_phase("rpc_read_blob", lambda: rpc.read_blob(meta.blob_id), len(data))
    assert got == data, "the RPC node's read_blob differs from the blob"
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

    # -- 5. Clay MSR repair on the card, on the same cluster ----------------------------
    _phase("repair: wipe one SP, crash one SP, lose two chunks of one chunkset; repair_all")
    zero_counts()  # count the repair path only
    repair_phase(contract, sps, client, meta, gk)
    counts = read_counts("repair")
    if counts["gf_matmul"] == 0:
        raise SystemExit("the repair path made no gf_matmul launch")
    clear_caches()
    t = time.perf_counter()
    got = client.get(meta.blob_id)
    print(json.dumps({"repair_read_back": {"s": time.perf_counter() - t, "equal": got == data}}),
          flush=True)
    if got != data:
        raise SystemExit("the blob read back after repair differs from what was written")
    client.settle()

    # -- 6. membership churn with re-dispersal, paid reads alongside ---------------------
    _phase(f"churn: {CHURN_EPOCHS} epochs of crashes, departures and joins, "
           f"{CHURN_READS} paid reads replayed alongside")
    clear_caches()
    zero_counts()  # count the churn path only
    churn = churn_phase(contract, sps, client, meta, data, gk, args.seed, CHURN_READS)
    counts = read_counts("churn")
    if counts["gf_matmul"] < churn["repairs_msr"] or counts["gf_matmul"] == 0:
        raise SystemExit(f"the churn path's gf_matmul launches are off: {counts}")

    # -- 7. data-availability sampling on the JAX package's build_cluster deployment ----
    _phase(f"das: {args.das_blobs} blobs of one square each, extended on the card, "
           f"sampled, withheld, stormed, rebuilt")
    zero_counts()  # count the DAS path only
    das_phase(gk, args.seed, args.das_blobs)
    counts = read_counts("das")
    if counts["gf_matmul"] < 2 * args.das_blobs + 4:
        raise SystemExit(f"the DAS path's gf_matmul launches are off: {counts}")

    # -- 8. device against the CPU plain path on one chunkset -------------------------
    _phase("encode/decode: card vs CPU plain path, one production chunkset")
    plain = np.frombuffer(data[:cs_bytes], np.uint8).reshape(k, alpha, w).copy()
    dev_code, cpu_code = ClayCode(k, m, device="cuda"), ClayCode(k, m, device="cpu")
    coded = dev_code.encode(plain).cpu()
    assert torch.equal(coded, cpu_code.encode(plain)), "device encode differs from CPU"
    shards = {i: coded[i].numpy() for i in range(k + m) if i not in (0, 3, 7, 11, 12, 15)}
    assert torch.equal(dev_code.decode(shards).cpu(), coded), "device decode differs"
    torch.cuda.synchronize()
    print("card == CPU plain path: ok", flush=True)

    # -- 9. where the put's and a read's time goes: each step timed alone ------------
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

    # -- 10. how much of a put and a read the card is busy ----------------------------
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

    # -- 11. the serving path at yi-9b width ---------------------------------------------
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

    # -- 12. the cohort fast path at the engine scenario's scale --------------------------
    from repro_torch.scenarios import engine as eng

    _phase(f"engine: Zipf storms of {', '.join(f'{n:,}' for n in eng.RAMP)} requests "
           f"through the cohort fast path, {eng.NUM_SPS} SPs, {eng.NUM_RPCS} RPC nodes")
    zero_counts()  # count the engine path only
    engine_phase(gk)
    if read_counts("engine")["gf_matmul"] == 0:
        raise SystemExit("the engine path made no gf_matmul launch")

    # -- 13. overload control: the concurrent scenario's ramp ----------------------------
    _phase(f"overload: {OVERLOAD_REQUESTS} Poisson Zipf reads at "
           f"{'/'.join(map(str, OVERLOAD_RATES))} rps, free-running and admitted")
    zero_counts()  # count the overload path only
    overload_phase(gk)
    if read_counts("overload")["gf_matmul"] == 0:
        raise SystemExit("the overload path made no gf_matmul launch")

    # -- 14. the registered scenarios on the card ------------------------------------------
    _phase(f"scenarios: {', '.join(SCENARIOS)} and engine at full size, simsan, a sweep")
    zero_counts()  # count the scenario path only
    scenario_phase(gk)
    if read_counts("scenarios")["gf_matmul"] == 0:
        raise SystemExit("the scenario path made no gf_matmul launch")

    # -- 15. the kernels line and the result ----------------------------------------------
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
        if name == "gf_matmul":  # the repair and DAS shapes beside the put's encode
            by_shape = {(r["m"], r["k"], r["n"]): r for r in checks}
            line[-1]["shapes"] = {
                key: {f: by_shape[shape][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")}
                for key, shape in timed_shapes.items()
                if key.startswith(("repair", "serve_repair", "das", "engine", "scenario"))}
        if line[-1]["launches"] == 0:
            raise SystemExit(f"{name} was launched on no path")
    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
