#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # 1 GiB blob at the production layout
    python3 chip_smoke.py --blob-mib 256   # a smaller blob

Phases, each ended by ``torch.cuda.synchronize()`` so a kernel fault shows in
the phase that caused it; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``); build every CUDA kernel
   of the port from the checkout's sources;
2. every kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, exact equality (GF(2^8) arithmetic is exact);
   kernel and plain version timed in turns with CUDA events beside the
   byte bound;
3. the main path at production size: a (10,6) Clay / 10 MiB-chunkset
   cluster of 24 SPs in 5 DCs, put a seeded blob, read it whole and at 3
   ranges across chunksets, crash 2 SPs and read again, mark one SP
   corrupt and read again, settle; bytes compared with the input, kernel
   launches counted per phase (each must be > 0);
4. a device encode/decode against the CPU plain path on one chunkset;
5. the put's and a read's steps timed alone (partition, device encode,
   device-to-host copy, host SHA-256 Merkle commitments, decode);
6. the device's busy and idle share over a put and a whole read of the same
   blob on a fresh cluster, from a ``torch.profiler`` trace of the card
   (kernels, copies and memsets, overlaps merged);
7. the card again, one JSON line per kernel, then the result line.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, the nearest listed integer rate
REPLACES = "src/repro/kernels/gf_matmul.py:68"
SOURCE = "src/repro_torch/kernels/csrc/gf_matmul.cu"


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


def device_busy(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` with CUDA activity only; return
    its wall seconds and the seconds the card spent in kernels, copies or
    memsets (the union of their intervals from the trace)."""
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
            events = json.load(f)["traceEvents"]
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
    return {"wall_s": wall, "device_busy_s": busy if every else None,
            "kernel_s": union_s(spans["kernel"]), "copy_s": union_s(spans["gpu_memcpy"]),
            "device_events": len(every),
            "idle_share": 1.0 - busy / wall if every else None}


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
            bound, by = gf_bound_ms(m, k, n)
            row.update(ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
                       bound_ms=bound, bound_by=by)
        print(json.dumps({"gf_matmul_check": row}), flush=True)
        if mismatches:
            raise SystemExit(f"gf_matmul disagrees with its plain version at {(m, k, n)}")
        rows.append(row)
        del a, b, out, ref
    torch.cuda.synchronize()
    return rows


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
    from repro_torch.kernels import gf_matmul as gk
    from repro_torch.launch.cluster import build_cluster

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
    gk._lib()  # compiles csrc/gf_matmul.cu with nvcc, then loads it
    print(f"kernel build+load: {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 2. kernels against their plain versions --------------------------------------
    _phase("gf_matmul vs plain")
    lay = CONFIG.layout
    alpha, w, k, m = ClayCode(lay.k, lay.m, device="cuda").alpha, lay.w, lay.k, lay.m
    n_cs = -(-args.blob_mib * 2**20 // lay.chunkset_bytes)
    kk = 12  # N_clay - m: known flats per plane (10 data + 2 virtual)
    enc_chunk = (m, kk, alpha * w)  # one chunkset's encode
    enc_blob = (m, kk, alpha * w * n_cs)  # the put's encode of the whole blob
    shapes = [enc_chunk, (m, kk, 3 * alpha * w + 17)]
    shapes += [(m, kk, g * w * n_cs) for g in (6, 48, 60, 102)]  # decode plane groups
    shapes += [enc_blob, (4, 4, 65536), (1, 4, 65536), (1, 1, 1_000_003),
               (1, 17, alpha * w), (32, 32, 100_003)]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    checks = check_gf_matmul(shapes, gen, timed=set(shapes[:7]))
    max_err = max(r["max_abs_err"] for r in checks)
    mismatches = sum(r["mismatches"] for r in checks)

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
    gk.gf_matmul.launches = 0  # count the main path only
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
    main_launches = gk.gf_matmul.launches
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

    # -- 4. device against the CPU plain path on one chunkset -------------------------
    _phase("encode/decode: card vs CPU plain path, one production chunkset")
    plain = np.frombuffer(data[:cs_bytes], np.uint8).reshape(k, alpha, w).copy()
    dev_code, cpu_code = ClayCode(k, m, device="cuda"), ClayCode(k, m, device="cpu")
    coded = dev_code.encode(plain).cpu()
    assert torch.equal(coded, cpu_code.encode(plain)), "device encode differs from CPU"
    shards = {i: coded[i].numpy() for i in range(k + m) if i not in (0, 3, 7, 11, 12, 15)}
    assert torch.equal(dev_code.decode(shards).cpu(), coded), "device decode differs"
    torch.cuda.synchronize()
    print("card == CPU plain path: ok", flush=True)

    # -- 5. where the put's and a read's time goes: each step timed alone ------------
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

    # -- 6. how much of a put and a read the card is busy ----------------------------
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

    timed = next(r for r in checks if (r["m"], r["k"], r["n"]) == enc_blob)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "gf_matmul", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": main_launches, "max_abs_err": max_err, "mismatches": mismatches,
        "shape": list(enc_blob), "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
