#!/usr/bin/env python3
"""Time the forward's "tile" designs against each other on one GPU, in turns.

    python scripts/attn_fwd_ab.py                  # the tree's "wgmma" and "mma" designs
    python scripts/attn_fwd_ab.py parent=build/parent/src/repro_torch/kernels/csrc/flash_attention.cu
    python scripts/attn_fwd_ab.py --variant pingpong --variant keys64 --rounds 5
    python scripts/attn_fwd_ab.py --check-only     # build and check, no timing

The tree's library is the package's (``kernels/_build.py``); it runs both
designs of ``flash_attention_tile_launch`` (its ``design`` argument).  Each
``label=path`` is another source with that launcher, compiled with the
headers beside it (``attention_tiles.cuh``) and the flags of
``kernels/_build.py`` into ``build/attn_fwd_ab/``, all builds at once; a
launcher without the ``design`` argument (an earlier commit's, unpacked with
``git archive <commit> src | tar -x -C build/parent``) runs its one design
as ``label``, one with it its "wgmma" design.  Each ``--variant NAME``
adds the tree's source with the text patches ``VARIANTS[NAME]`` applied
(written to ``build/attn_fwd_ab/NAME/``): ``keys64``, 64-key tiles (S by
wgmma m64n64, four stages at every instance); ``pingpong``, the two
consumer warpgroups take turns on named barriers 3 and 4 to issue their
products, so that one's softmax runs beside the other's.  ptxas's register
and spill lines of every build are printed.

Every design is checked against ``flash_attention_lse_ref`` (one batch
element at a time) on ``CASES``: O within ``ATTN_TOL``, the row log-sum-exp
within ``LSE_ATOL``, two calls equal bit for bit.  The rows in ``TIMED``
(``chip_smoke.py``'s training and prefill shapes) are then timed: CUDA events
around 10 calls in turns (first to last, then last to first; ``host_ms`` the
lower) and the device time of a ``torch.profiler`` trace of 10 calls,
``--rounds`` times in turns (first to last, then last to first, and so on:
``runs_ms``; ``ms`` their median), beside SDPA (a yardstick the port never calls) and the bound (2 (hd
+ hd_v) operations per visible pair and query head at the bf16 peak, or q,
o and the seen K/V slots moved once).  Prints one JSON line per case, then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
TIMED = ("train_microbatch", "mla_train", "hymba_train", "whisper_encoder", "mesh_prefill")

# The alternatives to the tree's "wgmma" schedule: (text of the source, what
# replaces it); each text occurs once in the source.
_TURNS = """\
// The consumer warpgroups' turns: wait for this one's (barrier 3 + wg, the
// other warpgroup arrives), then hand the turn over
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(3 + (wg ^ 1)) : "memory");
}
"""
_SYNC = """\
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\\n" ::"r"(id) : "memory");
}
"""
_PEND = "    int pend = -1;  // the stage whose P (in pa) still has to go through P V\n"
VARIANTS = {
    "keys64": [
        ("constexpr int kFwdKeys = 128;", "constexpr int kFwdKeys = 64;"),
        ("wgmma_ss_n128(s, ", "wgmma_ss_n64(s, "),
    ],
    # each warpgroup takes one turn per ring entry (also for a tile it skips)
    # and one for the last P V; warpgroup 0 goes first
    "pingpong": [
        (_SYNC, _SYNC + _TURNS),
        (_PEND, "    if (wg == 1) turn_pass(wg);\n" + _PEND),
        ("      fence_regs(pa);\n      wgmma_fence();\n      if (state != 0) {\n",
         "      fence_regs(pa);\n      turn_wait(wg);\n      wgmma_fence();\n"
         "      if (state != 0) {\n"),
        ("      if (state == 0) {  // a skipped tile",
         "      turn_pass(wg);\n      if (state == 0) {  // a skipped tile"),
        ("    if (pend >= 0) {  // the last tile's P V\n",
         "    turn_wait(wg);\n    if (pend >= 0) {  // the last tile's P V\n"),
        ("      wgmma_commit();\n      wgmma_wait<0>();\n",
         "      wgmma_commit();\n    }\n    if (wg == 0) turn_pass(wg);\n    if (pend >= 0) {\n"
         "      wgmma_wait<0>();\n"),
    ],
}


def patched(text: str, name: str) -> str:
    """The source with the patches of ``VARIANTS[name]`` applied."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"attn_fwd_ab: the source no longer has one {old.strip()!r}")
        text = text.replace(old, new)
    return text


def cases():
    """(name, b, sq, sk, h, hkv, hd, hd_v, causal, window, q_positions, k_positions)."""
    import torch

    from chip_smoke import (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, FAMILY_TRAIN_SEQ, MESH_BATCH,
                            MESH_DATA, MESH_MODEL, MESH_PREFILL_SEQ, MLA_SEQ, TRAIN_BATCH,
                            TRAIN_MICROBATCHES, TRAIN_SEQ)

    def ar(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int32, device="cuda")

    perm = torch.randperm(500, generator=torch.Generator().manual_seed(0)).to("cuda", torch.int32)
    return [
        ("train_microbatch", TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, TRAIN_SEQ, 24, 2, 128,
         128, True, 0, ar(TRAIN_SEQ), ar(TRAIN_SEQ)),
        ("mla_train", 1, MLA_SEQ, MLA_SEQ, 16, 16, 192, 128, True, 0, ar(MLA_SEQ), ar(MLA_SEQ)),
        ("hymba_train", 1, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_SEQ, 25, 5, 64, 64, True, 0,
         ar(FAMILY_TRAIN_SEQ), ar(FAMILY_TRAIN_SEQ)),
        ("whisper_encoder", ENCDEC_TRAIN_BATCH, 1500, 1500, 6, 6, 64, 64, False, 0, ar(1500),
         ar(1500)),
        ("mesh_prefill", MESH_BATCH // MESH_DATA, MESH_PREFILL_SEQ, MESH_PREFILL_SEQ,
         32 // MESH_MODEL, 8 // MESH_MODEL, 128, 128, True, 0, ar(MESH_PREFILL_SEQ),
         ar(MESH_PREFILL_SEQ)),
        ("whisper_cross_train", ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, 1500, 6, 6, 64, 64, False,
         0, ar(ENCDEC_TRAIN_SEQ), ar(1500)),
        # hd_v < hd inside an instance: hd 160 runs on (192, 128)
        ("hd160_hdv128", 2, 300, 300, 8, 2, 160, 128, True, 0, ar(300), ar(300)),
        ("hd96_window", 3, 200, 260, 8, 2, 96, 96, True, 33, ar(200, 60), ar(260)),
        ("hd16", 1, 64, 64, 2, 2, 16, 16, True, 0, ar(64), ar(64)),
        # permuted key positions (a ring buffer) under a window, Sq != Sk
        ("window_permuted_keys", 2, 300, 500, 8, 2, 128, 128, True, 64, ar(300, 200), perm),
        # queries -200..55: the first block sees no key at all, the second in part
        ("blind_block", 1, 256, 512, 8, 2, 128, 128, True, 0, ar(256, -200), ar(512)),
        ("sq100_noncausal_ragged", 1, 100, 1500, 6, 6, 64, 64, False, 0, ar(100), ar(1500)),
    ]


def build(label: str, src: pathlib.Path,
          include: pathlib.Path) -> tuple[str, pathlib.Path | None, list[str], str]:
    from repro_torch.kernels import _build

    flags = [*_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(include)]
    text = src.read_bytes() + b"".join(p.read_bytes() for p in sorted(include.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    out = ROOT / "build" / "attn_fwd_ab" / f"lib{label}-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *flags, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return label, (out if proc.returncode == 0 else None), _ptxas(proc.stdout), proc.stdout


def _ptxas(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln or "warning" in ln]


def bind(path: pathlib.Path, takes_design: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.takes_design = takes_design
    p, i = ctypes.c_void_p, ctypes.c_int
    shape = [i] * 7 + [ctypes.c_float, i, i]
    lib.flash_attention_tile_launch.argtypes = [p] * 7 + shape + [i] * takes_design + [p]
    lib.flash_attention_tile_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("builds", nargs="*", help="label=path of another flash_attention.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true", help="build and check; no timing")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="the tree's source with these patches (see VARIANTS)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="profiled device timings of each build, in turns")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attn_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (ATTN_TOL, H100_BF16_FLOPS, H100_BYTES_PER_S, LSE_ATOL, _device_ms,
                            _time_ms)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    pairs = [(label, pathlib.Path(path), pathlib.Path(path).parent)
             for label, path in (s.split("=", 1) for s in args.builds)]
    for name in args.variant:
        src = ROOT / "build" / "attn_fwd_ab" / name / SOURCE.name
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(patched(SOURCE.read_text(), name))
        pairs.append((name, src, SOURCE.parent))
    with ThreadPoolExecutor(len(pairs) + 1) as pool:  # one nvcc each, all at once
        tree = pool.submit(fa._lib)
        built = list(pool.map(lambda p: build(*p), pairs))
        tree.result()
    for line in _build.ptxas_report("flash_attention"):
        print(f"ptxas tree: {line}", flush=True)
    others = {}
    for label, path, ptxas, log in built:
        for line in ptxas:
            print(f"ptxas {label}: {line}", flush=True)
        if path is None:
            print(f"build of {label} failed:\n{log}", flush=True)
            return 1
        source = next(p for lb, p, _ in pairs if lb == label).read_text()
        others[label] = bind(path, re.search(r"int window,\s+int design,", source) is not None)

    def other(lib, q, k, v, kw):
        """Another build's launcher: its "wgmma" design, or its one design if it
        takes no design argument (an earlier one's): (o, lse)."""
        b, sq, h, hd = q.shape
        sk, hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
        qp = fa._positions(kw["q_positions"], sq, q.device)
        kp = fa._positions(kw["k_positions"], sk, q.device)
        o = q.new_empty((b, sq, h, hd_v))
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_tile_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, hkv, hd, hd_v, hd ** -0.5, int(kw["causal"]),
            int(kw["window"]), *[0] * lib.takes_design, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {lib.flash_attention_error_string(err).decode()}")
        return o, lse

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    atol, rtol = ATTN_TOL["bfloat16"]
    ok = True
    for name, b, sq, sk, h, hkv, hd, hd_v, causal, window, qpos, kpos in cases():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd_v)))
        kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
        fns = {d: (lambda d=d: fa._launch("tile", q, k, v, *kw.values(), None, with_lse=True,
                                           design=d)) for d in fa.DESIGNS}
        fns.update({label: (lambda lib=lib: other(lib, q, k, v, kw)) for label, lib in others.items()})
        rule = fa.tile_design(q.dtype, hd, hd_v, sq)
        got = {label: fn() for label, fn in fns.items()}
        same = {label: all(torch.equal(x, y) for x, y in zip(got[label], fn()))
                for label, fn in fns.items()}
        torch.cuda.synchronize()
        viol, err, lse_err = (dict.fromkeys(fns, 0) for _ in range(3))
        for i in range(b):
            sl = slice(i, i + 1)
            o_ref, lse_ref = fa.flash_attention_lse_ref(q[sl], k[sl], v[sl], **kw)
            o_ref = o_ref.float()
            for label, (o, lse) in got.items():
                e = (o[sl].float() - o_ref).abs()
                viol[label] += int((e > atol + rtol * o_ref.abs()).sum())
                err[label] = max(err[label], float(e.max()))
                lse_err[label] = max(lse_err[label], float((lse[sl] - lse_ref).abs().max()))
            del o_ref, lse_ref
        row = {"case": name, "shape": [b, sq, sk, h, hkv, hd], "hd_v": hd_v, "causal": causal,
               "window": window, "rule": rule, "violations": viol, "max_abs_err": err,
               "lse_max_abs_err": lse_err, "deterministic": same}
        print(json.dumps(row), flush=True)
        ok &= not any(viol.values()) and all(x <= LSE_ATOL for x in lse_err.values()) \
            and all(same.values())
        del got
        if name in TIMED and not args.check_only:
            vis = fa.visible(qpos, kpos, causal, window)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            arange = sq == sk and torch.equal(qpos, kpos)
            mask = None if (not causal or arange) and not window else vis
            fns["sdpa"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=h != hkv)
            times = {label: [] for label in fns}
            for label in list(fns) + list(fns)[::-1]:
                times[label].append(_time_ms(fns[label], 10))
            runs = {label: [] for label in fns}
            for r in range(args.rounds):
                for label in list(fns)[::(-1) ** r]:
                    runs[label].append(_device_ms(fns[label], 10)[0])
            device = {label: statistics.median(ms) for label, ms in runs.items()}
            ops_ms = 2.0 * (hd + hd_v) * int(vis.sum()) * b * h / H100_BF16_FLOPS * 1e3
            nbytes = (q.numel() + b * sq * h * hd_v + b * int(vis.any(0).sum()) * hkv
                      * (hd + hd_v)) * 2 + 4 * (sq + sk)
            bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
            bound, by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
            print(json.dumps({
                "timed": name, "rule": rule, "ms": device, "runs_ms": runs,
                "host_ms": {k_: min(t) for k_, t in times.items()}, "runs_host_ms": times,
                "bound_ms": bound, "bound_by": by,
                "share_of_bound": {k_: bound / ms for k_, ms in device.items()},
                "tflops": {k_: ops_ms / ms * H100_BF16_FLOPS / 1e12 for k_, ms in device.items()}}),
                flush=True)
        del fns, q, k, v
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if not ok:
        print("attn_fwd_ab: a design disagrees with the plain version or is not deterministic",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
