#!/usr/bin/env python3
"""Where a tile of the forward's "wgmma" design spends its cycles, on one GPU.

    python scripts/attn_fwd_clocks.py

Writes ``build/attn_fwd_clocks/clocks.cu``, a copy of
``src/repro_torch/kernels/csrc/flash_attention.cu`` whose consumer
warpgroups read ``clock64()`` around each phase of their loop and add the
totals of thread 0 of each warpgroup into the (otherwise unwritten) lse
buffer; builds it with the flags of ``kernels/_build.py``; runs it once
warm and once counted at the training microbatch (B 4, S 4096, H 24, Hkv 2,
hd 128) and hymba's step (B 1, S 4096, H 25, Hkv 5, hd 64), causal.  Prints,
per consumer warpgroup, the cycles a block spends before Q has landed and
in its epilogue, and per computed tile: waiting for K, from issuing S = Q
K^T (and the previous tile's P V) until S is done, the softmax, waiting for
the previous P V, and the rest of the iteration; then the card's name and
power limit.  The reads of the clock move the code (ptxas may serialize the
wgmma of the copy), so the copy runs slower than the kernel: its split is
indicative, the kernel's own time is ``scripts/attn_fwd_ab.py``'s.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
OUT = ROOT / "build/attn_fwd_clocks"
PHASES = ("prologue", "wait_k", "s", "softmax", "pv_wait", "rest", "epilogue", "total", "tiles",
          "blocks")

TAIL = ("            *reinterpret_cast<__nv_bfloat162*>(orow + d) = "
        "__floats2bfloat162_rn(x0, x1);\n          }\n        }\n      }\n    }\n")
# (text of the source, what replaces it); each occurs once in the source
PATCHES = [
    ("    setmaxnreg_inc<kConsumerRegs>();\n",
     "    setmaxnreg_inc<kConsumerRegs>();\n    const long long t_start = clock64();\n"
     "    long long c_pro = 0, c_k = 0, c_s = 0, c_soft = 0, c_pv = 0, c_rest = 0, n_tiles = 0;\n"),
    ("    mbar_wait(base + L::q_bar, 0);\n",
     "    mbar_wait(base + L::q_bar, 0);\n    c_pro = clock64() - t_start;\n"),
    ("      mbar_wait(base + L::full_k + 8 * stage, phase);\n",
     "      const long long t_a = clock64();\n"
     "      mbar_wait(base + L::full_k + 8 * stage, phase);\n"
     "      c_k += clock64() - t_a;\n      const long long t_b = clock64();\n"),
    ("      fence_regs(s);\n",
     "      fence_regs(s);\n      c_s += clock64() - t_b;\n      const long long t_c = clock64();\n"),
    ("      release(L::empty_k, stage);  // K and the positions are read\n",
     "      release(L::empty_k, stage);  // K and the positions are read\n"
     "      c_soft += clock64() - t_c;\n      const long long t_d = clock64();\n"),
    ("        release(L::empty_v, pend);\n      }\n#pragma unroll\n",
     "        release(L::empty_v, pend);\n      }\n      c_pv += clock64() - t_d;\n#pragma unroll\n"),
    ("      pend = stage;\n", "      pend = stage;\n      c_rest += clock64() - t_d;\n      ++n_tiles;\n"),
    ("    if (has_rows) {  // the epilogue",
     "    const long long t_e = clock64();\n    if (has_rows) {  // the epilogue"),
    ("        if (lse != nullptr && tig == 0)  // the quad shares",  # the lse is left unwritten
     "        if (false)  // the quad shares"),
    (TAIL, TAIL + (  # thread 0 of each warpgroup adds its totals into the lse buffer
        "    if (tid == 0 && lse != nullptr) {\n"
        "      unsigned long long* sums = reinterpret_cast<unsigned long long*>(lse) + wg * 10;\n"
        "      const long long v[10] = {c_pro, c_k, c_s, c_soft, c_pv, c_rest - c_pv,\n"
        "                               clock64() - t_e, clock64() - t_start, n_tiles, 1};\n"
        "      for (int i = 0; i < 10; ++i) atomicAdd(sums + i, static_cast<unsigned long long>(v[i]));\n"
        "    }\n")),
]


def instrumented(text: str) -> str:
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"attn_fwd_clocks: the source no longer has one {old.strip()!r}")
        text = text.replace(old, new)
    return text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_fwd_clocks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "clocks.cu"
    src.write_text(instrumented(SOURCE.read_text()))
    lib_path = OUT / "libclocks.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                           str(SOURCE.parent), "-o", str(lib_path), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout.splitlines():
        if "attn_fwd_wgmma" in line or "C7520" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    if proc.returncode:
        print(proc.stdout, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_tile_launch.argtypes = [p] * 7 + [i] * 7 + [ctypes.c_float, i, i, i, p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, h, hkv, hd in [(4, 4096, 24, 2, 128), (1, 4096, 25, 5, 64)]:
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
        pos = torch.arange(s, dtype=torch.int32, device="cuda")
        o = torch.empty_like(q)
        sums = torch.zeros((b, h, s), device="cuda")  # the lse buffer
        for _ in range(2):  # warm, then counted
            sums.zero_()
            err = lib.flash_attention_tile_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), pos.data_ptr(),
                o.data_ptr(), sums.data_ptr(), b, s, s, h, hkv, hd, hd, hd ** -0.5, 1, 0, 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"attn_fwd_clocks: launch failed ({err})")
        torch.cuda.synchronize()
        vals = sums.view(torch.int64).flatten()[:20].tolist()
        for wg in range(2):
            d = dict(zip(PHASES, vals[10 * wg:10 * wg + 10]))
            per_block = {n: d[n] / d["blocks"] for n in ("prologue", "epilogue", "total")}
            per_tile = {n: d[n] / max(d["tiles"], 1) for n in PHASES[1:6]}
            print(f"shape {(b, s, h, hkv, hd)} warpgroup {wg}: {d['blocks']} blocks, {d['tiles']} "
                  f"tiles; cycles a block {per_block}; a tile {per_tile}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
