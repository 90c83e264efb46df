#!/usr/bin/env python3
"""Time builds of ``gf_matmul.cu`` against each other on one GPU, in turns.

    python scripts/gf_ab.py                          # parent against the tree
    python scripts/gf_ab.py old=path/a.cu new=path/b.cu ...
    python scripts/gf_ab.py --sass ILi6ELi16E        # loop instruction mix, no timing

Each ``label=path`` is a source with the launcher of
``src/repro_torch/kernels/csrc/gf_matmul.cu`` (``gf_matmul_launch``).  The
default compares ``parent`` (an earlier commit's source, unpacked with
``git archive <commit> src | tar -x -C build/parent``) with ``tree`` (the
checkout's).  Every source is built with ``nvcc`` and the flags of
``kernels/_build.py`` into ``build/gf_ab/``, all at once; ptxas's register and
spill lines are printed.  At each shape, every build's output must equal the
plain PyTorch version byte for byte; then the builds are timed with CUDA
events in turns (first to last, then last to first), each getting the
lower of its two times (``ms``: host launch time included), and by the
kernel time in a ``torch.profiler`` trace (``device_ms``).  Shapes are the
ones ``chip_smoke.py`` times (``chip_smoke.gf_shapes`` for a 1 GiB blob):
Clay (10,6) at M 6, K 12 (one chunkset's encode, a ragged N, decode plane
groups of 6, 48, 60 and 102 planes, the put's encode, a decode of 5 planes
with N = 8 mod 16) and the serving path's Clay (4,2) encode (M 2, K 4).  Prints one JSON line per shape and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]


def build(label: str, src: pathlib.Path) -> tuple[str, pathlib.Path, list[str]]:
    from repro_torch.kernels import _build

    flags = [*_build.NVCC_FLAGS, "-Xptxas", "-v"]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = ROOT / "build" / "gf_ab" / f"lib{label}-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *flags, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f"build of {label} ({src}) failed:\n{proc.stdout}")
    ptxas = [ln.strip() for ln in proc.stdout.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    return label, out, ptxas


def loop_mix(lib: pathlib.Path, name: str) -> list[dict]:
    """Opcode counts of every loop (a backward branch and what it spans) of
    length 64 or more in the kernels of ``lib`` whose mangled name holds
    ``name``, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build

    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs: dict[str, list[tuple[int, str, str]]] = {}
    func = None
    for line in sass.splitlines():
        if (m := re.search(r"Function : (\S+)", line)):
            func = m.group(1) if name in m.group(1) else None
            if func:
                funcs[func] = []
        elif func and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
                                      line)):
            funcs[func].append((int(m.group(1), 16), m.group(2).split(".")[0], m.group(3)))
    rows = []
    for func, ins in funcs.items():
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target and int(target.group(1), 16) <= addr:
                body = collections.Counter(o for a, o, _ in ins
                                           if int(target.group(1), 16) <= a <= addr)
                if sum(body.values()) >= 64:
                    rows.append({"kernel": func, "loop": [int(target.group(1), 16), addr],
                                 "instructions": sum(body.values()), "ops": dict(body.most_common())})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("builds", nargs="*", help="label=path of a gf_matmul.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", metavar="NAME", help="print the instruction mix of each loop of "
                    "the kernels whose mangled name holds NAME (e.g. ILi6ELi16E) and stop")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gf_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _device_ms, _time_ms, gf_bound_ms, gf_shapes
    from repro_torch.kernels import gf_matmul as gk

    specs = args.builds or [
        f"parent={ROOT / 'build/parent/src/repro_torch/kernels/csrc/gf_matmul.cu'}",
        f"tree={ROOT / 'src/repro_torch/kernels/csrc/gf_matmul.cu'}"]
    pairs = [s.split("=", 1) for s in specs]
    with ThreadPoolExecutor(len(pairs)) as pool:  # one nvcc each, all at once
        built = list(pool.map(lambda p: build(p[0], pathlib.Path(p[1])), pairs))
    import ctypes

    libs = {}
    for label, path, ptxas in built:
        for line in ptxas:
            print(f"ptxas {label}: {line}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.gf_matmul_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.gf_matmul_launch.restype = ctypes.c_int
        libs[label] = lib
    if args.sass:
        for label, path, _ in built:
            for row in loop_mix(path, args.sass):
                print(json.dumps({"build": label, **row}), flush=True)
        return 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def run(lib, a, b, c):
        err = lib.gf_matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), a.shape[0],
                                   a.shape[1], b.shape[1], sms,
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed with cudaError {err}")

    for name, (m, k, n) in gf_shapes(1024).items():
        a = torch.randint(0, 256, (m, k), dtype=torch.uint8, device="cuda", generator=gen)
        b = torch.randint(0, 256, (k, n), dtype=torch.uint8, device="cuda", generator=gen)
        ref = gk.gf_matmul_ref(a, b)
        c = torch.empty_like(ref)
        for label, lib in libs.items():
            c.fill_(0)
            run(lib, a, b, c)
            torch.cuda.synchronize()
            if not torch.equal(c, ref):
                raise SystemExit(f"{label} disagrees with the plain version at {name}")
        del ref
        iters = 10 if n > 10**7 else 50
        times = {label: [] for label in libs}
        order = list(libs) + list(libs)[::-1]
        for label in order:
            times[label].append(_time_ms(lambda: run(libs[label], a, b, c), iters))
        device = {label: _device_ms(lambda: run(libs[label], a, b, c), iters)[0]
                  for label in libs}
        bound = gf_bound_ms(m, k, n)[0]
        row = {"shape": name, "m": m, "k": k, "n": n, "n_mod_16": n % 16, "bound_ms": bound,
               "ms": {label: min(t) for label, t in times.items()}, "runs_ms": times,
               "device_ms": device}
        row["x_bound"] = {label: ms / bound for label, ms in row["ms"].items()}
        first = next(iter(libs))
        row[f"speedup_over_{first}"] = {label: row["ms"][first] / ms
                                        for label, ms in row["ms"].items()}
        print(json.dumps(row), flush=True)
        del a, b, c
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
