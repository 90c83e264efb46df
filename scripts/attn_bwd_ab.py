#!/usr/bin/env python3
"""Time builds of ``flash_attention_bwd.cu`` against each other on one GPU, in turns.

    python scripts/attn_bwd_ab.py                       # parent against the tree
    python scripts/attn_bwd_ab.py old=path/a.cu new=path/b.cu ...
    python scripts/attn_bwd_ab.py --check-only          # build and check, no timing

Each ``label=path`` is a source with the launcher of
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
(``flash_attention_bwd_launch``); it is compiled with the headers beside it
(``attention_tiles.cuh``).  The default compares ``parent`` (an earlier
commit's source, unpacked with ``git archive <commit> src | tar -x -C
build/parent``) with ``tree`` (the checkout's).  Every source is built with
``nvcc`` and the flags of ``kernels/_build.py`` into ``build/attn_bwd_ab/``,
all at once; ptxas's register and spill lines are printed.  A source whose
launcher takes no hd_v (an earlier one's) gets V, O and dO zero-padded to hd,
as its layer padded them, and its dv is sliced back.  Each build is checked
against ``flash_attention_bwd_ref`` on ``chip_smoke.py``'s backward cases
(each gradient within ``BWD_TOL`` of its largest entry; two calls equal bit
for bit), then timed at ``train_microbatch`` (B 4, S 4096, H 24, Hkv 2, hd
128) and ``mla_train`` (B 1, S 4096, H 16, hd 192, hd_v 128), causal: CUDA
events around 10 calls in turns (first to last, then last to first;
``host_ms`` the lower), and the kernels' time in a ``torch.profiler`` trace
(``ms``), beside SDPA's backward (a yardstick the port never calls; at MLA's
shape at Ev 192 on a zero-padded V and at Ev 128) and the five- and
seven-product bounds.  Prints one JSON line per case and per build, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]


def build(label: str, src: pathlib.Path) -> tuple[str, pathlib.Path | None, list[str], str]:
    from repro_torch.kernels import _build

    flags = [*_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src.parent)]
    text = src.read_bytes() + b"".join(p.read_bytes() for p in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    out = ROOT / "build" / "attn_bwd_ab" / f"lib{label}-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *flags, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = [ln.strip() for ln in proc.stdout.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln or "warning" in ln
             or "C75" in ln]
    return label, (out if proc.returncode == 0 else None), ptxas, proc.stdout


def bind(path: pathlib.Path, takes_hd_v: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.takes_hd_v = takes_hd_v
    p, i = ctypes.c_void_p, ctypes.c_int
    n = 7 if takes_hd_v else 6  # b sq sk h hkv hd [hd_v]
    lib.flash_attention_bwd_launch.argtypes = [p] * 12 + [i] * n + [ctypes.c_float, i, i, p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [i]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "flash_attention_bwd_scratch_bytes"):
        lib.flash_attention_bwd_scratch_bytes.argtypes = [i] * (n - 1)
        lib.flash_attention_bwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def kernel_ms(fn, iters: int) -> dict[str, float]:
    """Device ms per call of ``fn`` by kernel (``attn_bwd_dkdv_wgmma_kernel<192, 128>``),
    from one ``torch.profiler`` trace of ``iters`` calls."""
    import torch
    from chip_smoke import _traced

    fn()
    torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in _traced(lambda: [fn() for _ in range(iters)])[1]:
        if e["cat"] == "kernel":
            m = re.search(r"attn_bwd_\w+_kernel(<[\d, ]+>)?", e["name"])
            name = m.group(0) if m else e["name"][:60]
            out[name] = out.get(name, 0.0) + e["dur"] / iters / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("builds", nargs="*", help="label=path of a flash_attention_bwd.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true", help="build and check; no timing")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attn_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (BWD_TOL, _device_ms, _time_ms, attention_bwd_bound_ms,
                            backward_cases, sdpa_backward)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    csrc = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    specs = args.builds or [f"parent={ROOT / 'build/parent' / csrc}", f"tree={ROOT / csrc}"]
    pairs = [s.split("=", 1) for s in specs]
    with ThreadPoolExecutor(len(pairs) + 1) as pool:  # one nvcc each, all at once
        forward = pool.submit(fa._lib)  # the forward kernels, which give o and lse
        built = list(pool.map(lambda p: build(p[0], pathlib.Path(p[1])), pairs))
        forward.result()
    libs = {}
    for label, path, ptxas, log in built:
        for line in ptxas:
            print(f"ptxas {label}: {line}", flush=True)
        if path is None:
            print(f"build of {label} failed:\n{log}", flush=True)
            return 1
        source = pathlib.Path(dict(pairs)[label]).read_text()
        takes_hd_v = re.search(r"flash_attention_bwd_launch\([^)]*\bhd_v\b", source)
        libs[label] = bind(path, takes_hd_v is not None)

    def launch(lib, q, k, v, o, do, lse, kw):
        b, sq, h, hd = q.shape
        sk, hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
        widths = (hd, hd_v)
        if not lib.takes_hd_v:  # an earlier launcher: V, O and dO zero-padded to hd
            v, o, do = (F.pad(t, (0, hd - hd_v)) for t in (v, o, do))
            widths = (hd,)
        qp = fa._positions(kw["q_positions"], sq, q.device)
        kp = fa._positions(kw["k_positions"], sk, q.device)
        n = (lib.flash_attention_bwd_scratch_bytes(b, sq, sk, h, *widths)
             if hasattr(lib, "flash_attention_bwd_scratch_bytes") else 4 * b * h * sq)
        scratch = torch.empty(n, dtype=torch.uint8, device=q.device)
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), qp.data_ptr(), kp.data_ptr(), *(g.data_ptr() for g in grads),
            scratch.data_ptr(), b, sq, sk, h, hkv, *widths, hd ** -0.5, int(kw["causal"]),
            int(kw["window"]), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {lib.flash_attention_bwd_error_string(err).decode()}")
        return grads[0], grads[1], grads[2][..., :hd_v]

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ok = True
    for name, b, sq, sk, h, hkv, hd, hd_v, causal, window, qpos, kpos in backward_cases():
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                       for shape in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd_v),
                                     (b, sq, h, hd_v)))
        kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
        o, lse = fa.flash_attention_lse(q, k, v, **kw)
        got = {label: launch(lib, q, k, v, o, do, lse, kw) for label, lib in libs.items()}
        again = {label: launch(lib, q, k, v, o, do, lse, kw) for label, lib in libs.items()}
        torch.cuda.synchronize()
        rel = dict.fromkeys(libs, 0.0)
        for i in range(b):  # the plain version one batch element at a time
            sl = slice(i, i + 1)
            ref = fab.flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], **kw)
            for label, grads in got.items():
                for g, r in zip(grads, ref):
                    e = float((g[sl].float() - r.float()).abs().max())
                    rel[label] = max(rel[label], e / float(r.float().abs().max()))
            del ref
        same = {label: all(torch.equal(x, y) for x, y in zip(got[label], again[label]))
                for label in libs}
        row = {"case": name, "shape": [b, sq, sk, h, hkv, hd], "hd_v": hd_v, "causal": causal,
               "window": window, "max_rel_err": rel, "deterministic": same, "tol": BWD_TOL}
        print(json.dumps(row), flush=True)
        ok &= all(r <= BWD_TOL for r in rel.values()) and all(same.values())
        if name in ("train_microbatch", "mla_train") and not args.check_only:
            vis = fa.visible(qpos, kpos, causal, window)
            bound, by = attention_bwd_bound_ms(q, k, v, vis)
            fns = {label: (lambda lib=lib: launch(lib, q, k, v, o, do, lse, kw))
                   for label, lib in libs.items()}
            pad = (0, hd - hd_v)
            fns["sdpa_backward"], backend = sdpa_backward(q, k, F.pad(v, pad), F.pad(do, pad))
            backends = {"sdpa_backward": backend}
            if hd_v != hd:
                fns["sdpa_backward_native"], backends["sdpa_backward_native"] = \
                    sdpa_backward(q, k, v, do)
            times = {label: [] for label in fns}
            for label in list(fns) + list(fns)[::-1]:
                times[label].append(_time_ms(fns[label], 10))
            device = {label: _device_ms(fn, 10)[0] for label, fn in fns.items()}
            by_kernel = {label: kernel_ms(fn, 10) for label, fn in fns.items() if label in libs}
            print(json.dumps({
                "timed": name, "sdpa_backends": backends, "ms": device,
                "host_ms": {k_: min(t) for k_, t in times.items()},
                "runs_host_ms": times, "bound_ms_5_products": bound, "bound_by": by,
                "bound_ms_7_products": bound * 7 / 5 if by == "operations" else bound,
                "x_bound_5": {k_: ms / bound for k_, ms in device.items()},
                "kernel_ms": by_kernel}), flush=True)
            del fns
        del q, k, v, do, o, lse, got, again
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if not ok:
        print("attn_bwd_ab: a build disagrees with the plain version or is not deterministic",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
