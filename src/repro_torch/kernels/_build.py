"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled for Hopper (``sm_90a``) into ``build/repro_torch/lib<name>-<hash>.so``
at the repository root (a directory git ignores) the first time it is
needed.  The hash covers the source, the headers beside it (``csrc/*.cuh``)
and the flags, so an edited kernel or header is rebuilt and a stale library
is never loaded.  No PyTorch headers are
involved, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = b"".join(path.read_bytes()
                   for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Load kernel ``name``'s shared library, compiling it first if needed."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        # -Xptxas -v: each kernel's registers, spills and shared memory, kept beside the library
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"kernel build failed: {name}: nvcc exited {proc.returncode}\n{proc.stdout}")
        out.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return ctypes.CDLL(str(out))


def ptxas_report(name: str) -> list[str]:
    """The ptxas lines of kernel ``name``'s last build (registers, spills,
    shared memory per kernel); empty if it was not built here."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
