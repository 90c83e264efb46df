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


MARKS = "trace_mark"  # the spans' device marks (repro_torch/trace.py)


def _start(name: str):
    """Start ``nvcc`` on kernel ``name`` unless its library is built: the
    library's path, the build's temporary file and the process, or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    # -Xptxas -v: each kernel's registers, spills and shared memory, kept beside the library
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)


def _finish(name: str, build) -> None:
    """Wait for :func:`_start`'s build of ``name``; raise if it failed."""
    if build is None:
        return
    out, tmp, proc = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited {proc.returncode}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def load(name: str) -> ctypes.CDLL:
    """Load kernel ``name``'s shared library, compiling it first if needed.

    A kernel built here has the marks' library (:data:`MARKS`) built beside
    it, at the same time, if it is not yet: so a traced window never waits on
    ``nvcc`` for a mark, and a process that tracing never turns on does not
    load it.  A failed build of the marks is left for their own load to
    report; the kernel asked for does not depend on it."""
    build = _start(name)
    marks = _start(MARKS) if build is not None and name != MARKS else None
    try:
        _finish(name, build)
    finally:
        if marks is not None:
            try:
                _finish(MARKS, marks)
            except RuntimeError:
                pass  # trace.mark_library() builds again and raises with the log
    return ctypes.CDLL(str(library_path(name)))


def ptxas_report(name: str) -> list[str]:
    """The ptxas lines of kernel ``name``'s last build (registers, spills,
    shared memory per kernel); empty if it was not built here."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
