"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc -shared`` for ``sm_90a``
(Hopper) at first use, into ``build/torch_kernels/`` at the repository
root.  The file name carries a digest of the source and the flags, so an
edited source never loads a stale library.  A build writes a temporary
name and renames it into place, so two processes building at once cannot
load a half-written file.  A failed build raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built with it")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``'s library."""
    return library_path(name).with_suffix(".log").read_text()


def build_libraries(names: Sequence[str]) -> Dict[str, Path]:
    """Build every named source that has no current library, one
    ``nvcc`` per source, all started together; returns the paths."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f".{p.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        todo[n].with_suffix(".log").write_text(log)
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build_libraries([name])[name]))
