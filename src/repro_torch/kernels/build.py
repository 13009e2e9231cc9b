"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes`` (plain C entry points; no PyTorch headers, so a build takes
seconds).

Each source compiles for ``sm_90a`` into a shared library in ``_build/``
beside this file (listed in ``.gitignore``), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("twolevel_fft", "toeplitz_conv", "flash_attention", "short_conv", "rmsnorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, nvcc: str):
    out = library_path(name)
    if out.exists():
        return None
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all started together.  Each compiler log (with
    ptxas's register and spill report) is kept as ``_build/<name>.log``.
    Raises with the log of the first source that fails."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        if library_path(name).exists():
            continue
        nvcc = nvcc or nvcc_path()
        running[name] = _start(name, nvcc)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append((name, log))
            continue
        os.replace(tmp, out)
    if failed:
        name, log = failed[0]
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    return {name: library_path(name) for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it if needed)."""
    return ctypes.CDLL(str(build_all((name,))[name]))
