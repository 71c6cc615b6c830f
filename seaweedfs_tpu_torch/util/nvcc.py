"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries with a
plain C interface, for ctypes.

``nvcc`` compiles a source at first use into ``csrc/build/lib<name>-<digest>
.so``, the digest covering the source and the flags, so an edited source is
built anew and an unchanged one never twice. Nothing is built at import: the
modules that load the libraries import where there is no CUDA toolkit.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def source(name: str) -> str:
    """The path of ``csrc/<name>``."""
    return os.path.join(_CSRC, name)


def _nvcc(src: str) -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found (set CUDA_HOME): cannot build {os.path.basename(src)}")


def build(src: str, verbose: bool = False) -> str:
    """Compile ``src`` into ``csrc/build/`` unless a library built from the
    same source and flags is already there. Returns its path; raises if
    ``nvcc`` is missing or the build fails. ``verbose`` prints ptxas's
    registers and spills."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(src), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, lib_path)  # atomic: a concurrent builder sees all or nothing
    return lib_path
