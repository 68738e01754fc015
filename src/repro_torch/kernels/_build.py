"""Builds the package's CUDA sources into shared libraries and loads them.

No counterpart in ``src/repro/`` (Pallas kernels are compiled by JAX).  Each
``csrc/<name>.cu`` becomes ``build/lib<name>_<hash>.so`` at the repository
root: ``nvcc`` for ``sm_90a`` with a plain C interface, loaded with
``ctypes``.  The hash covers every file under ``csrc/`` and the flags, so an
edited source is rebuilt and a stale library is never loaded.  The build runs
at first use, never at import, and a failed build raises: there is no other
implementation to give way to on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch cannot be built without it")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:12]


def _target(name: str) -> Path:
    return build_dir() / f"lib{name}_{_digest()}.so"


def _compile(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out = _target(name)
    if out.exists():
        return out
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(_compile(name)))
    return lib
