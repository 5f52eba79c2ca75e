"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into one shared library with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a``): no PyTorch headers,
so a build takes seconds. Libraries are named by a hash of their source, the
shared headers (``csrc/*.cuh``) and the flags, written under ``_build/``
beside the package (gitignored), and renamed into place only when complete.
A process-wide lock makes the first use from two threads build once;
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rmsnorm", "rmsnorm_sm90", "flash_attention", "flash_attention_sm90",
           "grouped_matmul", "grouped_matmul_sm90", "ssd_chunk", "ssd_chunk_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory)."""
    return _target(name).with_suffix(".log")


def _build_locked(names) -> dict[str, float]:
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".tmp{os.getpid()}.so")
        log = open(log_path(n), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    tmp, log)
    seconds, failed = {}, []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[n] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, _target(n))
        else:
            failed.append(f"{n} (nvcc exit {rc}):\n{log_path(n).read_text()[-4000:]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, in parallel.

    Returns the wall seconds each build took (empty if all were built).
    """
    with _lock:
        return _build_locked(names)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
