"""Builds the port's CUDA kernels from `saena_tpu_torch/csrc/` and loads them.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
with nvcc into `_build/lib<name>-<digest>.so`, where the digest covers the
source, every header under `csrc/` (`*.cuh`, which the sources share) and
the flags, so an edited source or header is rebuilt and an unchanged one is
reused. The library is loaded with ctypes; nothing includes PyTorch's
headers, which keeps a build at seconds. Several sources build in parallel,
one nvcc process each. A build happens at first use, never at import, and a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNEL_SOURCES = ("dia_spmv", "strip_spmv", "strip8_spmv", "ell_spmv", "csr_spgemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()
# the seconds ``load`` has spent compiling, summed over the process
build_s = 0.0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are built "
        "from source on the machine that has the card")


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=KERNEL_SOURCES) -> dict:
    """Compile every named source that has no current library, all nvcc
    processes started together. Returns {name: (seconds, compiler log)};
    a source that was already built reports (0.0, "")."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out = {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            out[name] = (0.0, "")
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        out[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    global build_s
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_s += build((name,))[name][0]
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib
