"""Build the port's CUDA sources and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into
``paddle_tpu_torch/_build/lib<name>-<hash>.so`` the first time a kernel of
it is needed, and is loaded with ``ctypes``. The sources expose plain C
entry points (pointers, ints and the stream), so no PyTorch header is
compiled and a build takes seconds. The hash covers the source, the
shared headers and the flags, so an edited source builds anew. ``nvcc``'s
output (with ``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``<name>.log``.

Only sources in this package are built, and a failed build raises: there
is no fallback to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "build_log", "CSRC", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs = {}
_lock = threading.Lock()


def _nvcc():
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _paths(name):
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no CUDA source {src}")
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    return src, so, BUILD_DIR / f"{name}.log"


def build(*names):
    """Compile the named sources, all nvcc processes started together,
    and wait for them. Sources already built are skipped. Returns
    {name: path of the shared library}."""
    jobs, out = [], {}
    for name in names:
        src, so, log = _paths(name)
        out[name] = so
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(src)], stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, so, log))
    failed = []
    for name, proc, tmp, so, log in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log.read_text()[-4000:]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def build_log(name):
    """nvcc's output from the last build of ``name`` ('' if none)."""
    log = _paths(name)[2]
    return log.read_text() if log.exists() else ""


def load(name, signatures):
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C entry point to its ctypes argtypes; every
    entry returns an int (the CUDA error code, 0 on success)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = build(name)[name]
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
