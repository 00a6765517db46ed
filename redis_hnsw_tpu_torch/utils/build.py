"""Build native libraries from the sources in the repository, at first use.

Two kinds of library are built into ``build/`` at the repository root
(a directory ``.gitignore`` lists, so a fresh checkout builds them):

* ``build/native/libhnswcore-<hash>.so`` -- the host graph core,
  ``redis_hnsw_tpu_torch/csrc/hnsw_core.cpp`` compiled with g++;
* ``build/kernels/lib<name>-<hash>.so`` -- each CUDA kernel source under
  ``redis_hnsw_tpu_torch/csrc/`` compiled by nvcc for ``sm_90a`` into a
  shared library with a plain C interface, loaded with ctypes.

The file name carries a hash of the sources, headers and command, so an
edited source never loads a stale library. Several processes (pytest-xdist
workers) may build at once: each build holds a file lock, compiles to a
temporary name and ``os.replace``-s it into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")
)
BUILD_DIR = os.path.join(REPO_ROOT, "build")
CSRC_DIR = os.path.join(REPO_ROOT, "redis_hnsw_tpu_torch", "csrc")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _target(subdir: str, stem: str, inputs: list[str], cmd: list[str]):
    h = hashlib.sha256(" ".join(cmd).encode())
    for path in inputs:
        with open(path, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, subdir)
    return out_dir, os.path.join(out_dir, f"{stem}-{h.hexdigest()[:12]}.so")


def start_build(subdir, stem, sources, headers, cmd):
    """Start compiling ``sources`` into ``build/<subdir>`` unless the
    library is already there. ``cmd(out)`` gives the compiler command
    writing to ``out``. Returns ``(path, finish)``: ``finish()`` waits
    for the compiler, installs the library and returns its path. The
    lock is held from start to finish, so a second process building the
    same library waits and then finds it built."""
    out_dir, path = _target(subdir, stem, sources + headers, cmd("OUT"))
    os.makedirs(out_dir, exist_ok=True)
    lock = open(path + ".lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    if os.path.exists(path):
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()
        return path, lambda: path
    tmp = f"{path}.{os.getpid()}.tmp"
    log_path = path[:-3] + ".log"
    log = open(log_path, "w")
    try:
        proc = subprocess.Popen(
            cmd(tmp), stdout=log, stderr=subprocess.STDOUT, cwd=REPO_ROOT
        )
    except OSError:
        log.close()
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()
        raise

    def finish():
        try:
            rc = proc.wait()
            log.close()
            if rc != 0:
                with open(log_path) as f:
                    raise RuntimeError(
                        f"building {stem} failed (exit {rc}):\n{f.read()}"
                    )
            os.replace(tmp, path)
            return path
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
            fcntl.flock(lock, fcntl.LOCK_UN)
            lock.close()

    return path, finish


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); CUDA kernels are built at "
            "first use on a machine with the CUDA toolkit"
        )
    return found


def start_kernel_build(name: str):
    """Start nvcc on ``csrc/<name>.cu`` (see :func:`start_build`)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")
    )
    nvcc = nvcc_path()
    return start_build(
        "kernels", f"lib{name}", [src], headers,
        lambda out: [nvcc, *NVCC_FLAGS, "-o", out, src],
    )


KERNELS = ("scan_topk", "scan_lowp", "scan_int8", "scan_bf16",
           "count_gt_eq", "count_hamming", "block_score", "select_bins")

_loaded: dict = {}
_load_lock = threading.Lock()


def build_kernels() -> dict:
    """Build every CUDA kernel, one nvcc per source, all started
    together; returns {name: library path}."""
    started = [(name, start_kernel_build(name)[1]) for name in KERNELS]
    return {name: finish() for name, finish in started}


def load_kernel(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built at first use
    (cached for the process)."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(start_kernel_build(name)[1]())
            _loaded[name] = lib
        return lib


def build_log(path: str) -> str:
    """The compiler's output of a library built here ('' if it was
    already built by another process); ptxas register and shared-memory
    figures for the kernels."""
    log_path = path[:-3] + ".log"
    if not os.path.exists(log_path):
        return ""
    with open(log_path) as f:
        return f.read()
