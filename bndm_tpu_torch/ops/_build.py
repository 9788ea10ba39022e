"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

Every ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by a
hash of its source, every ``csrc/*.cuh`` header and the flags, and kept in
``bndm_tpu_torch/_build/``. A build
happens at first CUDA use, never at import: the CPU tests import every module
on a host without nvcc. ``build_all`` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def sources():
    """Names of the kernels in ``csrc/`` (file stems)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name):
    """Where ``csrc/<name>.cu`` is built: a change to it, to any header in
    ``csrc/`` (a source may include any of them) or to the flags names
    another library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name):
    """Start nvcc for one source into a temporary file; None if up to date."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name, job):
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names=None):
    """Build every kernel (or ``names``) in parallel; returns their paths."""
    names = sources() if names is None else list(names)
    jobs = {name: _start(name) for name in names}
    try:
        for name in list(jobs):
            job = jobs.pop(name)  # _finish cleans up after itself, even if it raises
            if job is not None:
                _finish(name, job)
    finally:
        for job in jobs.values():  # stop what is left after a failure
            if job is not None:
                job[0].kill()
                job[0].wait()
                os.unlink(job[1])
    return {name: lib_path(name) for name in names}


@functools.cache
def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built first if needed."""
    path = build_all([name])[name]
    return ctypes.CDLL(path)
