"""Build the port's native libraries at first use.

Shared libraries bound with ``ctypes`` through a plain C interface:

- ``sampler_lib_path()``: the host C++ sampler (``native/sampler.cpp``, a
  copy of the JAX package's), built with ``g++``;
- ``kernel_lib_path(name)``: one library per CUDA kernel source
  (``csrc/{name}.cu``, with the headers of ``csrc/`` on its include path
  and in its hash), built with ``nvcc`` for ``sm_90a``, so the kernels
  build in parallel. Only a CUDA launch asks for one; ``launch_kernel``
  calls its C entry point ``sptpu_{name}`` (or another of the same
  library, such as ``sptpu_edge_softmax_backward``) on the current
  stream.

All land in ``salient_plusplus_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of their source and command, so an edited source rebuilds
and an unchanged one is reused. A file lock serialises concurrent builds
(test workers build the sampler too) and the library is moved into place
atomically, so no process ever loads a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SAMPLER_SRC = os.path.join(_PKG_DIR, "native", "sampler.cpp")
_CSRC = os.path.join(_PKG_DIR, "csrc")
KERNELS = ("sorted_segment_sum", "gather_rows", "fused_gather_segment_sum",
           "weighted_segment_sum", "weighted_segment_grad", "edge_softmax")
# one lock per library, so the sampler and the kernels build in parallel
_locks = {stem: threading.Lock()
          for stem in ("sptpu", *(f"sptpu_{k}" for k in KERNELS))}
_fns = {}
_fns_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                       "the CUDA kernels are built on first CUDA launch")


def _build(stem: str, srcs, cmd_for) -> str:
    """Return the path of ``lib{stem}-{hash}.so``, building it if absent.

    ``cmd_for(out_path)`` gives the compiler command. The compiler's
    stderr (for nvcc: the ``-Xptxas -v`` resource report) is kept beside
    the library as ``.log``."""
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(cmd_for("OUT")).encode())
    lib = os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")
    with _locks[stem]:
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if os.path.exists(lib):
                    return lib
                tmp = f"{lib}.{os.getpid()}.tmp"
                res = subprocess.run(cmd_for(tmp), capture_output=True,
                                     text=True)
                with open(lib[:-3] + ".log", "w") as f:
                    f.write(res.stdout + res.stderr)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"building {stem} failed (rc {res.returncode}):\n"
                        f"{res.stdout}{res.stderr}")
                os.replace(tmp, lib)
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
    return lib


def sampler_lib_path() -> str:
    return _build("sptpu", (_SAMPLER_SRC,), lambda out: [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", out,
        _SAMPLER_SRC])


def kernel_sources(name: str) -> tuple:
    """``csrc/{name}.cu`` and every header of ``csrc/`` (K1 and K2 share
    ``segment_common.cuh``): all join the library's hash, so an edited
    header rebuilds too."""
    return (os.path.join(_CSRC, f"{name}.cu"),
            *sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))))


def kernel_lib_path(name: str) -> str:
    srcs = kernel_sources(name)
    return _build(f"sptpu_{name}", srcs, lambda out: [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", _CSRC, "-o", out, srcs[0]])


def launch_kernel(name: str, argtypes, device: torch.device, *args,
                  entry: str = None) -> None:
    """Call ``sptpu_{entry}(*args, stream)`` of ``csrc/{name}.cu`` on
    ``device``'s current stream (``entry`` defaults to ``name``).
    ``argtypes`` types ``args`` (pointers as ``c_void_p``); the C function
    returns ``cudaGetLastError()`` after its launch, and anything but 0
    raises."""
    entry = entry or name
    with _fns_lock:
        fn = _fns.get(entry)
        if fn is None:
            fn = getattr(ctypes.CDLL(kernel_lib_path(name)), f"sptpu_{entry}")
            fn.restype = ctypes.c_int
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            _fns[entry] = fn
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")


def build_log(lib_path: str) -> str:
    """The compiler output kept beside a built library."""
    with open(lib_path[:-3] + ".log") as f:
        return f.read()
