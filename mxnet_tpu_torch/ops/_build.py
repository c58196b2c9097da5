"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/mxnet_tpu_torch/lib<name>-<hash>.so

into ``build/mxnet_tpu_torch/`` at the root of the checkout (git-ignored)
and loaded with ``ctypes``; nvcc's output, with ptxas's registers, stack
and spill bytes for every kernel, is kept beside it as
``lib<name>-<hash>.log`` (:func:`log_path`).  The file name carries a
hash of the sources, so an edited kernel is never served from a stale
library.  Pointers and the stream
(``torch.cuda.current_stream().cuda_stream``) are passed as
``c_void_p``; every C entry returns ``cudaGetLastError()`` after its
launch and :func:`check` raises on a non-zero code.  A failed build
raises.  No fallback exists: a CUDA tensor either runs the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "check", "log_path"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "mxnet_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}            # name -> ctypes.CDLL with argtypes set


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise MXNetError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                     "port's CUDA kernels cannot be built on this host")


def _target(name):
    """Library path for ``name``: keyed by the bytes of its source and
    of every shared header, so any edit rebuilds."""
    h = hashlib.sha256()
    for fn in sorted(os.listdir(_CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(_CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def log_path(name):
    """nvcc's output (ptxas's per-kernel lines) for the built ``name``."""
    return _target(name)[:-len(".so")] + ".log"


def build(names):
    """Compile every library in ``names`` that is not built yet, with one
    ``nvcc`` per source, all started together.  Returns the paths."""
    targets = {n: _target(n) for n in names}
    todo = [n for n, t in targets.items() if not os.path.exists(t)]
    if todo:
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        target = targets[name]
        src = os.path.join(_CSRC, f"{name}.cu")
        if not os.path.exists(src):
            raise MXNetError(f"no CUDA source {src}")
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        with open(log_path(name), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, target)
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name, signatures):
    """The loaded library ``name`` (built on first use), with
    ``argtypes``/``restype`` set from ``signatures``:
    ``{function: [ctypes types]}``; every function returns ``c_int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.mxt_error_string.argtypes = [ctypes.c_int]
            lib.mxt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib, err, what):
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = lib.mxt_error_string(err).decode()
        raise MXNetError(f"{what}: CUDA error {err} ({msg})")
