"""Build and load the port's CUDA kernels.

One ``nvcc`` per ``csrc/*.cu`` source, all started together, compiles it
for ``sm_90a`` into an object; one more links the objects into one shared
library with a plain C interface, which ``ctypes`` loads.
The library lives in ``daft_tpu_torch/_build/`` (git-ignored) under a name
that carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one is loaded as it is. The build runs at first use.

Every ``extern "C"`` entry launches on the stream it is given and returns
``cudaGetLastError()`` after its launches (or ``cudaErrorInvalidValue`` for
arguments it does not take); :func:`check` raises on anything but 0.

Nothing here runs at import: the CPU-only test machines import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argtypes of every entry (pointers and the stream as c_void_p, so ctypes
#: never cuts a 64-bit address to a C int)
_ENTRIES = {
    "daft_device_info": [_P],
    "daft_hash_agg_build": [_P, _P, _P],
    "daft_hash_join_build": [_P, _P, _L, _I, _P, _P, _P],
    "daft_hash_join_probe": [_P, _P, _L, _I, _P, _P, _P, _L, _P, _P, _P],
}

_lib = None
_lib_lock = threading.Lock()
#: seconds the first :func:`library` call took (build where needed, load)
build_seconds = 0.0
#: the compiler's output of that build (``-Xptxas -v``: registers, stack
#: frame and spills per kernel); empty when the library was already built
build_log = ""


def sources() -> List[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources():
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libdaft_torch_kernels_{h.hexdigest()[:16]}.so")


def compile_library(srcs: List[str], out: str, extra=()) -> str:
    """Build the shared library ``out`` from ``srcs``: one ``nvcc -c`` per
    source, all running at once, then one link. Returns the compilers'
    output; raises with it when a step fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, *extra, "-c", src,
                               "-o", obj], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
        r = subprocess.run([nvcc(), "-shared", *objs, "-o", f"{tmp}.so"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{tmp}.so", out)
    return "".join(logs) + r.stdout + r.stderr


def library() -> ctypes.CDLL:
    """The kernels' library, built on first call where needed (once: the
    executor's pool threads may ask for it together)."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        # daft-lint: allow(blocking-under-lock) -- build once: every other
        # caller needs the finished library and must wait for it anyway
        path = library_path()
        if not os.path.exists(path):
            # daft-lint: allow(blocking-under-lock) -- the same one build
            build_log = compile_library(sources(), path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _lib = lib
    return _lib


def launch(entry, device, *args) -> int:
    """Call a kernel entry with ``args`` and the current stream of
    ``device``'s card last, making that card current for the call where
    it is not; returns the entry's CUDA error code. Under a profiler
    capture the call is a named range (``observability.kernel_range``)."""
    import torch
    from .. import observability as obs
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with obs.kernel_range(entry.__name__):
        if idx == torch.cuda.current_device():
            return entry(*args, torch.cuda.current_stream(idx).cuda_stream)
        with torch.cuda.device(idx):
            return entry(*args, torch.cuda.current_stream(idx).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code from an entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} (arguments refused or "
                           "launch failed)")
